"""Independent DICOM encoders: the files a test or a fuzz campaign feeds the
port's reader (``csrc/dicom.cc``).

Part 10 byte streams written by hand (explicit and implicit VR little
endian, deflated, encapsulated), and frames for every codec the reader
decodes: RLE Lossless (PackBits planes), JPEG Lossless (process 14),
JPEG-LS (T.87, LOCO-I), JPEG sequential DCT (baseline and extended), each
written from the public spec in Python, and JPEG 2000 through Pillow's
OpenJPEG codec.  They are the JAX package's test fixtures
(``tests/test_dicom_native.py``), copied so that the port imports nothing
of its tests.
"""

from __future__ import annotations

import struct

import numpy as np


def _el_explicit(group, elem, vr, value: bytes) -> bytes:
    if len(value) % 2:
        value += b"\x00" if vr in (b"OB", b"UI") else b" "
    head = struct.pack("<HH", group, elem) + vr
    if vr in (b"OB", b"OW", b"OF", b"SQ", b"UT", b"UN"):
        return head + b"\x00\x00" + struct.pack("<I", len(value)) + value
    return head + struct.pack("<H", len(value)) + value


def _el_implicit(group, elem, value: bytes) -> bytes:
    if len(value) % 2:
        value += b" "
    return struct.pack("<HHI", group, elem, len(value)) + value


def write_dicom(path, rows, cols, bits_stored, pixels: np.ndarray,
                 explicit=True, patient_id=b"PAT123", age=b"042Y",
                 laterality=b"R", preamble=True):
    out = b"\x00" * 128 + b"DICM" if preamble else b""
    # minimal file meta (always explicit VR)
    out += _el_explicit(0x0002, 0x0010, b"UI", b"1.2.840.10008.1.2.1")
    el = _el_explicit if explicit else _el_implicit
    mk = (lambda g, e, vr, v: el(g, e, vr, v)) if explicit else (
        lambda g, e, vr, v: el(g, e, v)
    )
    out += mk(0x0010, 0x0020, b"LO", patient_id)
    out += mk(0x0010, 0x1010, b"AS", age)
    out += mk(0x0020, 0x0062, b"CS", laterality)
    out += mk(0x0028, 0x0010, b"US", struct.pack("<H", rows))
    out += mk(0x0028, 0x0011, b"US", struct.pack("<H", cols))
    out += mk(0x0028, 0x0100, b"US", struct.pack("<H", 16))
    out += mk(0x0028, 0x0101, b"US", struct.pack("<H", bits_stored))
    out += mk(0x0028, 0x0103, b"US", struct.pack("<H", 0))
    px = pixels.astype("<u2").tobytes()
    if explicit:
        out += _el_explicit(0x7FE0, 0x0010, b"OW", px)
    else:
        out += _el_implicit(0x7FE0, 0x0010, px)
    with open(path, "wb") as f:
        f.write(out)


def _packbits(data: bytes) -> bytes:
    """PackBits encode (PS3.5 Annex G.3.1): replicate runs >= 2, else
    literal chunks of <= 128 bytes."""
    out = bytearray()
    i = 0
    while i < len(data):
        run = 1
        while i + run < len(data) and data[i + run] == data[i] and run < 128:
            run += 1
        if run >= 2:
            out.append(257 - run)
            out.append(data[i])
            i += run
        else:
            j = i + 1
            while (
                j < len(data)
                and (j - i) < 128
                and not (j + 1 < len(data) and data[j] == data[j + 1])
            ):
                j += 1
            out.append(j - i - 1)
            out.extend(data[i:j])
            i = j
    return bytes(out)


def _item(data: bytes) -> bytes:
    return struct.pack("<HHI", 0xFFFE, 0xE000, len(data)) + data


def write_encapsulated(path, rows, cols, bits_stored, syntax_uid: bytes,
                        frame: bytes | None, bits_alloc: int = 16):
    """Part 10 file with encapsulated PixelData under `syntax_uid`."""
    out = b"\x00" * 128 + b"DICM"
    out += _el_explicit(0x0002, 0x0010, b"UI", syntax_uid)
    out += _el_explicit(0x0010, 0x0020, b"LO", b"PATRLE")
    out += _el_explicit(0x0010, 0x1010, b"AS", b"042Y")
    out += _el_explicit(0x0020, 0x0062, b"CS", b"R")
    out += _el_explicit(0x0028, 0x0010, b"US", struct.pack("<H", rows))
    out += _el_explicit(0x0028, 0x0011, b"US", struct.pack("<H", cols))
    out += _el_explicit(0x0028, 0x0100, b"US", struct.pack("<H", bits_alloc))
    out += _el_explicit(0x0028, 0x0101, b"US", struct.pack("<H", bits_stored))
    out += _el_explicit(0x0028, 0x0103, b"US", struct.pack("<H", 0))
    out += struct.pack("<HH", 0x7FE0, 0x0010) + b"OB\x00\x00"
    out += struct.pack("<I", 0xFFFFFFFF)
    out += _item(b"")  # empty Basic Offset Table
    if frame is not None:
        out += _item(frame)
    out += struct.pack("<HHI", 0xFFFE, 0xE0DD, 0)  # sequence delimiter
    with open(path, "wb") as f:
        f.write(out)


def rle_frame(px: np.ndarray) -> bytes:
    """One RLE frame (PS3.5 Annex G): 64-byte header + per-byte-plane
    PackBits segments, segment 0 = most significant byte."""
    flat = px.astype(">u2").tobytes()  # big-endian -> plane split is easy
    msb = _packbits(flat[0::2])
    lsb = _packbits(flat[1::2])
    if len(msb) % 2:
        msb += b"\x00"
    if len(lsb) % 2:
        lsb += b"\x00"
    offsets = [64, 64 + len(msb)] + [0] * 13
    header = struct.pack("<16I", 2, *offsets)
    return header + msb + lsb


def write_deflated(path, rows, cols, bits_stored, px: np.ndarray):
    """Part 10 file in Deflated Explicit VR LE (1.2.840.10008.1.2.1.99,
    PS3.5 A.5): the main dataset is one RAW deflate stream (no zlib
    header) after the uncompressed meta group."""
    import zlib

    body = _el_explicit(0x0010, 0x0020, b"LO", b"PATDEF")
    body += _el_explicit(0x0020, 0x0062, b"CS", b"L")
    body += _el_explicit(0x0028, 0x0010, b"US", struct.pack("<H", rows))
    body += _el_explicit(0x0028, 0x0011, b"US", struct.pack("<H", cols))
    body += _el_explicit(0x0028, 0x0100, b"US", struct.pack("<H", 16))
    body += _el_explicit(0x0028, 0x0101, b"US", struct.pack("<H", bits_stored))
    body += _el_explicit(0x7FE0, 0x0010, b"OW", px.astype("<u2").tobytes())
    z = zlib.compressobj(9, zlib.DEFLATED, -15)  # raw deflate
    out = b"\x00" * 128 + b"DICM"
    out += _el_explicit(0x0002, 0x0010, b"UI", b"1.2.840.10008.1.2.1.99")
    out += z.compress(body) + z.flush()
    with open(path, "wb") as f:
        f.write(out)


# Canonical Huffman table covering every SSSS category 0..16 (Kraft-exact).
_JPLL_COUNTS = [0, 1, 5, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 0, 0, 0]
_JPLL_VALUES = list(range(17))


def _jpll_codes():
    """Canonical (code, length) per symbol — the decoder's own convention."""
    codes, code, k = {}, 0, 0
    for length in range(1, 17):
        for _ in range(_JPLL_COUNTS[length - 1]):
            codes[_JPLL_VALUES[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return codes


class _BitWriter:
    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.n = 0

    def put(self, value, nbits):
        for i in range(nbits - 1, -1, -1):
            self.acc = (self.acc << 1) | ((value >> i) & 1)
            self.n += 1
            if self.n == 8:
                self.out.append(self.acc)
                if self.acc == 0xFF:
                    self.out.append(0x00)  # byte stuffing
                self.acc = 0
                self.n = 0

    def align(self):
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)  # pad with 1s


def jpeg_lossless_frame(px, bits, predictor=1, pt=0, restart=0):
    """Encode a grayscale array as an ISO 10918-1 process-14 stream."""
    rows, cols = px.shape
    codes = _jpll_codes()
    w = _BitWriter()
    x = (px.astype(np.int64) >> pt)
    recon = np.zeros((rows, cols), np.int64)
    default = 1 << (bits - pt - 1)
    since, rst = 0, 0
    fresh = True
    first_row = 0  # first line of the current restart interval: 1-D Ra
    for y in range(rows):
        for xx in range(cols):
            if restart and since == restart:
                w.align()
                w.out += bytes([0xFF, 0xD0 + (rst % 8)])
                rst += 1
                since = 0
                fresh = True
                first_row = y
            if fresh:
                pred = default
                fresh = False
            elif y == first_row:
                pred = recon[y, xx - 1]
            elif xx == 0:
                pred = recon[y - 1, 0]
            else:
                ra, rb, rc = recon[y, xx - 1], recon[y - 1, xx], recon[y - 1, xx - 1]
                pred = {
                    1: ra, 2: rb, 3: rc, 4: ra + rb - rc,
                    5: ra + ((rb - rc) >> 1), 6: rb + ((ra - rc) >> 1),
                    7: (ra + rb) >> 1,
                }[predictor]
            recon[y, xx] = x[y, xx]
            d = (int(x[y, xx]) - int(pred)) % 65536
            if d > 32768:
                d -= 65536
            if d == 0:
                ssss = 0
            elif d == 32768:
                ssss = 16
            else:
                ssss = abs(d).bit_length()
            c, ln = codes[ssss]
            w.put(c, ln)
            if 0 < ssss < 16:
                v = d if d >= 0 else d + (1 << ssss) - 1
                w.put(v, ssss)
            since += 1
    w.align()
    entropy = bytes(w.out)

    def seg(marker, body):
        return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body

    dht = seg(0xC4, bytes([0x00]) + bytes(_JPLL_COUNTS) + bytes(_JPLL_VALUES))
    sof = seg(0xC3, struct.pack(">BHHB", bits, rows, cols, 1) + bytes([1, 0x11, 0]))
    dri = seg(0xDD, struct.pack(">H", restart)) if restart else b""
    sos = seg(0xDA, bytes([1, 1, 0x00, predictor, 0, pt]))
    return b"\xff\xd8" + dht + sof + dri + sos + entropy + b"\xff\xd9"


_JLS_J = [0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3,
          4, 4, 5, 5, 6, 6, 7, 7, 8, 9, 10, 11, 12, 13, 14, 15]


class _JlsBitWriter:
    """MSB-first with T.87 A.1 stuffing: after an 0xFF byte the next byte
    carries only SEVEN bits (its MSB is a stuffed 0)."""

    def __init__(self):
        self.out = bytearray()
        self.bits = []

    def put(self, value, nbits):
        for i in range(nbits - 1, -1, -1):
            self.bits.append((value >> i) & 1)
        self._drain(False)

    def _drain(self, flush):
        while True:
            width = 7 if (self.out and self.out[-1] == 0xFF) else 8
            if len(self.bits) < width:
                if not (flush and self.bits):
                    return
                chunk = self.bits + [0] * (width - len(self.bits))
                self.bits = []
            else:
                chunk, self.bits = self.bits[:width], self.bits[width:]
            v = 0
            for b in chunk:
                v = (v << 1) | b
            self.out.append(v)

    def flush(self):
        self._drain(True)


def _jls_thresholds(maxval, near):
    """Default T1/T2/T3 (T.87 C.2.4.1.1.1), incl. the spec's CLAMP_i that
    wraps above-MAXVAL values to the LOWER bound."""
    def clamp(i, lo):
        return lo if (i > maxval or i < lo) else i

    if maxval >= 128:
        f = (min(maxval, 4095) + 128) // 256
        return (clamp(f + 2 + 3 * near, near + 1),
                clamp(4 * f + 3 + 5 * near, near + 2),
                clamp(17 * f + 4 + 7 * near, near + 3))
    f = 256 // (maxval + 1)
    return (clamp(max(2, 3 // f + 3 * near), near + 1),
            clamp(max(3, 7 // f + 5 * near), near + 2),
            clamp(max(4, 21 // f + 7 * near), near + 3))


def _jls_golomb(w, val, k, limit, qbpp):
    """Limited-length Golomb-Rice (T.87 A.5.3)."""
    u = val >> k
    if u < limit - qbpp - 1:
        w.put(1, u + 1)  # u zeros then a 1
        if k:
            w.put(val & ((1 << k) - 1), k)
    else:
        w.put(1, limit - qbpp)  # limit-qbpp-1 zeros then a 1
        w.put(val - 1, qbpp)


def jls_frame(px, precision, near=0, maxval=None, thresholds=None, reset=64):
    """Encode a grayscale array as a T.87 JPEG-LS stream (LOCO-I: context
    modeling + bias cancellation + Golomb coding + run mode)."""
    rows, cols = px.shape
    emit_lse = maxval is not None or thresholds is not None or reset != 64
    mv = maxval if maxval is not None else (1 << precision) - 1
    t1, t2, t3 = thresholds if thresholds else _jls_thresholds(mv, near)
    step = 2 * near + 1
    rng_ = (mv + 2 * near) // step + 1
    wrap = rng_ * step
    qbpp = max(1, (rng_ - 1).bit_length())
    bpp = max(2, mv.bit_length())
    limit = 2 * (bpp + max(8, bpp))
    A = [max(2, (rng_ + 32) // 64)] * 367
    B = [0] * 365
    Cb = [0] * 365
    N = [1] * 367
    Nn = [0, 0]
    run_index = 0
    w = _JlsBitWriter()
    src = px.astype(np.int64)

    def quant(d):
        if d <= -t3:
            return -4
        if d <= -t2:
            return -3
        if d <= -t1:
            return -2
        if d < -near:
            return -1
        if d <= near:
            return 0
        if d < t1:
            return 1
        if d < t2:
            return 2
        if d < t3:
            return 3
        return 4

    def modrange(e):
        if e < 0:
            e += rng_
        if e >= (rng_ + 1) // 2:
            e -= rng_
        return e

    prev = [0] * (cols + 2)
    cur = [0] * (cols + 2)
    for y in range(rows):
        cur[0] = prev[1]
        prev[cols + 1] = prev[cols]
        x = 0
        while x < cols:
            ra, rb, rc, rd = cur[x], prev[x + 1], prev[x], prev[x + 2]
            q1, q2, q3 = quant(rd - rb), quant(rb - rc), quant(rc - ra)
            if q1 == q2 == q3 == 0:
                # Run mode (A.7): samples within NEAR of Ra reconstruct AS Ra.
                runcnt = 0
                while (x + runcnt < cols
                       and abs(int(src[y, x + runcnt]) - ra) <= near):
                    cur[x + 1 + runcnt] = ra
                    runcnt += 1
                x += runcnt
                while runcnt >= (1 << _JLS_J[run_index]):
                    w.put(1, 1)
                    runcnt -= 1 << _JLS_J[run_index]
                    if run_index < 31:
                        run_index += 1
                if x >= cols:
                    if runcnt > 0:
                        w.put(1, 1)  # partial segment ending the line
                    continue
                w.put(0, 1)
                if _JLS_J[run_index]:
                    w.put(runcnt, _JLS_J[run_index])
                # Run interruption sample (A.7.2).
                ix = int(src[y, x])
                rb2 = prev[x + 1]
                ritype = 1 if abs(ra - rb2) <= near else 0
                pxp = ra if ritype else rb2
                errval = ix - pxp
                flip = ritype == 0 and ra > rb2
                if flip:
                    errval = -errval
                if near > 0:
                    if errval > 0:
                        errval = (near + errval) // step
                    else:
                        errval = -((near - errval) // step)
                    rx = pxp + (-errval if flip else errval) * step
                    if rx < -near:
                        rx += wrap
                    elif rx > mv + near:
                        rx -= wrap
                    rx = min(max(rx, 0), mv)
                else:
                    rx = ix
                errval = modrange(errval)
                ctx = 365 + ritype
                temp = A[ctx] + (N[ctx] >> 1 if ritype else 0)
                k = 0
                while (N[ctx] << k) < temp:
                    k += 1
                cond = k == 0 and 2 * Nn[ritype] < N[ctx]
                if errval == 0:
                    m = 0
                elif errval > 0:
                    m = 1 if cond else 0
                else:
                    m = 0 if cond else 1
                em = 2 * abs(errval) - ritype - m
                _jls_golomb(w, em, k, limit - _JLS_J[run_index] - 1, qbpp)
                if errval < 0:
                    Nn[ritype] += 1
                A[ctx] += (em + 1 - ritype) >> 1
                if N[ctx] == reset:
                    A[ctx] >>= 1
                    N[ctx] >>= 1
                    Nn[ritype] >>= 1
                N[ctx] += 1
                cur[x + 1] = rx
                x += 1
                if run_index > 0:
                    run_index -= 1
                continue
            # Regular mode (A.4-A.6).
            q = 81 * q1 + 9 * q2 + q3
            sign = 1
            if q < 0:
                sign, q = -1, -q
            mn, mx = min(ra, rb), max(ra, rb)
            if rc >= mx:
                pxp = mn
            elif rc <= mn:
                pxp = mx
            else:
                pxp = ra + rb - rc
            pxp = min(max(pxp + sign * Cb[q], 0), mv)
            ix = int(src[y, x])
            errval = ix - pxp
            if sign < 0:
                errval = -errval
            if near > 0:
                if errval > 0:
                    errval = (near + errval) // step
                else:
                    errval = -((near - errval) // step)
                rx = pxp + sign * errval * step
                if rx < -near:
                    rx += wrap
                elif rx > mv + near:
                    rx -= wrap
                rx = min(max(rx, 0), mv)
            else:
                rx = ix
            errval = modrange(errval)
            k = 0
            while (N[q] << k) < A[q]:
                k += 1
            if near == 0 and k == 0 and 2 * B[q] <= -N[q]:
                merr = 2 * errval + 1 if errval >= 0 else -2 * (errval + 1)
            else:
                merr = 2 * errval if errval >= 0 else -2 * errval - 1
            _jls_golomb(w, merr, k, limit, qbpp)
            B[q] += errval * step
            A[q] += abs(errval)
            if N[q] == reset:
                A[q] >>= 1
                B[q] = B[q] >> 1 if B[q] >= 0 else -((1 - B[q]) >> 1)
                N[q] >>= 1
            N[q] += 1
            if B[q] <= -N[q]:
                B[q] += N[q]
                if Cb[q] > -128:
                    Cb[q] -= 1
                if B[q] <= -N[q]:
                    B[q] = -N[q] + 1
            elif B[q] > 0:
                B[q] -= N[q]
                if Cb[q] < 127:
                    Cb[q] += 1
                if B[q] > 0:
                    B[q] = 0
            cur[x + 1] = rx
            x += 1
        prev, cur = cur, prev
    w.flush()

    def seg(marker, body):
        return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body

    sof = seg(0xF7, struct.pack(">BHHB", precision, rows, cols, 1)
              + bytes([1, 0x11, 0]))
    lse = (seg(0xF8, bytes([1]) + struct.pack(">HHHHH", mv, t1, t2, t3, reset))
           if emit_lse else b"")
    sos = seg(0xDA, bytes([1, 1, 0x00, near, 0, 0]))
    frame = b"\xff\xd8" + sof + lse + sos + bytes(w.out) + b"\xff\xd9"
    if len(frame) % 2:
        frame += b"\x00"  # DICOM items carry even byte counts
    return frame


# ---------------------------------------------------------------------------
# JPEG sequential DCT (1.2.840.10008.1.2.4.50 Baseline / .51 Extended).
# Independent encoder fixture: float FDCT + quantization + canonical
# Huffman with a flat 9-bit code alphabet (any valid DHT is legal), so the
# decoder's table building, RLE/EOB/ZRL handling, EXTEND, dequant and IDCT
# are all exercised against a second implementation of the spec.

_ZZ = [0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
       12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
       35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
       58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63]


def _dct_basis():
    c = np.zeros((8, 8))
    for u in range(8):
        a = np.sqrt(1 / 8) if u == 0 else 0.5
        for x in range(8):
            c[u, x] = a * np.cos((2 * x + 1) * u * np.pi / 16)
    return c


def _flat_table(values):
    """DHT payload giving every symbol a canonical 9-bit code."""
    counts = [0] * 16
    counts[8] = len(values)  # all codes at length 9
    return bytes(counts), bytes(values), {v: (i, 9) for i, v in enumerate(values)}


def dct_frame(px, bits, qscale=1.0, restart=0, force_sof1=False):
    """Encode grayscale `px` as a sequential-DCT JPEG; returns
    (stream bytes, the fixture's own reconstruction — what a conforming
    decoder must reproduce to within IDCT rounding)."""
    rows, cols = px.shape
    level = 1 << (bits - 1)
    maxval = (1 << bits) - 1
    qtab = np.maximum(1, np.round((8 + np.arange(64)) * qscale)).astype(int)
    cb = _dct_basis()
    bh, bw = -(-rows // 8), -(-cols // 8)
    padded = np.pad(px.astype(np.float64), ((0, bh * 8 - rows), (0, bw * 8 - cols)),
                    mode="edge") - level
    coefs = np.zeros((bh, bw, 64), np.int64)  # zigzag order, quantized
    recon = np.zeros((bh * 8, bw * 8))
    for by in range(bh):
        for bx in range(bw):
            blk = padded[by * 8:by * 8 + 8, bx * 8:bx * 8 + 8]
            f = cb @ blk @ cb.T
            deq = np.zeros((8, 8))
            for k in range(64):
                z = _ZZ[k]
                qc = int(np.round(f.flat[z] / qtab[k]))
                coefs[by, bx, k] = qc
                deq.flat[z] = qc * qtab[k]
            recon[by * 8:by * 8 + 8, bx * 8:bx * 8 + 8] = cb.T @ deq @ cb
    expected = np.clip(np.round(recon[:rows, :cols]) + level, 0, maxval)

    dc_counts, dc_vals, dc_code = _flat_table(list(range(16)))
    ac_syms = [0x00] + [(r << 4) | s for r in range(16) for s in range(1, 16)]
    ac_syms.append(0xF0)
    ac_counts, ac_vals, ac_code = _flat_table(ac_syms)
    w = _BitWriter()
    pred, since, rst = 0, 0, 0

    def put_sym(code_map, sym):
        c, ln = code_map[sym]
        w.put(c, ln)

    def put_extend(v, s):
        w.put(v if v >= 0 else v + (1 << s) - 1, s)

    for by in range(bh):
        for bx in range(bw):
            if restart and since == restart:
                w.align()
                w.out += bytes([0xFF, 0xD0 + (rst % 8)])
                rst += 1
                since = 0
                pred = 0
            qc = coefs[by, bx]
            diff = int(qc[0]) - pred
            pred = int(qc[0])
            t = abs(diff).bit_length()
            put_sym(dc_code, t)
            if t:
                put_extend(diff, t)
            k = 1
            while k < 64:
                j = k
                while j < 64 and qc[j] == 0:
                    j += 1
                if j == 64:
                    put_sym(ac_code, 0x00)  # EOB
                    break
                r = j - k
                while r >= 16:
                    put_sym(ac_code, 0xF0)  # ZRL
                    r -= 16
                v = int(qc[j])
                s = abs(v).bit_length()
                put_sym(ac_code, (r << 4) | s)
                put_extend(v, s)
                k = j + 1
            since += 1
    w.align()

    def seg(marker, body):
        return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body

    pq = 1 if qtab.max() > 255 or bits == 12 else 0
    qbody = bytes([pq << 4]) + (
        b"".join(struct.pack(">H", int(v)) for v in qtab) if pq
        else bytes(int(v) for v in qtab))
    sof_marker = 0xC1 if (bits == 12 or force_sof1) else 0xC0
    out = b"\xff\xd8"
    out += seg(0xDB, qbody)
    out += seg(sof_marker,
               struct.pack(">BHHB", bits, rows, cols, 1) + bytes([1, 0x11, 0]))
    out += seg(0xC4, bytes([0x00]) + dc_counts + dc_vals)
    out += seg(0xC4, bytes([0x11]) + ac_counts + ac_vals)
    if restart:
        out += seg(0xDD, struct.pack(">H", restart))
    out += seg(0xDA, bytes([1, 1, 0x01, 0, 63, 0]))
    out += bytes(w.out) + b"\xff\xd9"
    if len(out) % 2:
        out += b"\x00"
    return out, expected.astype(np.int64)


def j2k_codestream(px: np.ndarray, **save_kw) -> bytes:
    """Raw JPEG 2000 codestream (SOC..EOC) for `px` via Pillow's OpenJPEG
    codec, reversible 5/3 unless overridden; ``no_jp2=False`` wraps it in
    a JP2 file."""
    import io

    from PIL import Image

    save_kw.setdefault("irreversible", False)
    save_kw.setdefault("no_jp2", True)
    buf = io.BytesIO()
    Image.fromarray(px).save(buf, format="JPEG2000", **save_kw)
    return buf.getvalue()
