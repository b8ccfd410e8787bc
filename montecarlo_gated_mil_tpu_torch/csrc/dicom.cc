// Native DICOM reader for the data pipeline.
//
// Replaces the reference's pydicom dependency (/root/reference/dataset.py:4,
// 93-112,162-180) with a small C++ parser exposed over a C ABI (ctypes).
// Scope: DICOM Part 10 files with uncompressed ("native") pixel data in
// Explicit or Implicit VR Little Endian — the format mammography exports in
// this pipeline use — plus the compressed transfer syntaxes clinical
// archives actually emit: RLE Lossless (1.2.840.10008.1.2.5, PS3.5 Annex
// G), JPEG Lossless process 14 (1.2.840.10008.1.2.4.57/.70, ISO 10918-1
// SOF3, grayscale), lossy JPEG sequential DCT (1.2.840.10008.1.2.4.50
// Baseline / .51 Extended 12-bit, ISO 10918-1 SOF0/SOF1, grayscale),
// JPEG-LS (1.2.840.10008.1.2.4.80 lossless / .81 near-lossless, ITU-T
// T.87 LOCO-I, grayscale), JPEG 2000 Part 1 (1.2.840.10008.1.2.4.90/.91,
// ISO 15444-1 / ITU-T T.800, reversible 5/3 grayscale — see the J2K
// section header for the precise envelope), and Deflated Explicit VR LE
// (1.2.840.10008.1.2.1.99, PS3.5 A.5, via zlib).  Remaining syntaxes
// (HTJ2K, big-endian) fail with an error NAMING the UID
// so the gap is diagnosable (pydicom would decode those,
// /root/reference/dataset.py:93-112).  Extracted fields mirror exactly what
// the reference reads: Rows, Columns, BitsStored, PixelRepresentation,
// PatientID, PatientAge ('dddY'), ImageLaterality, PixelData.
//
// Build:  g++ -O2 -shared -fPIC -o libmcgmil_dicom.so dicom.cc -lz
// The Python wrapper (montecarlo_gated_mil_tpu/data/dicom_native.py) builds
// this lazily if the shared object is missing.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <algorithm>
#include <utility>
#include <vector>

#include <zlib.h>

extern "C" {

struct DicomResult {
  // Pixel data (owned by this struct; release with mcgmil_dicom_free).
  uint8_t* pixels;        // raw little-endian samples
  uint64_t pixel_bytes;   // size of `pixels`
  uint32_t rows;
  uint32_t cols;
  uint32_t bits_allocated;  // 8 or 16
  uint32_t bits_stored;
  uint32_t pixel_representation;  // 0 unsigned, 1 signed
  char patient_id[65];
  char patient_age[17];  // e.g. "042Y"
  char laterality[17];   // e.g. "L" / "R"
  char transfer_syntax[65];  // (0002,0010) UID, empty if absent
  char error[256];       // empty on success
};

}  // extern "C"

namespace {

constexpr uint16_t kGroupPixel = 0x7FE0;
constexpr uint16_t kElemPixelData = 0x0010;

struct Cursor {
  const uint8_t* p;
  size_t n;
  size_t off = 0;

  bool have(size_t k) const { return off + k <= n; }
  uint16_t u16() {
    uint16_t v = static_cast<uint16_t>(p[off]) |
                 (static_cast<uint16_t>(p[off + 1]) << 8);
    off += 2;
    return v;
  }
  uint32_t u32() {
    uint32_t v = static_cast<uint32_t>(p[off]) |
                 (static_cast<uint32_t>(p[off + 1]) << 8) |
                 (static_cast<uint32_t>(p[off + 2]) << 16) |
                 (static_cast<uint32_t>(p[off + 3]) << 24);
    off += 4;
    return v;
  }
};

bool is_short_vr(const char vr[2]) {
  // VRs with 2-byte length in explicit encoding; everything else
  // (OB, OW, OF, SQ, UT, UN, ...) uses 4-byte length after 2 reserved bytes.
  static const char* kShort[] = {"AE", "AS", "AT", "CS", "DA", "DS", "DT",
                                 "FL", "FD", "IS", "LO", "LT", "PN", "SH",
                                 "SL", "SS", "ST", "TM", "UI", "UL", "US"};
  for (const char* s : kShort) {
    if (vr[0] == s[0] && vr[1] == s[1]) return true;
  }
  return false;
}

bool looks_like_vr(uint8_t a, uint8_t b) {
  return a >= 'A' && a <= 'Z' && b >= 'A' && b <= 'Z';
}

void copy_trimmed(char* dst, size_t cap, const uint8_t* src, size_t len) {
  while (len > 0 && (src[len - 1] == ' ' || src[len - 1] == '\0')) --len;
  size_t start = 0;
  while (start < len && src[start] == ' ') ++start;
  size_t k = len - start;
  if (k >= cap) k = cap - 1;
  memcpy(dst, src + start, k);
  dst[k] = '\0';
}

uint32_t parse_uint_value(const uint8_t* data, size_t len, bool is_us) {
  if (is_us && len >= 2) {
    return static_cast<uint32_t>(data[0]) | (static_cast<uint32_t>(data[1]) << 8);
  }
  // IS (integer string) fallback
  char buf[32] = {0};
  size_t k = len < 31 ? len : 31;
  memcpy(buf, data, k);
  return static_cast<uint32_t>(strtoul(buf, nullptr, 10));
}

const char* syntax_name(const char* uid) {
  // Human names for the transfer syntaxes a clinical archive is likely to
  // hand us, so the unsupported-syntax error reads like pydicom's would.
  static const struct { const char* uid; const char* name; } kKnown[] = {
      {"1.2.840.10008.1.2", "Implicit VR Little Endian"},
      {"1.2.840.10008.1.2.1", "Explicit VR Little Endian"},
      {"1.2.840.10008.1.2.1.99", "Deflated Explicit VR Little Endian"},
      {"1.2.840.10008.1.2.2", "Explicit VR Big Endian"},
      {"1.2.840.10008.1.2.4.50", "JPEG Baseline (Process 1)"},
      {"1.2.840.10008.1.2.4.51", "JPEG Extended (Process 2&4)"},
      {"1.2.840.10008.1.2.4.57", "JPEG Lossless (Process 14)"},
      {"1.2.840.10008.1.2.4.70", "JPEG Lossless SV1 (Process 14)"},
      {"1.2.840.10008.1.2.4.80", "JPEG-LS Lossless"},
      {"1.2.840.10008.1.2.4.81", "JPEG-LS Near-Lossless"},
      {"1.2.840.10008.1.2.4.90", "JPEG 2000 Lossless"},
      {"1.2.840.10008.1.2.4.91", "JPEG 2000"},
      {"1.2.840.10008.1.2.4.201", "HTJ2K Lossless"},
      {"1.2.840.10008.1.2.4.202", "HTJ2K Lossless RPCL"},
      {"1.2.840.10008.1.2.4.203", "HTJ2K"},
      {"1.2.840.10008.1.2.5", "RLE Lossless"},
  };
  for (const auto& k : kKnown) {
    if (strcmp(uid, k.uid) == 0) return k.name;
  }
  return "unrecognized transfer syntax";
}

// PackBits-decode one RLE segment (DICOM PS3.5 Annex G.3.1) into the byte
// plane `plane_index` of little-endian composite samples in `out`.
// Segment 0 holds the MOST significant byte of each sample.
bool rle_decode_segment(const uint8_t* seg, size_t seg_len, uint8_t* out,
                        size_t npix, uint32_t bytes_per_sample,
                        uint32_t plane_index) {
  const size_t lane = bytes_per_sample - 1 - plane_index;  // LE byte offset
  size_t i = 0, w = 0;
  while (i < seg_len && w < npix) {
    uint8_t n = seg[i++];
    if (n <= 127) {  // literal run of n+1 bytes
      size_t k = static_cast<size_t>(n) + 1;
      if (i + k > seg_len) return false;
      if (w + k > npix) k = npix - w;
      for (size_t j = 0; j < k; ++j) {
        out[(w + j) * bytes_per_sample + lane] = seg[i + j];
      }
      i += static_cast<size_t>(n) + 1;
      w += k;
    } else if (n >= 129) {  // replicate next byte 257-n times
      if (i >= seg_len) return false;
      size_t k = 257 - static_cast<size_t>(n);
      uint8_t v = seg[i++];
      if (w + k > npix) k = npix - w;
      for (size_t j = 0; j < k; ++j) {
        out[(w + j) * bytes_per_sample + lane] = v;
      }
      w += k;
    }  // n == 128: no-op per Annex G
  }
  return w == npix;
}

// Decode one RLE frame (64-byte header: u32 segment count + 15 u32 segment
// offsets from the start of the frame) into `out` (npix little-endian
// samples of `bytes_per_sample` bytes).
bool rle_decode_frame(const uint8_t* frame, size_t frame_len, uint8_t* out,
                      size_t npix, uint32_t bytes_per_sample, char* err,
                      size_t err_cap) {
  if (frame_len < 64) {
    snprintf(err, err_cap, "RLE frame shorter than its 64-byte header");
    return false;
  }
  auto u32at = [&](size_t off) {
    return static_cast<uint32_t>(frame[off]) |
           (static_cast<uint32_t>(frame[off + 1]) << 8) |
           (static_cast<uint32_t>(frame[off + 2]) << 16) |
           (static_cast<uint32_t>(frame[off + 3]) << 24);
  };
  uint32_t nseg = u32at(0);
  if (nseg != bytes_per_sample) {
    snprintf(err, err_cap,
             "RLE segment count %u != %u bytes/sample (only 1 sample/pixel "
             "grayscale is supported)",
             nseg, bytes_per_sample);
    return false;
  }
  for (uint32_t s = 0; s < nseg; ++s) {
    uint64_t start = u32at(4 + 4 * s);
    uint64_t end = (s + 1 < nseg) ? u32at(4 + 4 * (s + 1)) : frame_len;
    if (start < 64 || end > frame_len || start > end) {
      snprintf(err, err_cap, "RLE segment %u offsets out of range", s);
      return false;
    }
    if (!rle_decode_segment(frame + start, end - start, out, npix,
                            bytes_per_sample, s)) {
      snprintf(err, err_cap,
               "RLE segment %u truncated (decoded fewer than Rows*Cols "
               "samples)",
               s);
      return false;
    }
  }
  return true;
}

// Raw-deflate (no zlib header) inflate for the Deflated Explicit VR Little
// Endian transfer syntax (1.2.840.10008.1.2.1.99, PS3.5 A.5): everything
// after the file meta group is one deflate stream holding the main dataset.
bool inflate_raw(const uint8_t* src, size_t n, std::vector<uint8_t>* out,
                 char* err, size_t err_cap) {
  z_stream zs;
  memset(&zs, 0, sizeof(zs));
  if (inflateInit2(&zs, -15) != Z_OK) {
    snprintf(err, err_cap, "zlib inflateInit failed");
    return false;
  }
  zs.next_in = const_cast<Bytef*>(src);
  zs.avail_in = static_cast<uInt>(n);
  out->resize(n * 4 + 4096);
  for (;;) {
    zs.next_out = out->data() + zs.total_out;
    zs.avail_out = static_cast<uInt>(out->size() - zs.total_out);
    int ret = inflate(&zs, Z_NO_FLUSH);
    if (ret == Z_STREAM_END) break;
    if ((ret == Z_OK || ret == Z_BUF_ERROR) && zs.avail_out == 0) {
      if (out->size() >= (1ull << 31)) {  // decompression-bomb bound
        inflateEnd(&zs);
        snprintf(err, err_cap, "deflated dataset exceeds 2 GiB");
        return false;
      }
      out->resize(out->size() * 2);
      continue;
    }
    inflateEnd(&zs);
    if (ret == Z_OK) {
      snprintf(err, err_cap, "deflate stream truncated");
    } else {
      snprintf(err, err_cap, "deflate stream corrupt (zlib error %d)", ret);
    }
    return false;
  }
  out->resize(zs.total_out);
  inflateEnd(&zs);
  return true;
}

// ---------------------------------------------------------------------------
// JPEG Lossless (ISO/IEC 10918-1 process 14; DICOM transfer syntaxes
// 1.2.840.10008.1.2.4.57 and .70 — PS3.5 A.4.1).  Scope: single-component
// (grayscale) SOF3 scans, any predictor 1-7, any point transform, 2-16 bit
// precision, optional restart intervals — i.e. what mammography archives
// emit (SV1 = predictor 1, Pt 0).  The reference reads these through
// pydicom's decoders (/root/reference/dataset.py:93-112).

struct HuffTable {
  int32_t maxcode[17];  // largest code of each length, -1 if none
  int32_t mincode[17];
  int32_t valptr[17];
  uint8_t vals[256];
  // 8-bit-prefix fast path: symbol + code length for every code of <= 8
  // bits (lut_len 0 -> fall back to the canonical walk).  SSSS categories
  // are geometrically distributed, so nearly every symbol hits the LUT.
  uint8_t lut_sym[256];
  uint8_t lut_len[256];
  bool present = false;
};

// Canonical table per ISO 10918-1 C.2 (DECODE procedure tables F.15/F.16).
// `max_val` bounds the symbol alphabet: 16 for lossless/DC SSSS categories
// (anything larger would drive undefined-behavior shifts in read_diff),
// 255 for sequential-DCT AC run/size bytes.
bool build_huff(const uint8_t counts[16], const uint8_t* values,
                size_t nvals, HuffTable* t, uint8_t max_val = 16) {
  if (nvals > 256) return false;
  // VALIDATE before touching any table state: an oversubscribed DHT must
  // fail here, not mid-LUT-fill — the fill indexes lut_sym[code << (8-l)],
  // which runs far out of bounds exactly when the canonical code
  // overflows (crafted-file stack corruption, caught in review).
  {
    int32_t code = 0;
    for (int l = 1; l <= 16; ++l) {
      code += counts[l - 1];
      if (code > (1 << l)) return false;  // oversubscribed
      code <<= 1;
    }
  }
  for (size_t i = 0; i < nvals; ++i) {
    if (values[i] > max_val) return false;
  }
  memcpy(t->vals, values, nvals);
  memset(t->lut_len, 0, sizeof(t->lut_len));
  int32_t code = 0, k = 0;
  for (int l = 1; l <= 16; ++l) {
    if (counts[l - 1] == 0) {
      t->maxcode[l] = -1;
      t->mincode[l] = 0;
      t->valptr[l] = 0;
    } else {
      t->valptr[l] = k;
      t->mincode[l] = code;
      if (l <= 8) {
        for (int i = 0; i < counts[l - 1]; ++i) {
          int32_t prefix = (code + i) << (8 - l);
          for (int fill = 0; fill < (1 << (8 - l)); ++fill) {
            t->lut_sym[prefix + fill] = values[k + i];
            t->lut_len[prefix + fill] = static_cast<uint8_t>(l);
          }
        }
      }
      code += counts[l - 1];
      k += counts[l - 1];
      t->maxcode[l] = code - 1;
    }
    code <<= 1;
  }
  t->present = true;
  return true;
}

// Entropy-coded-segment bit reader: a 64-bit accumulator refilled bytewise
// with 0xFF00 un-stuffing.  It never consumes a real marker (0xFF followed
// by nonzero); past one — or past the stream end — it supplies ZERO pad
// bits and counts them, so the caller can tell a clean finish (pad bits
// buffered but unread) from a truncated stream (pad bits consumed).
struct BitReader {
  const uint8_t* p;
  size_t n;
  size_t off = 0;
  uint64_t acc = 0;
  int nbits = 0;
  int pad_bits = 0;  // zero bits appended past the real stream

  inline void fill(int want) {
    while (nbits < want) {
      // Bulk path: 4 bytes at once when none is 0xFF (no stuffing or
      // marker possible) — the overwhelmingly common case.
      if (nbits <= 32 && off + 4 <= n) {
        uint32_t w;
        memcpy(&w, p + off, 4);
        uint32_t v = ~w;  // a byte of w is 0xFF iff the byte of v is 0
        if (((v - 0x01010101u) & ~v & 0x80808080u) == 0) {
          acc = (acc << 32) | static_cast<uint64_t>(__builtin_bswap32(w));
          nbits += 32;
          off += 4;
          continue;
        }
      }
      if (off < n) {
        uint8_t b = p[off];
        if (b == 0xFF) {
          if (off + 1 < n && p[off + 1] == 0x00) {
            off += 2;  // stuffed data byte
          } else {
            acc <<= 8;  // a real marker: pad instead of consuming
            nbits += 8;
            pad_bits += 8;
            continue;
          }
        } else {
          ++off;
        }
        acc = (acc << 8) | b;
        nbits += 8;
      } else {
        acc <<= 8;
        nbits += 8;
        pad_bits += 8;
      }
    }
  }

  inline uint32_t peek8() {
    fill(8);
    return static_cast<uint32_t>((acc >> (nbits - 8)) & 0xFF);
  }

  inline uint32_t get(int k) {
    fill(k);
    nbits -= k;
    return static_cast<uint32_t>((acc >> nbits) & ((1u << k) - 1));
  }

  // True once any decoded value depended on pad bits (truncated stream).
  inline bool overran() const { return nbits < pad_bits; }

  // Restart handling: drop the buffered tail of the interval (the final
  // entropy byte's 1-padding) and read bytes directly at `off` again.
  inline void reset_to_stream() {
    acc = 0;
    nbits = 0;
    pad_bits = 0;
  }
};

inline int decode_symbol(BitReader* br, const HuffTable& t) {
  br->fill(24);  // symbol (<= 8 via LUT) + magnitude bits (<= 16) at once
  uint32_t prefix = br->peek8();
  int len = t.lut_len[prefix];
  if (len) {
    br->nbits -= len;
    return t.lut_sym[prefix];
  }
  // Canonical walk for the rare > 8-bit codes.
  int32_t code = 0;
  for (int l = 1; l <= 16; ++l) {
    code = (code << 1) | static_cast<int32_t>(br->get(1));
    if (t.maxcode[l] >= 0 && code <= t.maxcode[l]) {
      return t.vals[t.valptr[l] + (code - t.mincode[l])];
    }
  }
  return -1;
}

// SSSS-category difference: read ssss magnitude bits and sign-extend
// (ISO 10918-1 F.2.2.1 EXTEND); ssss 16 is +32768 with no extra bits.
inline int32_t read_diff(BitReader* br, int ssss) {
  if (ssss == 0) return 0;
  if (ssss == 16) return 32768;
  int32_t v = static_cast<int32_t>(br->get(ssss));
  if (v < (1 << (ssss - 1))) v -= (1 << ssss) - 1;
  return v;
}

// One SOF3 scan, specialized at compile time over (predictor, bytes per
// sample) so the per-sample path is branch-free: SV1 mammograms decode a
// predictor-1 loop where the prediction is the running previous sample.
template <int PRED, int BPS>
bool decode_scan(BitReader& br, const HuffTable& t, uint32_t rows,
                 uint32_t cols, uint8_t* out, int32_t default_pred,
                 uint32_t ri, int pt, char* err, size_t err_cap) {
  std::vector<int32_t> prev(cols, 0), cur(cols, 0);
  uint32_t since_restart = 0;
  uint32_t first_row = 0;  // the current restart interval's first line
  bool fresh = true;  // next sample predicts default (scan/restart start)
  for (uint32_t yy = 0; yy < rows; ++yy) {
    uint8_t* row_out = out + static_cast<size_t>(yy) * cols * BPS;
    for (uint32_t xx = 0; xx < cols; ++xx) {
      if (ri && since_restart == ri) {
        // Byte-aligned RSTn between restart intervals; prediction resets
        // as at the start of the scan (ISO H.1.2.2).
        if (br.overran()) {
          snprintf(err, err_cap, "JPEG entropy data truncated");
          return false;
        }
        br.reset_to_stream();  // drop the interval's alignment padding
        size_t mo = br.off;
        // Optional 0xFF fill bytes may precede any marker (B.1.1.2).
        while (mo + 1 < br.n && br.p[mo] == 0xFF && br.p[mo + 1] == 0xFF) ++mo;
        if (mo + 1 >= br.n || br.p[mo] != 0xFF ||
            br.p[mo + 1] < 0xD0 || br.p[mo + 1] > 0xD7) {
          snprintf(err, err_cap, "JPEG restart marker missing");
          return false;
        }
        br.off = mo + 2;
        since_restart = 0;
        fresh = true;
        first_row = yy;
      }
      int ssss = decode_symbol(&br, t);
      if (ssss < 0) {
        snprintf(err, err_cap, "JPEG entropy data corrupt at sample (%u,%u)",
                 yy, xx);
        return false;
      }
      int32_t diff = read_diff(&br, ssss);
      int32_t pred;
      if (fresh) {
        pred = default_pred;
        fresh = false;
      } else if (yy == first_row) {
        // The 1-D Ra predictor for the first line of the scan AND of each
        // restart interval (H.1.2.2) — not just image row 0.
        pred = cur[xx - 1];
      } else if (xx == 0) {
        pred = prev[0];  // first column: predictor 2
      } else {
        int32_t ra = cur[xx - 1], rb = prev[xx], rc = prev[xx - 1];
        pred = PRED == 1   ? ra
               : PRED == 2 ? rb
               : PRED == 3 ? rc
               : PRED == 4 ? ra + rb - rc
               : PRED == 5 ? ra + ((rb - rc) >> 1)
               : PRED == 6 ? rb + ((ra - rc) >> 1)
                           : (ra + rb) >> 1;  // 7
      }
      int32_t val = (pred + diff) & 0xFFFF;  // modulo 2^16 (F.2.2.1)
      cur[xx] = val;
      uint32_t sample = static_cast<uint32_t>(val) << pt;
      row_out[xx * BPS] = static_cast<uint8_t>(sample & 0xFF);
      if (BPS == 2) row_out[xx * BPS + 1] = static_cast<uint8_t>(sample >> 8);
      ++since_restart;
    }
    std::swap(prev, cur);
  }
  if (br.overran()) {
    snprintf(err, err_cap, "JPEG entropy data truncated");
    return false;
  }
  return true;
}

bool jpeg_lossless_decode(const uint8_t* data, size_t len, uint8_t* out,
                          uint32_t rows, uint32_t cols, uint32_t bps,
                          char* err, size_t err_cap) {
  // Scan to SOI (fragments may carry leading padding).
  size_t off = 0;
  while (off + 1 < len && !(data[off] == 0xFF && data[off + 1] == 0xD8)) ++off;
  if (off + 1 >= len) {
    snprintf(err, err_cap, "JPEG stream has no SOI marker");
    return false;
  }
  off += 2;

  HuffTable tables[4];
  int precision = 0, pt = 0, predictor = 0, table_id = 0;
  uint32_t ri = 0;  // restart interval (samples; 1 MCU = 1 sample here)
  bool have_sof = false;

  while (off + 1 < len) {
    if (data[off] != 0xFF) {
      snprintf(err, err_cap, "JPEG marker expected at offset %zu", off);
      return false;
    }
    while (off < len && data[off] == 0xFF) ++off;  // fill bytes
    if (off >= len) break;
    uint8_t m = data[off++];
    if (m == 0xD9) break;  // EOI before SOS: fall through to error below
    if (off + 1 >= len) break;
    size_t seg_len = (static_cast<size_t>(data[off]) << 8) | data[off + 1];
    if (seg_len < 2 || off + seg_len > len) {
      snprintf(err, err_cap, "JPEG segment FF%02X overruns the stream", m);
      return false;
    }
    const uint8_t* seg = data + off + 2;
    size_t body = seg_len - 2;
    off += seg_len;

    if (m == 0xC4) {  // DHT: one or more tables
      size_t i = 0;
      while (i + 17 <= body) {
        uint8_t tc = seg[i] >> 4, th = seg[i] & 0x0F;
        const uint8_t* counts = seg + i + 1;
        size_t nv = 0;
        for (int l = 0; l < 16; ++l) nv += counts[l];
        if (i + 17 + nv > body || th > 3) {
          snprintf(err, err_cap, "JPEG DHT segment malformed");
          return false;
        }
        if (tc == 0 && !build_huff(counts, seg + i + 17, nv, &tables[th])) {
          snprintf(err, err_cap, "JPEG Huffman table %u oversubscribed", th);
          return false;
        }
        i += 17 + nv;
      }
    } else if (m == 0xC3) {  // SOF3: lossless sequential Huffman
      if (body < 8) {
        snprintf(err, err_cap, "JPEG SOF3 segment too short");
        return false;
      }
      precision = seg[0];
      uint32_t y = (seg[1] << 8) | seg[2];
      uint32_t x = (seg[3] << 8) | seg[4];
      uint8_t nf = seg[5];
      if (nf != 1) {
        snprintf(err, err_cap,
                 "JPEG Lossless with %u components unsupported (grayscale "
                 "mammography expects 1)",
                 nf);
        return false;
      }
      if (y != rows || x != cols) {
        snprintf(err, err_cap,
                 "JPEG frame %ux%u disagrees with Rows/Columns %ux%u", y, x,
                 rows, cols);
        return false;
      }
      if (body >= 9 && seg[7] != 0x11) {
        snprintf(err, err_cap, "JPEG subsampling %02X unsupported", seg[7]);
        return false;
      }
      if (precision < 2 || precision > 16 ||
          (precision > 8 && bps < 2)) {
        snprintf(err, err_cap,
                 "JPEG precision %d incompatible with BitsAllocated %u",
                 precision, bps * 8);
        return false;
      }
      have_sof = true;
    } else if ((m >= 0xC0 && m <= 0xCF) && m != 0xC4 && m != 0xC8 &&
               m != 0xCC) {
      snprintf(err, err_cap,
               "JPEG SOF%d is not lossless process 14 (only SOF3 streams "
               "are supported)",
               m - 0xC0);
      return false;
    } else if (m == 0xDD) {  // DRI
      if (body < 2) {
        snprintf(err, err_cap, "JPEG DRI segment too short");
        return false;
      }
      ri = (seg[0] << 8) | seg[1];
    } else if (m == 0xDA) {  // SOS -> entropy-coded data follows
      if (!have_sof) {
        snprintf(err, err_cap, "JPEG SOS before SOF3");
        return false;
      }
      if (body < 6 || seg[0] != 1) {
        snprintf(err, err_cap, "JPEG scan must hold exactly 1 component");
        return false;
      }
      table_id = seg[2] >> 4;
      predictor = seg[3];       // Ss = predictor selector
      pt = seg[5] & 0x0F;       // Al = point transform
      if (predictor < 1 || predictor > 7) {
        snprintf(err, err_cap, "JPEG predictor %d out of range", predictor);
        return false;
      }
      if (table_id > 3) {  // Td is a 4-bit field; only 0-3 exist
        snprintf(err, err_cap, "JPEG scan references Huffman table %d (> 3)",
                 table_id);
        return false;
      }
      if (!tables[table_id].present) {
        snprintf(err, err_cap, "JPEG scan references missing Huffman table %d",
                 table_id);
        return false;
      }
      if (pt >= precision) {
        snprintf(err, err_cap, "JPEG point transform %d >= precision %d", pt,
                 precision);
        return false;
      }

      BitReader br{data + off, len - off};
      const int32_t default_pred = 1 << (precision - pt - 1);
      switch ((predictor - 1) * 2 + (bps - 1)) {
        case 0:  return decode_scan<1, 1>(br, tables[table_id], rows, cols, out, default_pred, ri, pt, err, err_cap);
        case 1:  return decode_scan<1, 2>(br, tables[table_id], rows, cols, out, default_pred, ri, pt, err, err_cap);
        case 2:  return decode_scan<2, 1>(br, tables[table_id], rows, cols, out, default_pred, ri, pt, err, err_cap);
        case 3:  return decode_scan<2, 2>(br, tables[table_id], rows, cols, out, default_pred, ri, pt, err, err_cap);
        case 4:  return decode_scan<3, 1>(br, tables[table_id], rows, cols, out, default_pred, ri, pt, err, err_cap);
        case 5:  return decode_scan<3, 2>(br, tables[table_id], rows, cols, out, default_pred, ri, pt, err, err_cap);
        case 6:  return decode_scan<4, 1>(br, tables[table_id], rows, cols, out, default_pred, ri, pt, err, err_cap);
        case 7:  return decode_scan<4, 2>(br, tables[table_id], rows, cols, out, default_pred, ri, pt, err, err_cap);
        case 8:  return decode_scan<5, 1>(br, tables[table_id], rows, cols, out, default_pred, ri, pt, err, err_cap);
        case 9:  return decode_scan<5, 2>(br, tables[table_id], rows, cols, out, default_pred, ri, pt, err, err_cap);
        case 10: return decode_scan<6, 1>(br, tables[table_id], rows, cols, out, default_pred, ri, pt, err, err_cap);
        case 11: return decode_scan<6, 2>(br, tables[table_id], rows, cols, out, default_pred, ri, pt, err, err_cap);
        case 12: return decode_scan<7, 1>(br, tables[table_id], rows, cols, out, default_pred, ri, pt, err, err_cap);
        default: return decode_scan<7, 2>(br, tables[table_id], rows, cols, out, default_pred, ri, pt, err, err_cap);
      }
    } else {
      // APPn / COM / DQT / anything else with a length: skipped above.
    }
  }
  snprintf(err, err_cap, have_sof ? "JPEG stream ended before SOS"
                                  : "JPEG stream holds no SOF3 frame");
  return false;
}

// ---------------------------------------------------------------------------
// JPEG sequential DCT (ISO/IEC 10918-1 baseline process 1 and extended
// process 2&4; DICOM transfer syntaxes 1.2.840.10008.1.2.4.50 "JPEG
// Baseline" and .51 "JPEG Extended" — PS3.5 A.4.1).  Scope: Huffman-coded
// single-component (grayscale) SOF0/SOF1 scans, 8- or 12-bit precision,
// restart intervals — the lossy presentation encodings mammography
// archives emit.  Progressive (SOF2) and arithmetic-coded variants are
// refused by name.  Shares the 10918 BitReader (0xFF00 un-stuffing),
// canonical Huffman tables, and EXTEND (read_diff) with the lossless
// process-14 decoder above.

const uint8_t kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// Separable double-precision 2-D inverse DCT (ISO A.3.3).  Accuracy over
// speed: ~300k blocks for a full mammogram is milliseconds either way.
struct IdctBasis {
  double c[8][8];
  IdctBasis() {
    for (int u = 0; u < 8; ++u) {
      double alpha = u == 0 ? 0.353553390593273762 : 0.5;  // sqrt(1/8), 1/2
      for (int x = 0; x < 8; ++x) {
        c[u][x] = alpha * cos((2 * x + 1) * u * 3.14159265358979323846 / 16);
      }
    }
  }
};

void idct8x8(const double in[64], double out[64]) {
  // C++11 magic static: the loader decodes frames concurrently (GIL released
  // in the ctypes call), so initialization must be thread-safe — a hand-rolled
  // `static bool init` guard is a data race and can expose a half-built table.
  static const IdctBasis basis;
  const auto& c = basis.c;
  double tmp[64];
  for (int i = 0; i < 8; ++i) {      // rows: tmp = in * C (sum over v)
    for (int x = 0; x < 8; ++x) {
      double s = 0;
      for (int v = 0; v < 8; ++v) s += in[i * 8 + v] * c[v][x];
      tmp[i * 8 + x] = s;
    }
  }
  for (int x = 0; x < 8; ++x) {      // cols: out = C^T * tmp (sum over u)
    for (int y = 0; y < 8; ++y) {
      double s = 0;
      for (int u = 0; u < 8; ++u) s += tmp[u * 8 + x] * c[u][y];
      out[y * 8 + x] = s;
    }
  }
}

bool jpeg_dct_decode(const uint8_t* data, size_t len, uint8_t* out,
                     uint32_t rows, uint32_t cols, uint32_t bps, char* err,
                     size_t err_cap) {
  size_t off = 0;
  while (off + 1 < len && !(data[off] == 0xFF && data[off + 1] == 0xD8)) ++off;
  if (off + 1 >= len) {
    snprintf(err, err_cap, "JPEG stream has no SOI marker");
    return false;
  }
  off += 2;

  HuffTable dc_tables[4], ac_tables[4];
  uint16_t qt[4][64];
  bool qt_present[4] = {false, false, false, false};
  int precision = 0, comp_tq = 0;
  uint32_t ri = 0;
  bool have_sof = false;

  while (off + 1 < len) {
    if (data[off] != 0xFF) {
      snprintf(err, err_cap, "JPEG marker expected at offset %zu", off);
      return false;
    }
    while (off < len && data[off] == 0xFF) ++off;
    if (off >= len) break;
    uint8_t m = data[off++];
    if (m == 0xD9) break;
    if (off + 1 >= len) break;
    size_t seg_len = (static_cast<size_t>(data[off]) << 8) | data[off + 1];
    if (seg_len < 2 || off + seg_len > len) {
      snprintf(err, err_cap, "JPEG segment FF%02X overruns the stream", m);
      return false;
    }
    const uint8_t* seg = data + off + 2;
    size_t body = seg_len - 2;
    off += seg_len;

    if (m == 0xDB) {  // DQT: one or more tables
      size_t i = 0;
      while (i < body) {
        uint8_t pq = seg[i] >> 4, tq = seg[i] & 0x0F;
        size_t esz = pq ? 2 : 1;
        if (tq > 3 || pq > 1 || i + 1 + 64 * esz > body) {
          snprintf(err, err_cap, "JPEG DQT segment malformed");
          return false;
        }
        for (int kq = 0; kq < 64; ++kq) {
          uint16_t v = pq ? ((seg[i + 1 + 2 * kq] << 8) | seg[i + 2 + 2 * kq])
                          : seg[i + 1 + kq];
          if (v == 0) {
            snprintf(err, err_cap, "JPEG DQT holds a zero quantizer");
            return false;
          }
          qt[tq][kq] = v;  // zigzag order, matching the coefficient stream
        }
        qt_present[tq] = true;
        i += 1 + 64 * esz;
      }
    } else if (m == 0xC4) {  // DHT: DC (tc 0) and AC (tc 1) tables
      size_t i = 0;
      while (i + 17 <= body) {
        uint8_t tc = seg[i] >> 4, th = seg[i] & 0x0F;
        const uint8_t* counts = seg + i + 1;
        size_t nv = 0;
        for (int l = 0; l < 16; ++l) nv += counts[l];
        if (i + 17 + nv > body || th > 3 || tc > 1) {
          snprintf(err, err_cap, "JPEG DHT segment malformed");
          return false;
        }
        HuffTable* t = tc ? &ac_tables[th] : &dc_tables[th];
        if (!build_huff(counts, seg + i + 17, nv, t, tc ? 255 : 16)) {
          snprintf(err, err_cap, "JPEG Huffman table %u invalid", th);
          return false;
        }
        i += 17 + nv;
      }
    } else if (m == 0xC0 || m == 0xC1) {  // SOF0 baseline / SOF1 extended
      if (body < 9) {
        snprintf(err, err_cap, "JPEG SOF segment too short");
        return false;
      }
      precision = seg[0];
      uint32_t y = (seg[1] << 8) | seg[2];
      uint32_t x = (seg[3] << 8) | seg[4];
      if (seg[5] != 1) {
        snprintf(err, err_cap,
                 "JPEG DCT with %u components unsupported (grayscale "
                 "mammography expects 1)",
                 seg[5]);
        return false;
      }
      if (y != rows || x != cols) {
        snprintf(err, err_cap,
                 "JPEG frame %ux%u disagrees with Rows/Columns %ux%u", y, x,
                 rows, cols);
        return false;
      }
      if (seg[7] != 0x11) {
        snprintf(err, err_cap, "JPEG subsampling %02X unsupported", seg[7]);
        return false;
      }
      comp_tq = seg[8];
      if (comp_tq > 3) {
        snprintf(err, err_cap, "JPEG component references DQT %d", comp_tq);
        return false;
      }
      if (!((m == 0xC0 && precision == 8) ||
            (m == 0xC1 && (precision == 8 || precision == 12)))) {
        snprintf(err, err_cap, "JPEG SOF%d precision %d unsupported",
                 m - 0xC0, precision);
        return false;
      }
      if (precision > 8 && bps < 2) {
        snprintf(err, err_cap,
                 "JPEG precision %d incompatible with BitsAllocated %u",
                 precision, bps * 8);
        return false;
      }
      have_sof = true;
    } else if ((m >= 0xC2 && m <= 0xCF) && m != 0xC4 && m != 0xC8) {
      snprintf(err, err_cap,
               "JPEG SOF%d unsupported (only sequential-DCT SOF0/SOF1 under "
               "this transfer syntax)",
               m - 0xC0);
      return false;
    } else if (m == 0xDD) {  // DRI (in MCUs = blocks for grayscale)
      if (body < 2) {
        snprintf(err, err_cap, "JPEG DRI segment too short");
        return false;
      }
      ri = (seg[0] << 8) | seg[1];
    } else if (m == 0xDA) {  // SOS
      if (!have_sof) {
        snprintf(err, err_cap, "JPEG SOS before SOF");
        return false;
      }
      if (body < 6 || seg[0] != 1) {
        snprintf(err, err_cap, "JPEG scan must hold exactly 1 component");
        return false;
      }
      int td = seg[2] >> 4, ta = seg[2] & 0x0F;
      if (seg[3] != 0 || seg[4] != 63 || seg[5] != 0) {
        snprintf(err, err_cap,
                 "JPEG scan is not full-band sequential (Ss=%u Se=%u "
                 "AhAl=%02X): progressive streams are unsupported",
                 seg[3], seg[4], seg[5]);
        return false;
      }
      if (td > 3 || ta > 3 || !dc_tables[td].present ||
          !ac_tables[ta].present) {
        snprintf(err, err_cap, "JPEG scan references missing Huffman table");
        return false;
      }
      if (!qt_present[comp_tq]) {
        snprintf(err, err_cap, "JPEG scan references missing DQT %d",
                 comp_tq);
        return false;
      }
      const HuffTable& dct = dc_tables[td];
      const HuffTable& act = ac_tables[ta];
      const uint16_t* q = qt[comp_tq];
      const int32_t level = 1 << (precision - 1);
      const int32_t maxval = (1 << precision) - 1;
      const uint32_t bw = (cols + 7) / 8, bh = (rows + 7) / 8;
      BitReader br{data + off, len - off};
      // 64-bit: a corrupt stream can walk the DC predictor past int32
      // over a large frame's block count before any decode error fires.
      int64_t pred = 0;
      uint32_t since_restart = 0;
      for (uint32_t by = 0; by < bh; ++by) {
        for (uint32_t bx = 0; bx < bw; ++bx) {
          if (ri && since_restart == ri) {
            if (br.overran()) {
              snprintf(err, err_cap, "JPEG entropy data truncated");
              return false;
            }
            br.reset_to_stream();
            size_t mo = br.off;
            while (mo + 1 < br.n && br.p[mo] == 0xFF && br.p[mo + 1] == 0xFF)
              ++mo;
            if (mo + 1 >= br.n || br.p[mo] != 0xFF || br.p[mo + 1] < 0xD0 ||
                br.p[mo + 1] > 0xD7) {
              snprintf(err, err_cap, "JPEG restart marker missing");
              return false;
            }
            br.off = mo + 2;
            since_restart = 0;
            pred = 0;
          }
          double coef[64] = {0};
          int t = decode_symbol(&br, dct);
          if (t < 0 || t > 15) {
            snprintf(err, err_cap, "JPEG entropy data corrupt in block "
                                   "(%u,%u)", by, bx);
            return false;
          }
          pred += t ? read_diff(&br, t) : 0;
          coef[0] = static_cast<double>(pred) * q[0];
          int kz = 1;
          while (kz < 64) {
            int rs = decode_symbol(&br, act);
            if (rs < 0) {
              snprintf(err, err_cap, "JPEG entropy data corrupt in block "
                                     "(%u,%u)", by, bx);
              return false;
            }
            int r = rs >> 4, s = rs & 15;
            if (s == 0) {
              if (r == 15) {  // ZRL: 16 zeros
                kz += 16;
                continue;
              }
              break;  // EOB
            }
            kz += r;
            if (kz > 63) {
              snprintf(err, err_cap, "JPEG AC run overflows the block");
              return false;
            }
            coef[kZigzag[kz]] =
                static_cast<double>(read_diff(&br, s)) * q[kz];
            ++kz;
          }
          if (br.overran()) {
            snprintf(err, err_cap, "JPEG entropy data truncated");
            return false;
          }
          double samp[64];
          idct8x8(coef, samp);
          uint32_t ylim = rows - by * 8 < 8 ? rows - by * 8 : 8;
          uint32_t xlim = cols - bx * 8 < 8 ? cols - bx * 8 : 8;
          for (uint32_t yy = 0; yy < ylim; ++yy) {
            uint8_t* row_out =
                out + (static_cast<size_t>(by * 8 + yy) * cols + bx * 8) * bps;
            for (uint32_t xx = 0; xx < xlim; ++xx) {
              // Clamp in double BEFORE the integer conversion: corrupt
              // coefficients can push the IDCT output past int32.
              double dv = samp[yy * 8 + xx] + level;
              int32_t v;
              if (dv <= 0) v = 0;
              else if (dv >= maxval) v = maxval;
              else v = static_cast<int32_t>(lround(dv));
              row_out[xx * bps] = static_cast<uint8_t>(v & 0xFF);
              if (bps == 2)
                row_out[xx * bps + 1] = static_cast<uint8_t>(v >> 8);
            }
          }
          ++since_restart;
        }
      }
      if (br.overran()) {
        snprintf(err, err_cap, "JPEG entropy data truncated");
        return false;
      }
      return true;
    }
    // APPn / COM / anything else with a length: skipped.
  }
  snprintf(err, err_cap, have_sof ? "JPEG stream ended before SOS"
                                  : "JPEG stream holds no SOF0/SOF1 frame");
  return false;
}

// ---------------------------------------------------------------------------
// JPEG-LS (ITU-T T.87 / ISO-IEC 14495-1; DICOM transfer syntaxes
// 1.2.840.10008.1.2.4.80 lossless and .81 near-lossless — PS3.5 A.4.3).
// Scope: single-component (grayscale) scans, 2-16 bit precision, any NEAR,
// LSE preset parameters (MAXVAL/T1/T2/T3/RESET).  Restart intervals and
// LSE mapping tables are refused by name (CharLS — what pydicom uses for
// these syntaxes, /root/reference/dataset.py:93-112 — refuses them too).
// The LOCO-I context modeling, Golomb coding, bias cancellation and run
// mode follow T.87 Annexes A (procedures) and C (marker syntax) exactly;
// the decoder is round-tripped against an independent Python encoder in
// tests/test_dicom_native.py.

// Run-length code-order table, T.87 A.7.1.1.
const int kJlsJ[32] = {0, 0, 0, 0, 1, 1, 1, 1, 2,  2,  2,  2,  3,  3,  3, 3,
                       4, 4, 5, 5, 6, 6, 7, 7, 8,  9,  10, 11, 12, 13, 14, 15};

// Bit reader for the JPEG-LS entropy stream: bytes MSB-first; after a 0xFF
// byte the next byte carries only SEVEN bits (its stuffed MSB is 0 —
// T.87 A.1, different from 10918's 0xFF00 un-stuffing).  0xFF followed by
// a byte with the MSB set is a marker: past it — or past the stream end —
// zero pad bits are supplied and counted so the caller can tell a clean
// finish from a truncated stream.
struct JlsBitReader {
  const uint8_t* p;
  size_t n;
  size_t off = 0;
  uint64_t acc = 0;
  int nbits = 0;
  int pad_bits = 0;
  bool prev_ff = false;

  inline void fill(int want) {
    while (nbits < want) {
      // Bulk path: 4 bytes at once when none is 0xFF and the previous
      // byte wasn't (no stuffed bit or marker possible) — the
      // overwhelmingly common case.
      if (!prev_ff && nbits <= 32 && off + 4 <= n) {
        uint32_t w;
        memcpy(&w, p + off, 4);
        uint32_t v = ~w;  // a byte of w is 0xFF iff the byte of v is 0
        if (((v - 0x01010101u) & ~v & 0x80808080u) == 0) {
          acc = (acc << 32) | static_cast<uint64_t>(__builtin_bswap32(w));
          nbits += 32;
          off += 4;
          continue;
        }
      }
      if (off < n) {
        uint8_t b = p[off];
        if (prev_ff) {
          if (b & 0x80) {  // a real marker: pad instead of consuming
            acc <<= 8;
            nbits += 8;
            pad_bits += 8;
            continue;
          }
          ++off;
          acc = (acc << 7) | b;
          nbits += 7;
          prev_ff = false;
        } else {
          ++off;
          acc = (acc << 8) | b;
          nbits += 8;
          prev_ff = (b == 0xFF);
        }
      } else {
        acc <<= 8;
        nbits += 8;
        pad_bits += 8;
      }
    }
  }

  inline uint32_t get(int k) {
    if (k == 0) return 0;
    fill(k);
    nbits -= k;
    return static_cast<uint32_t>((acc >> nbits) & ((1u << k) - 1));
  }

  inline uint32_t get1() {
    fill(1);
    nbits -= 1;
    return static_cast<uint32_t>((acc >> nbits) & 1);
  }

  inline bool overran() const { return nbits < pad_bits; }
};

// Limited-length Golomb-Rice decode (T.87 A.5.3): u zero bits + a 1, then
// u < limit-qbpp-1 ? k LSBs : an escape of qbpp raw bits coding value-1.
// Valid streams never map a value past ~2*RANGE <= 2^17; anything larger
// (only reachable from corrupt bits) is rejected so downstream arithmetic
// stays comfortably inside int32.
inline int32_t jls_golomb_decode(JlsBitReader* br, int k, int limit, int qbpp,
                                 bool* ok) {
  // One 48-bit fill covers the whole code in the common case (unary
  // prefix <= 24 bits, found via count-leading-zeros, plus k <= 16
  // magnitude bits) — no per-bit reads, no second refill.
  br->fill(48);
  int u = 0;
  for (;;) {
    uint32_t window =
        static_cast<uint32_t>((br->acc >> (br->nbits - 24)) & 0xFFFFFF);
    if (window == 0) {
      u += 24;
      br->nbits -= 24;
      br->fill(24);
    } else {
      int lz = __builtin_clz(window) - 8;
      u += lz;
      br->nbits -= lz + 1;  // the zeros plus the terminating 1
      break;
    }
    if (u > limit) {  // corrupt/truncated: the unary run can't be longer
      *ok = false;
      return 0;
    }
  }
  int64_t v;
  if (u < limit - qbpp - 1) {
    v = (static_cast<int64_t>(u) << k) | br->get(k);
  } else if (u == limit - qbpp - 1) {
    v = static_cast<int64_t>(br->get(qbpp)) + 1;
  } else {
    *ok = false;
    return 0;
  }
  if (v > (1 << 18)) {
    *ok = false;
    return 0;
  }
  return static_cast<int32_t>(v);
}

// Smallest k with (n << k) >= a (the Golomb parameter, A.5.1) — the bit-
// length difference is exact or one short, so at most one correction.
inline int jls_k(int64_t n, int64_t a) {
  if (a <= n) return 0;  // also guards clz(0): A can decay to 0 by halving
  int k = __builtin_clzll(static_cast<uint64_t>(n)) -
          __builtin_clzll(static_cast<uint64_t>(a));
  if ((n << k) < a) ++k;
  return k;
}

struct JlsParams {
  int32_t maxval, t1, t2, t3, reset, near_;
  int32_t range, qbpp, bpp, limit;
};

// Gradient quantizer, T.87 A.3.3 (symmetric; sign handled by the caller).
inline int jls_quantize(int32_t d, const JlsParams& pr) {
  if (d <= -pr.t3) return -4;
  if (d <= -pr.t2) return -3;
  if (d <= -pr.t1) return -2;
  if (d < -pr.near_) return -1;
  if (d <= pr.near_) return 0;
  if (d < pr.t1) return 1;
  if (d < pr.t2) return 2;
  if (d < pr.t3) return 3;
  return 4;
}

// Default thresholds, T.87 C.2.4.1.1.1 — including the spec's odd CLAMP_i
// (values above MAXVAL wrap to the LOWER bound, NEAR+i).
inline int32_t jls_clamp_t(int32_t i, int32_t lo, int32_t maxval) {
  return (i > maxval || i < lo) ? lo : i;
}

void jls_default_thresholds(JlsParams* pr) {
  const int32_t mv = pr->maxval, nr = pr->near_;
  if (mv >= 128) {
    int32_t f = ((mv < 4095 ? mv : 4095) + 128) / 256;
    pr->t1 = jls_clamp_t(f + 2 + 3 * nr, nr + 1, mv);
    pr->t2 = jls_clamp_t(4 * f + 3 + 5 * nr, nr + 2, mv);
    pr->t3 = jls_clamp_t(17 * f + 4 + 7 * nr, nr + 3, mv);
  } else {
    int32_t f = 256 / (mv + 1);
    int32_t a = 3 / f + 3 * nr;
    int32_t b = 7 / f + 5 * nr;
    int32_t c = 21 / f + 7 * nr;
    pr->t1 = jls_clamp_t(a > 2 ? a : 2, nr + 1, mv);
    pr->t2 = jls_clamp_t(b > 3 ? b : 3, nr + 2, mv);
    pr->t3 = jls_clamp_t(c > 4 ? c : 4, nr + 3, mv);
  }
}

// Decode the single-component scan that follows SOS (T.87 A.2-A.7).
bool jls_decode_scan(JlsBitReader& br, const JlsParams& pr, uint32_t rows,
                     uint32_t cols, uint8_t* out, uint32_t bps, char* err,
                     size_t err_cap) {
  // Context state: 1..364 regular (index 0 unused — the all-zero gradient
  // is run mode), 365/366 run interruption (A.2.1 init values).  64-bit:
  // an LSE RESET up to 65535 lets A accumulate past int32 before halving.
  int64_t A[367], B[365], N[367], Nn[2] = {0, 0};
  int32_t C[365];
  const int64_t a0 = (pr.range + 32) >> 6;
  for (int i = 0; i < 367; ++i) {
    A[i] = a0 > 2 ? a0 : 2;
    N[i] = 1;
  }
  memset(B, 0, sizeof(B));
  memset(C, 0, sizeof(C));
  int run_index = 0;
  const int32_t q_step = 2 * pr.near_ + 1;
  const int32_t wrap = pr.range * q_step;
  // Gradient-quantizer lookup over the full difference range: one load
  // replaces 9 data-dependent compares (3x per sample; they mispredict
  // heavily on noisy tissue).  <=512 KiB at 16-bit, 32 KiB at 12-bit.
  std::vector<int8_t> qlut_store(2 * pr.maxval + 1);
  int8_t* qlut = qlut_store.data() + pr.maxval;
  for (int32_t d = -pr.maxval; d <= pr.maxval; ++d) {
    qlut[d] = static_cast<int8_t>(jls_quantize(d, pr));
  }

  // prev/cur hold reconstructed samples with a [-1] slot at index 0 and a
  // duplicated final Rb at index cols+1, so Ra/Rb/Rc/Rd are plain loads;
  // the slot chain reproduces the spec's first-column Ra=Rb / Rc rule.
  std::vector<int32_t> prev(cols + 2, 0), cur(cols + 2, 0);

  for (uint32_t yy = 0; yy < rows; ++yy) {
    cur[0] = prev[1];
    prev[cols + 1] = prev[cols];
    uint32_t xx = 0;
    while (xx < cols) {
      const int32_t Ra = cur[xx], Rb = prev[xx + 1], Rc = prev[xx],
                    Rd = prev[xx + 2];
      const int32_t D1 = Rd - Rb, D2 = Rb - Rc, D3 = Rc - Ra;
      const int q1 = qlut[D1], q2 = qlut[D2], q3 = qlut[D3];
      if (q1 == 0 && q2 == 0 && q3 == 0) {
        // ---- Run mode (A.7). Segments of 2^J[run_index] samples of Ra.
        bool interrupted = false;
        while (!interrupted) {
          if (br.overran()) {
            snprintf(err, err_cap, "JPEG-LS entropy data truncated in a run");
            return false;
          }
          if (br.get1()) {
            uint32_t seg = 1u << kJlsJ[run_index];
            uint32_t remaining = cols - xx;
            uint32_t fillc = seg < remaining ? seg : remaining;
            for (uint32_t i = 0; i < fillc; ++i) cur[xx + 1 + i] = Ra;
            xx += fillc;
            if (fillc == seg && run_index < 31) ++run_index;
            if (xx >= cols) break;  // runs end at the line end (A.7.1.2)
          } else {
            interrupted = true;
            int j = kJlsJ[run_index];
            uint32_t r = j ? br.get(j) : 0;
            if (xx + r >= cols) {
              snprintf(err, err_cap,
                       "JPEG-LS run remainder overruns the line");
              return false;
            }
            for (uint32_t i = 0; i < r; ++i) cur[xx + 1 + i] = Ra;
            xx += r;
            // Run interruption sample (A.7.2).
            const int32_t Rb2 = prev[xx + 1];
            const int32_t ad = Ra > Rb2 ? Ra - Rb2 : Rb2 - Ra;
            const int ritype = ad <= pr.near_ ? 1 : 0;
            const int32_t Px = ritype ? Ra : Rb2;
            const int ctx = 365 + ritype;
            int64_t temp = A[ctx] + (ritype ? (N[ctx] >> 1) : 0);
            int k = jls_k(N[ctx], temp);
            bool ok = true;
            const int glimit = pr.limit - kJlsJ[run_index] - 1;
            int32_t em = jls_golomb_decode(&br, k, glimit, pr.qbpp, &ok);
            if (!ok || br.overran()) {
              snprintf(err, err_cap,
                       "JPEG-LS entropy data corrupt at sample (%u,%u)", yy,
                       xx);
              return false;
            }
            // Invert the A.7.2 mapping EM = 2|E| - RItype - map, where
            // map distinguishes the sign given (k, Nn, N).
            const int32_t s = em + ritype;
            const int map = s & 1;
            const int32_t abse = (s + map) >> 1;
            const bool cond = (k == 0) && (2 * Nn[ritype] < N[ctx]);
            int32_t errval;
            if (abse == 0) {
              errval = 0;
            } else if (map == (cond ? 1 : 0)) {
              errval = abse;
            } else {
              errval = -abse;
            }
            if (errval < 0) ++Nn[ritype];
            A[ctx] += (em + 1 - ritype) >> 1;
            if (N[ctx] == pr.reset) {
              A[ctx] >>= 1;
              N[ctx] >>= 1;
              Nn[ritype] >>= 1;
            }
            ++N[ctx];
            int32_t e = errval * q_step;
            int32_t Rx = (ritype == 0 && Ra > Rb2) ? Px - e : Px + e;
            if (Rx < -pr.near_) Rx += wrap;
            else if (Rx > pr.maxval + pr.near_) Rx -= wrap;
            if (Rx < 0) Rx = 0;
            else if (Rx > pr.maxval) Rx = pr.maxval;
            cur[xx + 1] = Rx;
            ++xx;
            if (run_index > 0) --run_index;
          }
        }
        continue;
      }
      // ---- Regular mode (A.4-A.6).
      int q = 81 * q1 + 9 * q2 + q3;
      int sign = 1;
      if (q < 0) {
        sign = -1;
        q = -q;
      }
      // Median edge detector + bias correction (A.4.1-A.4.2).
      int32_t Px;
      const int32_t mn = Ra < Rb ? Ra : Rb, mx = Ra > Rb ? Ra : Rb;
      if (Rc >= mx) Px = mn;
      else if (Rc <= mn) Px = mx;
      else Px = Ra + Rb - Rc;
      Px += sign * C[q];
      if (Px < 0) Px = 0;
      else if (Px > pr.maxval) Px = pr.maxval;
      int k = jls_k(N[q], A[q]);
      bool ok = true;
      int32_t merr = jls_golomb_decode(&br, k, pr.limit, pr.qbpp, &ok);
      if (!ok || br.overran()) {
        snprintf(err, err_cap, "JPEG-LS entropy data corrupt at sample (%u,%u)",
                 yy, xx);
        return false;
      }
      int32_t errval;
      if (pr.near_ == 0 && k == 0 && 2 * B[q] <= -N[q]) {
        // Special mapping (A.5.2, map inverted for k=0 skewed contexts).
        if (merr & 1) errval = (merr - 1) >> 1;
        else errval = -(merr >> 1) - 1;
      } else {
        if (merr & 1) errval = -((merr + 1) >> 1);
        else errval = merr >> 1;
      }
      // Update A/B, halve at RESET, then bias cancellation (A.6).
      B[q] += errval * q_step;
      A[q] += errval < 0 ? -errval : errval;
      if (N[q] == pr.reset) {
        A[q] >>= 1;
        B[q] = B[q] >= 0 ? B[q] >> 1 : -((1 - B[q]) >> 1);
        N[q] >>= 1;
      }
      ++N[q];
      if (B[q] <= -N[q]) {
        B[q] += N[q];
        if (C[q] > -128) --C[q];
        if (B[q] <= -N[q]) B[q] = -N[q] + 1;
      } else if (B[q] > 0) {
        B[q] -= N[q];
        if (C[q] < 127) ++C[q];
        if (B[q] > 0) B[q] = 0;
      }
      if (sign < 0) errval = -errval;
      int32_t Rx = Px + errval * q_step;
      if (Rx < -pr.near_) Rx += wrap;
      else if (Rx > pr.maxval + pr.near_) Rx -= wrap;
      if (Rx < 0) Rx = 0;
      else if (Rx > pr.maxval) Rx = pr.maxval;
      cur[xx + 1] = Rx;
      ++xx;
    }
    uint8_t* row_out = out + static_cast<size_t>(yy) * cols * bps;
    for (uint32_t i = 0; i < cols; ++i) {
      uint32_t v = static_cast<uint32_t>(cur[i + 1]);
      row_out[i * bps] = static_cast<uint8_t>(v & 0xFF);
      if (bps == 2) row_out[i * bps + 1] = static_cast<uint8_t>(v >> 8);
    }
    std::swap(prev, cur);
  }
  if (br.overran()) {
    snprintf(err, err_cap, "JPEG-LS entropy data truncated");
    return false;
  }
  return true;
}

// `require_lossless` is set when the DICOM transfer syntax is
// 1.2.840.10008.1.2.4.80 (JPEG-LS Lossless): PS3.5 A.4.3 requires NEAR=0
// there, so a scan carrying NEAR>0 is a mislabeled lossy file and must be
// rejected by name rather than silently decoded as if it were exact.
bool jpeg_ls_decode(const uint8_t* data, size_t len, uint8_t* out,
                    uint32_t rows, uint32_t cols, uint32_t bps,
                    bool require_lossless, char* err, size_t err_cap) {
  size_t off = 0;
  while (off + 1 < len && !(data[off] == 0xFF && data[off + 1] == 0xD8)) ++off;
  if (off + 1 >= len) {
    snprintf(err, err_cap, "JPEG-LS stream has no SOI marker");
    return false;
  }
  off += 2;

  int precision = 0;
  bool have_sof = false;
  uint32_t ri = 0;
  JlsParams pr{};
  pr.maxval = 0;  // 0 = derive from precision / LSE defaults
  pr.t1 = pr.t2 = pr.t3 = 0;
  pr.reset = 0;

  while (off + 1 < len) {
    if (data[off] != 0xFF) {
      snprintf(err, err_cap, "JPEG-LS marker expected at offset %zu", off);
      return false;
    }
    while (off < len && data[off] == 0xFF) ++off;  // fill bytes
    if (off >= len) break;
    uint8_t m = data[off++];
    if (m == 0xD9) break;  // EOI before SOS: error below
    if (off + 1 >= len) break;
    size_t seg_len = (static_cast<size_t>(data[off]) << 8) | data[off + 1];
    if (seg_len < 2 || off + seg_len > len) {
      snprintf(err, err_cap, "JPEG-LS segment FF%02X overruns the stream", m);
      return false;
    }
    const uint8_t* seg = data + off + 2;
    size_t body = seg_len - 2;
    off += seg_len;

    if (m == 0xF7) {  // SOF55
      if (body < 9) {
        snprintf(err, err_cap, "JPEG-LS SOF55 segment too short");
        return false;
      }
      precision = seg[0];
      uint32_t y = (seg[1] << 8) | seg[2];
      uint32_t x = (seg[3] << 8) | seg[4];
      if (seg[5] != 1) {
        snprintf(err, err_cap,
                 "JPEG-LS with %u components unsupported (grayscale "
                 "mammography expects 1)",
                 seg[5]);
        return false;
      }
      if (y != rows || x != cols) {
        snprintf(err, err_cap,
                 "JPEG-LS frame %ux%u disagrees with Rows/Columns %ux%u", y,
                 x, rows, cols);
        return false;
      }
      if (seg[7] != 0x11) {
        snprintf(err, err_cap, "JPEG-LS subsampling %02X unsupported", seg[7]);
        return false;
      }
      if (precision < 2 || precision > 16 || (precision > 8 && bps < 2)) {
        snprintf(err, err_cap,
                 "JPEG-LS precision %d incompatible with BitsAllocated %u",
                 precision, bps * 8);
        return false;
      }
      have_sof = true;
    } else if (m == 0xF8) {  // LSE: preset parameters
      if (body < 1) {
        snprintf(err, err_cap, "JPEG-LS LSE segment too short");
        return false;
      }
      if (seg[0] == 1) {
        if (body < 11) {
          snprintf(err, err_cap, "JPEG-LS LSE preset segment too short");
          return false;
        }
        auto u16be = [&](size_t i) {
          return static_cast<int32_t>((seg[i] << 8) | seg[i + 1]);
        };
        pr.maxval = u16be(1);  // 0 keeps the default (C.2.4.1.1)
        pr.t1 = u16be(3);
        pr.t2 = u16be(5);
        pr.t3 = u16be(7);
        pr.reset = u16be(9);
      } else {
        snprintf(err, err_cap,
                 "JPEG-LS LSE ID %u unsupported (only preset parameters, "
                 "ID 1)",
                 seg[0]);
        return false;
      }
    } else if (m == 0xDD) {  // DRI
      if (body < 2) {
        snprintf(err, err_cap, "JPEG-LS DRI segment too short");
        return false;
      }
      ri = (seg[0] << 8) | seg[1];
    } else if ((m >= 0xC0 && m <= 0xCF) && m != 0xC8) {
      snprintf(err, err_cap,
               "marker SOF%d inside a JPEG-LS stream (expected SOF55)",
               m - 0xC0);
      return false;
    } else if (m == 0xDA) {  // SOS
      if (!have_sof) {
        snprintf(err, err_cap, "JPEG-LS SOS before SOF55");
        return false;
      }
      if (ri != 0) {
        // Restart-marker re-init semantics are encoder-defined corner
        // territory; refuse loudly (CharLS does the same).
        snprintf(err, err_cap, "JPEG-LS restart intervals unsupported");
        return false;
      }
      if (body < 6 || seg[0] != 1) {
        snprintf(err, err_cap, "JPEG-LS scan must hold exactly 1 component");
        return false;
      }
      if (seg[2] != 0) {  // Tm: full-byte mapping-table selector (C.4.2)
        snprintf(err, err_cap, "JPEG-LS mapping tables unsupported");
        return false;
      }
      pr.near_ = seg[3];
      if (require_lossless && pr.near_ != 0) {
        snprintf(err, err_cap,
                 "JPEG-LS NEAR=%d under the Lossless transfer syntax "
                 "(1.2.840.10008.1.2.4.80 requires NEAR=0; relabel as .81)",
                 pr.near_);
        return false;
      }
      if (seg[4] != 0) {
        snprintf(err, err_cap,
                 "JPEG-LS interleave mode %u unsupported for 1 component",
                 seg[4]);
        return false;
      }
      if ((seg[5] & 0x0F) != 0) {
        snprintf(err, err_cap, "JPEG-LS point transform unsupported");
        return false;
      }
      if (pr.maxval == 0) pr.maxval = (1 << precision) - 1;
      if (pr.maxval < 1 || pr.maxval >= (1 << 16) ||
          (precision <= 8 && bps == 1 && pr.maxval > 255)) {
        snprintf(err, err_cap, "JPEG-LS MAXVAL %d out of range", pr.maxval);
        return false;
      }
      if (pr.near_ > pr.maxval / 2) {
        snprintf(err, err_cap, "JPEG-LS NEAR %d exceeds MAXVAL/2", pr.near_);
        return false;
      }
      if (pr.reset == 0) pr.reset = 64;
      if (pr.reset < 3) {  // C.2.4.1.1: RESET >= 3
        snprintf(err, err_cap, "JPEG-LS RESET %d out of range", pr.reset);
        return false;
      }
      JlsParams defaults = pr;
      jls_default_thresholds(&defaults);
      if (pr.t1 == 0) pr.t1 = defaults.t1;
      if (pr.t2 == 0) pr.t2 = defaults.t2;
      if (pr.t3 == 0) pr.t3 = defaults.t3;
      if (!(pr.near_ < pr.t1 && pr.t1 <= pr.t2 && pr.t2 <= pr.t3 &&
            pr.t3 <= pr.maxval)) {
        snprintf(err, err_cap,
                 "JPEG-LS thresholds T1=%d T2=%d T3=%d invalid for "
                 "MAXVAL=%d NEAR=%d",
                 pr.t1, pr.t2, pr.t3, pr.maxval, pr.near_);
        return false;
      }
      pr.range = (pr.maxval + 2 * pr.near_) / (2 * pr.near_ + 1) + 1;
      pr.qbpp = 1;
      while ((1 << pr.qbpp) < pr.range) ++pr.qbpp;
      pr.bpp = 1;
      while ((1 << pr.bpp) < pr.maxval + 1) ++pr.bpp;
      if (pr.bpp < 2) pr.bpp = 2;
      pr.limit = 2 * (pr.bpp + (pr.bpp > 8 ? pr.bpp : 8));
      JlsBitReader br{data + off, len - off};
      return jls_decode_scan(br, pr, rows, cols, out, bps, err, err_cap);
    }
    // APPn / COM / anything else with a length: skipped.
  }
  snprintf(err, err_cap, have_sof ? "JPEG-LS stream ended before SOS"
                                  : "JPEG-LS stream holds no SOF55 frame");
  return false;
}

// ---------------------------------------------------------------------------
// JPEG 2000 Part 1 (ISO/IEC 15444-1 / ITU-T T.800; DICOM transfer syntax
// 1.2.840.10008.1.2.4.90 "JPEG 2000 Image Compression (Lossless Only)" —
// PS3.5 A.4.4).  The reference reads these through pydicom's handler stack
// (/root/reference/dataset.py:4,93-105,180); this is the pydicom-free
// equivalent.  Scope — what mammography archives actually emit under .90:
// raw codestreams (PS3.5 A.4.4 forbids the JP2 wrapper), grayscale single
// component, no subsampling, reversible 5/3 wavelet with no quantization,
// any decomposition depth, any codeblock/precinct geometry, multiple tiles
// and tile-parts, all five progression orders, multiple layers, SOP/EPH
// resilience markers, and the codeblock styles OpenJPEG/Kakadu use
// (reset-context, vertically-causal, predictable-termination,
// segmentation-symbols).  Refused BY NAME: irreversible 9/7 (that is .91
// territory, which stays refused as a syntax), multi-component/MCT,
// subsampling, arithmetic-bypass and terminate-each-pass codeblock styles,
// POC/PPM/PPT/RGN/COC/QCC marker segments.  Validated by round-tripping
// against OpenJPEG-encoded fixtures (via Pillow) in
// tests/test_dicom_native.py.

// MQ arithmetic decoder (T.800 Annex C, software conventions C.3).  The
// 47-state probability table is Table C.2 verbatim.
struct MqState {
  uint16_t qe;
  uint8_t nmps, nlps, sw;
};
const MqState kMqTab[47] = {
    {0x5601, 1, 1, 1},    {0x3401, 2, 6, 0},    {0x1801, 3, 9, 0},
    {0x0AC1, 4, 12, 0},   {0x0521, 5, 29, 0},   {0x0221, 38, 33, 0},
    {0x5601, 7, 6, 1},    {0x5401, 8, 14, 0},   {0x4801, 9, 14, 0},
    {0x3801, 10, 14, 0},  {0x3001, 11, 17, 0},  {0x2401, 12, 18, 0},
    {0x1C01, 13, 20, 0},  {0x1601, 29, 21, 0},  {0x5601, 15, 14, 1},
    {0x5401, 16, 14, 0},  {0x5101, 17, 15, 0},  {0x4801, 18, 16, 0},
    {0x3801, 19, 17, 0},  {0x3401, 20, 18, 0},  {0x3001, 21, 19, 0},
    {0x2801, 22, 19, 0},  {0x2401, 23, 20, 0},  {0x2201, 24, 21, 0},
    {0x1C01, 25, 22, 0},  {0x1801, 26, 23, 0},  {0x1601, 27, 24, 0},
    {0x1401, 28, 25, 0},  {0x1201, 29, 26, 0},  {0x1101, 30, 27, 0},
    {0x0AC1, 31, 28, 0},  {0x09C1, 32, 29, 0},  {0x08A1, 33, 30, 0},
    {0x0521, 34, 31, 0},  {0x0441, 35, 32, 0},  {0x02A1, 36, 33, 0},
    {0x0221, 37, 34, 0},  {0x0141, 38, 35, 0},  {0x0111, 39, 36, 0},
    {0x0085, 40, 37, 0},  {0x0049, 41, 38, 0},  {0x0025, 42, 39, 0},
    {0x0015, 43, 40, 0},  {0x0009, 44, 41, 0},  {0x0005, 45, 42, 0},
    {0x0001, 45, 43, 0},  {0x5601, 46, 46, 0},
};

// EBCOT context labels (T.800 D.2): 0-8 zero coding, 9-13 sign coding,
// 14-16 magnitude refinement, 17 run-length, 18 uniform.
enum { kCtxRl = 17, kCtxUni = 18, kNumCtx = 19 };

struct MqDec {
  const uint8_t* buf;
  size_t len, bpos;
  uint32_t c, a;
  int ct;
  uint8_t state[kNumCtx];
  uint8_t mps[kNumCtx];

  uint8_t at(size_t i) const { return i < len ? buf[i] : 0xFF; }

  void bytein() {
    if (at(bpos) == 0xFF) {
      if (at(bpos + 1) > 0x8F) {  // marker (or past end): feed 1-bits forever
        c += 0xFF00;
        ct = 8;
      } else {
        ++bpos;
        c += static_cast<uint32_t>(at(bpos)) << 9;
        ct = 7;
      }
    } else {
      ++bpos;
      c += static_cast<uint32_t>(at(bpos)) << 8;
      ct = 8;
    }
  }

  void reset_contexts() {
    memset(state, 0, sizeof(state));
    memset(mps, 0, sizeof(mps));
    state[0] = 4;        // ZC all-zero-neighborhood context
    state[kCtxRl] = 3;   // run-length
    state[kCtxUni] = 46; // uniform
  }

  void init(const uint8_t* d, size_t n) {
    buf = d;
    len = n;
    bpos = 0;
    c = static_cast<uint32_t>(at(0)) << 16;
    bytein();
    c <<= 7;
    ct -= 7;
    a = 0x8000;
    reset_contexts();
  }

  int decode(int cx) {
    const MqState& s = kMqTab[state[cx]];
    const uint32_t qe = s.qe;
    int d;
    a -= qe;
    if ((c >> 16) < qe) {
      if (a < qe) {  // LPS exchange: MPS decision
        d = mps[cx];
        state[cx] = s.nmps;
      } else {
        d = 1 - mps[cx];
        if (s.sw) mps[cx] ^= 1;
        state[cx] = s.nlps;
      }
      a = qe;
      do {
        if (ct == 0) bytein();
        a <<= 1;
        c <<= 1;
        --ct;
      } while (!(a & 0x8000));
    } else {
      c -= qe << 16;
      if (!(a & 0x8000)) {
        if (a < qe) {  // MPS exchange: LPS decision
          d = 1 - mps[cx];
          if (s.sw) mps[cx] ^= 1;
          state[cx] = s.nlps;
        } else {
          d = mps[cx];
          state[cx] = s.nmps;
        }
        do {
          if (ct == 0) bytein();
          a <<= 1;
          c <<= 1;
          --ct;
        } while (!(a & 0x8000));
      } else {
        d = mps[cx];
      }
    }
    return d;
  }
};

// Packet-header bit reader with 0xFF bit-stuffing (T.800 B.10.1): a byte
// following a 0xFF carries only 7 data bits, and its MSB (the stuffed bit)
// must be 0.  Reads MSB-first.  Returns -1 past the end or on a set
// stuffed bit.
struct J2kHdrReader {
  const uint8_t* p;
  size_t n, off;
  int avail = 0;

  J2kHdrReader(const uint8_t* d, size_t len, size_t start)
      : p(d), n(len), off(start) {}

  int bit() {
    if (avail == 0) {
      if (off >= n) return -1;
      const bool after_ff = off > 0 && p[off - 1] == 0xFF;
      const uint8_t b = p[off];
      if (after_ff && (b & 0x80)) return -1;  // stuffed bit must be 0
      ++off;
      avail = after_ff ? 7 : 8;
    }
    --avail;
    return (p[off - 1] >> avail) & 1;
  }

  int bits(int k, uint32_t* out) {
    uint32_t v = 0;
    for (int i = 0; i < k; ++i) {
      int b = bit();
      if (b < 0) return -1;
      v = (v << 1) | static_cast<uint32_t>(b);
    }
    *out = v;
    return 0;
  }

  // Byte-align at end of header; a header may not end on a 0xFF byte, so
  // the encoder appends the stuffed byte, which belongs to the header.
  bool align() {
    avail = 0;
    if (off > 0 && p[off - 1] == 0xFF) {
      if (off >= n) return false;
      ++off;
    }
    return true;
  }
};

// Tag tree (T.800 B.10.2).  Nodes are stored leaves-first, one level after
// another; partial knowledge persists across packets/layers.
struct J2kTagTree {
  struct Node {
    int parent;
    int value, low;
    bool known;
  };
  int w = 0, h = 0;
  std::vector<Node> nodes;

  void build(int w_, int h_) {
    w = w_;
    h = h_;
    nodes.clear();
    if (w <= 0 || h <= 0) return;
    std::vector<std::pair<int, int>> dims;
    int lw = w, lh = h;
    size_t total = 0;
    for (;;) {
      dims.push_back({lw, lh});
      total += static_cast<size_t>(lw) * lh;
      if (lw == 1 && lh == 1) break;
      lw = (lw + 1) / 2;
      lh = (lh + 1) / 2;
    }
    nodes.assign(total, Node{-1, 0, 0, false});
    size_t base = 0;
    for (size_t k = 0; k + 1 < dims.size(); ++k) {
      const int cw = dims[k].first, ch = dims[k].second;
      const size_t pbase = base + static_cast<size_t>(cw) * ch;
      const int pw = dims[k + 1].first;
      for (int j = 0; j < ch; ++j)
        for (int i = 0; i < cw; ++i)
          nodes[base + static_cast<size_t>(j) * cw + i].parent =
              static_cast<int>(pbase + static_cast<size_t>(j / 2) * pw + i / 2);
      base = pbase;
    }
  }

  // Establish whether leaf's value < threshold.  1 = yes (known), 0 = not
  // below threshold (value may still be unknown), -1 = reader error.
  int decode(J2kHdrReader& br, int leaf, int threshold) {
    int path[40];
    int np = 0;
    for (int idx = leaf; idx >= 0; idx = nodes[idx].parent) {
      if (np >= 40) return -1;
      path[np++] = idx;
    }
    int low = 0;
    for (int k = np - 1; k >= 0; --k) {
      Node& nd = nodes[path[k]];
      if (nd.low < low) nd.low = low;
      while (!nd.known && nd.low < threshold) {
        const int b = br.bit();
        if (b < 0) return -1;
        if (b) {
          nd.known = true;
          nd.value = nd.low;
        } else {
          ++nd.low;
        }
      }
      low = nd.known ? nd.value : nd.low;
    }
    return (nodes[leaf].known && nodes[leaf].value < threshold) ? 1 : 0;
  }

  // Decode a leaf's exact value (zero-bitplane trees decode to completion).
  int decode_full(J2kHdrReader& br, int leaf, int* out) {
    int t = 1;
    while (!nodes[leaf].known) {
      if (decode(br, leaf, t) < 0) return -1;
      if (++t > 64) return -1;  // zero-bitplanes can't sanely exceed Mb<=31
    }
    *out = nodes[leaf].value;
    return 0;
  }
};

// Zero-coding context from neighborhood significance counts (Table D.1).
// orient: 0=LL, 1=HL, 2=LH, 3=HH.  h/v/d = significant horizontal /
// vertical / diagonal neighbor counts.
inline int j2k_zc_context(int orient, int h, int v, int d) {
  if (orient == 1) {  // HL: same table as LL/LH with h and v exchanged
    const int t = h;
    h = v;
    v = t;
  }
  if (orient != 3) {  // LL, LH (and swapped HL)
    if (h == 2) return 8;
    if (h == 1) return v >= 1 ? 7 : (d >= 1 ? 6 : 5);
    if (v == 2) return 4;
    if (v == 1) return 3;
    return d >= 2 ? 2 : (d == 1 ? 1 : 0);
  }
  const int hv = h + v;  // HH
  if (d >= 3) return 8;
  if (d == 2) return hv >= 1 ? 7 : 6;
  if (d == 1) return hv >= 2 ? 5 : (hv == 1 ? 4 : 3);
  return hv >= 2 ? 2 : (hv == 1 ? 1 : 0);
}

// Sign-coding context + XOR bit from clamped H/V sign contributions
// (Table D.2).  hc/vc in {-1,0,1}.
inline void j2k_sc_context(int hc, int vc, int* ctx, int* flip) {
  if (hc == 0 && vc == 0) {
    *ctx = 9;
    *flip = 0;
    return;
  }
  int f = 0;
  if (hc < 0 || (hc == 0 && vc < 0)) {  // exploit point symmetry
    hc = -hc;
    vc = -vc;
    f = 1;
  }
  if (hc == 0) *ctx = 10;        // (0,1)
  else if (vc == 1) *ctx = 13;   // (1,1)
  else if (vc == 0) *ctx = 12;   // (1,0)
  else *ctx = 11;                // (1,-1)
  *flip = f;
}

// Per-coefficient Tier-1 state flags, kept in a (w+2)x(h+2) bordered array
// so neighborhood reads need no bounds checks.
enum : uint8_t {
  kT1Sig = 1,     // significant
  kT1Visit = 2,   // coded by this bitplane's significance-propagation pass
  kT1Ref = 4,     // refined at least once
  kT1Neg = 8,     // sign bit (negative)
};

// EBCOT Tier-1 block decoder (T.800 Annex D): decodes `numpasses` coding
// passes from one MQ codeword segment into signed coefficients.  `mb` is
// the band's maximum bitplane count, `zbp` the signalled missing MSBs.
// Styles: bit1 reset-context, bit3 vertically-causal, bit5 segmentation
// symbols (bit4 predictable-termination needs no decoder action; bit0
// bypass and bit2 term-all were refused at parse time).
bool j2k_t1_decode(const uint8_t* data, size_t dlen, int w, int h, int orient,
                   int mb, int zbp, int numpasses, uint8_t cb_style,
                   int32_t* out, char* err, size_t err_cap) {
  if (w <= 0 || h <= 0) return true;
  const bool causal = (cb_style & 0x08) != 0;
  const bool segsym = (cb_style & 0x20) != 0;
  const bool reset_ctx = (cb_style & 0x02) != 0;
  const int fs = w + 2;  // bordered stride
  std::vector<uint8_t> flags(static_cast<size_t>(fs) * (h + 2), 0);
  std::vector<uint32_t> mag(static_cast<size_t>(w) * h, 0);

  MqDec mq;
  mq.init(data, dlen);

  auto fidx = [fs](int x, int y) { return static_cast<size_t>(y + 1) * fs + (x + 1); };
  auto sig = [&](size_t p) -> int { return flags[p] & kT1Sig ? 1 : 0; };
  // Neighborhood significance counts; `cut` masks the row below (vertical
  // causal mode at a stripe's last row).
  auto hvd = [&](size_t p, bool cut, int* hh, int* vv, int* dd) {
    *hh = sig(p - 1) + sig(p + 1);
    *vv = sig(p - fs) + (cut ? 0 : sig(p + fs));
    *dd = sig(p - fs - 1) + sig(p - fs + 1) +
          (cut ? 0 : sig(p + fs - 1) + sig(p + fs + 1));
  };
  auto sign_contrib = [&](size_t p) -> int {  // +1 pos-sig, -1 neg-sig, 0
    if (!(flags[p] & kT1Sig)) return 0;
    return (flags[p] & kT1Neg) ? -1 : 1;
  };
  auto decode_sign = [&](size_t p, bool cut) {
    int hc = sign_contrib(p - 1) + sign_contrib(p + 1);
    int vc = sign_contrib(p - fs) + (cut ? 0 : sign_contrib(p + fs));
    hc = hc < -1 ? -1 : (hc > 1 ? 1 : hc);
    vc = vc < -1 ? -1 : (vc > 1 ? 1 : vc);
    int ctx, flip;
    j2k_sc_context(hc, vc, &ctx, &flip);
    if (mq.decode(ctx) ^ flip) flags[p] |= kT1Neg;
    flags[p] |= kT1Sig;
  };

  int bp = mb - 1 - zbp;
  int pass_type = 2;  // first pass of the first coded bitplane is cleanup
  if (numpasses > 0 && bp < 0) {
    snprintf(err, err_cap, "J2K codeblock: %d passes but no bitplanes", numpasses);
    return false;
  }
  if (bp > 30) {
    snprintf(err, err_cap, "J2K codeblock bitplane %d exceeds 31-bit budget", bp);
    return false;
  }

  for (int pass = 0; pass < numpasses; ++pass) {
    if (bp < 0) {
      snprintf(err, err_cap, "J2K codeblock: more passes than bitplanes");
      return false;
    }
    const uint32_t bit = 1u << bp;
    if (pass_type == 0) {  // significance propagation (D.3.1)
      for (int y0 = 0; y0 < h; y0 += 4) {
        const int ylim = y0 + 4 < h ? y0 + 4 : h;
        for (int x = 0; x < w; ++x) {
          for (int y = y0; y < ylim; ++y) {
            const size_t p = fidx(x, y);
            if (flags[p] & kT1Sig) continue;
            const bool cut = causal && (y & 3) == 3;
            int hn, vn, dn;
            hvd(p, cut, &hn, &vn, &dn);
            if (hn + vn + dn == 0) continue;  // not in this pass
            flags[p] |= kT1Visit;
            if (mq.decode(j2k_zc_context(orient, hn, vn, dn))) {
              decode_sign(p, cut);
              mag[static_cast<size_t>(y) * w + x] |= bit;
            }
          }
        }
      }
    } else if (pass_type == 1) {  // magnitude refinement (D.3.3)
      for (int y0 = 0; y0 < h; y0 += 4) {
        const int ylim = y0 + 4 < h ? y0 + 4 : h;
        for (int x = 0; x < w; ++x) {
          for (int y = y0; y < ylim; ++y) {
            const size_t p = fidx(x, y);
            if (!(flags[p] & kT1Sig) || (flags[p] & kT1Visit)) continue;
            int ctx;
            if (flags[p] & kT1Ref) {
              ctx = 16;
            } else {
              const bool cut = causal && (y & 3) == 3;
              int hn, vn, dn;
              hvd(p, cut, &hn, &vn, &dn);
              ctx = hn + vn + dn > 0 ? 15 : 14;
            }
            if (mq.decode(ctx)) mag[static_cast<size_t>(y) * w + x] |= bit;
            flags[p] |= kT1Ref;
          }
        }
      }
    } else {  // cleanup (D.3.4)
      for (int y0 = 0; y0 < h; y0 += 4) {
        const int ylim = y0 + 4 < h ? y0 + 4 : h;
        for (int x = 0; x < w; ++x) {
          int y = y0;
          if (y0 + 4 <= h) {  // full stripe column: run-length eligible?
            bool rl = true;
            for (int k = 0; k < 4 && rl; ++k) {
              const size_t p = fidx(x, y0 + k);
              if (flags[p] & (kT1Sig | kT1Visit)) {
                rl = false;
                break;
              }
              const bool cut = causal && k == 3;
              int hn, vn, dn;
              hvd(p, cut, &hn, &vn, &dn);
              if (hn + vn + dn != 0) rl = false;
            }
            if (rl) {
              if (!mq.decode(kCtxRl)) continue;  // all four stay zero
              const int r = (mq.decode(kCtxUni) << 1) | mq.decode(kCtxUni);
              y = y0 + r;
              const size_t p = fidx(x, y);
              mag[static_cast<size_t>(y) * w + x] |= bit;
              decode_sign(p, causal && (y & 3) == 3);
              ++y;  // samples below the first significant one: normal mode
            }
          }
          for (; y < ylim; ++y) {
            const size_t p = fidx(x, y);
            if (flags[p] & (kT1Sig | kT1Visit)) continue;
            const bool cut = causal && (y & 3) == 3;
            int hn, vn, dn;
            hvd(p, cut, &hn, &vn, &dn);
            if (mq.decode(j2k_zc_context(orient, hn, vn, dn))) {
              decode_sign(p, cut);
              mag[static_cast<size_t>(y) * w + x] |= bit;
            }
          }
        }
      }
      if (segsym) {  // four UNIFORM bits spelling 0xA (D.3.4)
        int v = 0;
        for (int k = 0; k < 4; ++k) v = (v << 1) | mq.decode(kCtxUni);
        if (v != 0xA) {
          snprintf(err, err_cap, "J2K segmentation symbol %X != A", v);
          return false;
        }
      }
    }
    if (pass_type == 2) {  // end of a bitplane: clear SPP-visited marks
      for (auto& f : flags) f = static_cast<uint8_t>(f & ~kT1Visit);
      --bp;
      pass_type = 0;
    } else {
      ++pass_type;
    }
    if (reset_ctx) mq.reset_contexts();
  }

  for (int y = 0; y < h; ++y) {
    for (int x = 0; x < w; ++x) {
      const size_t i = static_cast<size_t>(y) * w + x;
      const int32_t m = static_cast<int32_t>(mag[i]);
      out[i] = (flags[fidx(x, y)] & kT1Neg) ? -m : m;
    }
  }
  return true;
}

// --- codestream geometry (T.800 B.3-B.7) -----------------------------------

inline int64_t j2k_ceil_div(int64_t a, int64_t b) {
  return a >= 0 ? (a + b - 1) / b : -((-a) / b);
}

struct J2kCodeBlock {
  uint32_t x0, y0, x1, y1;  // absolute band coordinates
  uint32_t numpasses = 0;
  int lblock = 3;
  int zbp = 0;
  bool included = false;
  std::vector<uint8_t> data;
};

struct J2kPrecBand {
  int gx0 = 0, gy0 = 0, gw = 0, gh = 0;  // cb-grid range within the precinct
  J2kTagTree incl, zbps;
};

struct J2kPrecinct {
  J2kPrecBand pb[3];
};

struct J2kBand {
  int orient = 0;                   // 0 LL, 1 HL, 2 LH, 3 HH
  uint32_t x0 = 0, y0 = 0, x1 = 0, y1 = 0;  // absolute band coordinates
  int mb = 0;
  uint32_t cbw = 1, cbh = 1;        // codeblock nominal dims (precinct-clamped)
  int64_t g_x0 = 0, g_y0 = 0;       // global codeblock grid origin (indices)
  int g_w = 0, g_h = 0;
  std::vector<J2kCodeBlock> cbs;    // g_w * g_h, raster order
};

struct J2kRes {
  uint32_t x0 = 0, y0 = 0, x1 = 0, y1 = 0;  // resolution coordinates
  int ppx = 15, ppy = 15;
  int npw = 0, nph = 0;
  int nbands = 0;
  J2kBand bands[3];
  std::vector<J2kPrecinct> precincts;  // npw * nph, raster order
};

struct J2kTile {
  uint32_t x0, y0, x1, y1;    // tile rect on the reference grid
  std::vector<uint8_t> data;  // concatenated tile-part bitstreams
  std::vector<J2kRes> res;
};

struct J2kParams {
  uint32_t xsiz = 0, ysiz = 0, xosiz = 0, yosiz = 0;
  uint32_t xtsiz = 0, ytsiz = 0, xtosiz = 0, ytosiz = 0;
  int depth = 0;
  int nl = 0;
  int xcb = 6, ycb = 6;  // codeblock exponents
  uint8_t cb_style = 0;
  int prog = 0;   // 0 LRCP, 1 RLCP, 2 RPCL, 3 PCRL, 4 CPRL
  int layers = 1;
  int guard = 2;
  std::vector<int> band_eps;        // QCD exponents in signalled order
  std::vector<uint8_t> prec_sizes;  // per-resolution PPx | PPy<<4
  bool user_precincts = false;
  bool sop = false, eph = false;
};

bool j2k_build_tile(const J2kParams& P, J2kTile* t, char* err, size_t err_cap) {
  const int NL = P.nl;
  if (static_cast<int>(P.band_eps.size()) < 3 * NL + 1) {
    snprintf(err, err_cap, "J2K QCD signals %d subband exponents, need %d",
             static_cast<int>(P.band_eps.size()), 3 * NL + 1);
    return false;
  }
  t->res.resize(NL + 1);
  for (int r = 0; r <= NL; ++r) {
    J2kRes& R = t->res[r];
    const int64_t den = 1ll << (NL - r);
    R.x0 = static_cast<uint32_t>(j2k_ceil_div(t->x0, den));
    R.y0 = static_cast<uint32_t>(j2k_ceil_div(t->y0, den));
    R.x1 = static_cast<uint32_t>(j2k_ceil_div(t->x1, den));
    R.y1 = static_cast<uint32_t>(j2k_ceil_div(t->y1, den));
    if (P.user_precincts) {
      if (r >= static_cast<int>(P.prec_sizes.size())) {
        snprintf(err, err_cap, "J2K COD precinct list shorter than NL+1");
        return false;
      }
      R.ppx = P.prec_sizes[r] & 0x0F;
      R.ppy = P.prec_sizes[r] >> 4;
      if (r > 0 && (R.ppx == 0 || R.ppy == 0)) {
        snprintf(err, err_cap,
                 "J2K precinct exponent 0 only legal at resolution 0");
        return false;
      }
    }
    R.npw = R.x1 > R.x0
                ? static_cast<int>(((R.x1 - 1) >> R.ppx) - (R.x0 >> R.ppx) + 1)
                : 0;
    R.nph = R.y1 > R.y0
                ? static_cast<int>(((R.y1 - 1) >> R.ppy) - (R.y0 >> R.ppy) + 1)
                : 0;

    // Bands and their Mb (reversible, no quantization: Mb = G + eps - 1,
    // T.800 E.1.1); QCD order is LL then HL,LH,HH per level (ascending r).
    const int cbx = P.xcb < (r == 0 ? R.ppx : R.ppx - 1)
                        ? P.xcb
                        : (r == 0 ? R.ppx : R.ppx - 1);
    const int cby = P.ycb < (r == 0 ? R.ppy : R.ppy - 1)
                        ? P.ycb
                        : (r == 0 ? R.ppy : R.ppy - 1);
    R.nbands = r == 0 ? 1 : 3;
    for (int bi = 0; bi < R.nbands; ++bi) {
      J2kBand& B = R.bands[bi];
      int xob, yob;
      if (r == 0) {
        B.orient = 0;
        xob = yob = 0;
        B.x0 = R.x0;
        B.y0 = R.y0;
        B.x1 = R.x1;
        B.y1 = R.y1;
        B.mb = P.guard + P.band_eps[0] - 1;
      } else {
        B.orient = bi + 1;  // HL, LH, HH
        xob = bi == 1 ? 0 : 1;
        yob = bi == 0 ? 0 : 1;
        B.x0 = static_cast<uint32_t>(
            j2k_ceil_div(static_cast<int64_t>(R.x0) - xob, 2));
        B.y0 = static_cast<uint32_t>(
            j2k_ceil_div(static_cast<int64_t>(R.y0) - yob, 2));
        B.x1 = static_cast<uint32_t>(
            j2k_ceil_div(static_cast<int64_t>(R.x1) - xob, 2));
        B.y1 = static_cast<uint32_t>(
            j2k_ceil_div(static_cast<int64_t>(R.y1) - yob, 2));
        B.mb = P.guard + P.band_eps[3 * (r - 1) + 1 + bi] - 1;
      }
      if (B.mb < 1 || B.mb > 31) {
        snprintf(err, err_cap, "J2K band Mb=%d outside [1,31]", B.mb);
        return false;
      }
      B.cbw = 1u << cbx;
      B.cbh = 1u << cby;
      if (B.x1 > B.x0 && B.y1 > B.y0) {
        B.g_x0 = B.x0 / B.cbw;
        B.g_y0 = B.y0 / B.cbh;
        B.g_w = static_cast<int>(j2k_ceil_div(B.x1, B.cbw) - B.g_x0);
        B.g_h = static_cast<int>(j2k_ceil_div(B.y1, B.cbh) - B.g_y0);
      } else {
        B.g_w = B.g_h = 0;
      }
      B.cbs.assign(static_cast<size_t>(B.g_w) * B.g_h, J2kCodeBlock{});
      for (int gj = 0; gj < B.g_h; ++gj) {
        for (int gi = 0; gi < B.g_w; ++gi) {
          J2kCodeBlock& cb = B.cbs[static_cast<size_t>(gj) * B.g_w + gi];
          const uint64_t cx0 = static_cast<uint64_t>(B.g_x0 + gi) * B.cbw;
          const uint64_t cy0 = static_cast<uint64_t>(B.g_y0 + gj) * B.cbh;
          cb.x0 = static_cast<uint32_t>(cx0 > B.x0 ? cx0 : B.x0);
          cb.y0 = static_cast<uint32_t>(cy0 > B.y0 ? cy0 : B.y0);
          cb.x1 = static_cast<uint32_t>(
              cx0 + B.cbw < B.x1 ? cx0 + B.cbw : B.x1);
          cb.y1 = static_cast<uint32_t>(
              cy0 + B.cbh < B.y1 ? cy0 + B.cbh : B.y1);
        }
      }
    }

    // Precincts: rect in resolution coords, mapped per band to a codeblock
    // grid range; inclusion / zero-bitplane tag trees are per (precinct,
    // band) and persist across layers.
    R.precincts.assign(static_cast<size_t>(R.npw) * R.nph, J2kPrecinct{});
    for (int pj = 0; pj < R.nph; ++pj) {
      for (int pi = 0; pi < R.npw; ++pi) {
        J2kPrecinct& PR = R.precincts[static_cast<size_t>(pj) * R.npw + pi];
        const uint64_t pcx = (R.x0 >> R.ppx) + pi;
        const uint64_t pcy = (R.y0 >> R.ppy) + pj;
        const uint64_t px0v = pcx << R.ppx, py0v = pcy << R.ppy;
        const uint32_t px0 = static_cast<uint32_t>(px0v > R.x0 ? px0v : R.x0);
        const uint32_t py0 = static_cast<uint32_t>(py0v > R.y0 ? py0v : R.y0);
        const uint64_t px1v = px0v + (1ull << R.ppx);
        const uint64_t py1v = py0v + (1ull << R.ppy);
        const uint32_t px1 = static_cast<uint32_t>(px1v < R.x1 ? px1v : R.x1);
        const uint32_t py1 = static_cast<uint32_t>(py1v < R.y1 ? py1v : R.y1);
        for (int bi = 0; bi < R.nbands; ++bi) {
          const J2kBand& B = R.bands[bi];
          J2kPrecBand& PB = PR.pb[bi];
          int64_t bx0, by0, bx1, by1;
          if (r == 0) {
            bx0 = px0;
            by0 = py0;
            bx1 = px1;
            by1 = py1;
          } else {
            const int xob = bi == 1 ? 0 : 1;
            const int yob = bi == 0 ? 0 : 1;
            bx0 = j2k_ceil_div(static_cast<int64_t>(px0) - xob, 2);
            by0 = j2k_ceil_div(static_cast<int64_t>(py0) - yob, 2);
            bx1 = j2k_ceil_div(static_cast<int64_t>(px1) - xob, 2);
            by1 = j2k_ceil_div(static_cast<int64_t>(py1) - yob, 2);
          }
          if (bx0 < B.x0) bx0 = B.x0;
          if (by0 < B.y0) by0 = B.y0;
          if (bx1 > B.x1) bx1 = B.x1;
          if (by1 > B.y1) by1 = B.y1;
          if (bx1 > bx0 && by1 > by0) {
            PB.gx0 = static_cast<int>(bx0 / B.cbw);
            PB.gy0 = static_cast<int>(by0 / B.cbh);
            PB.gw = static_cast<int>(j2k_ceil_div(bx1, B.cbw) - PB.gx0);
            PB.gh = static_cast<int>(j2k_ceil_div(by1, B.cbh) - PB.gy0);
          } else {
            PB.gw = PB.gh = 0;
          }
          PB.incl.build(PB.gw, PB.gh);
          PB.zbps.build(PB.gw, PB.gh);
        }
      }
    }
  }
  return true;
}

// Packet iteration order (T.800 B.12).  One component, so CPRL == PCRL.
struct J2kPktRef {
  uint64_t k0, k1, k2, k3;  // sort key, lexicographic
  int l, r, p;
};

void j2k_packet_order(const J2kParams& P, const J2kTile& t,
                      std::vector<J2kPktRef>* order) {
  order->clear();
  const int NL = P.nl;
  for (int r = 0; r <= NL; ++r) {
    const J2kRes& R = t.res[r];
    for (int p = 0; p < R.npw * R.nph; ++p) {
      const int pi = p % R.npw, pj = p / R.npw;
      // Precinct origin projected to the reference grid; the first
      // precinct row/col triggers at the tile origin (B.12.1.3).
      uint64_t xr = (((static_cast<uint64_t>(R.x0) >> R.ppx) + pi) << R.ppx)
                    << (NL - r);
      uint64_t yr = (((static_cast<uint64_t>(R.y0) >> R.ppy) + pj) << R.ppy)
                    << (NL - r);
      if (xr < t.x0) xr = t.x0;
      if (yr < t.y0) yr = t.y0;
      for (int l = 0; l < P.layers; ++l) {
        J2kPktRef ref;
        ref.l = l;
        ref.r = r;
        ref.p = p;
        const uint64_t ul = static_cast<uint64_t>(l);
        const uint64_t ur = static_cast<uint64_t>(r);
        const uint64_t up = static_cast<uint64_t>(p);
        switch (P.prog) {
          case 0: ref.k0 = ul; ref.k1 = ur; ref.k2 = up; ref.k3 = 0; break;
          case 1: ref.k0 = ur; ref.k1 = ul; ref.k2 = up; ref.k3 = 0; break;
          case 2: ref.k0 = ur; ref.k1 = yr; ref.k2 = xr; ref.k3 = ul; break;
          default: ref.k0 = yr; ref.k1 = xr; ref.k2 = ur; ref.k3 = ul; break;
        }
        order->push_back(ref);
      }
    }
  }
  std::stable_sort(order->begin(), order->end(),
                   [](const J2kPktRef& a, const J2kPktRef& b) {
                     if (a.k0 != b.k0) return a.k0 < b.k0;
                     if (a.k1 != b.k1) return a.k1 < b.k1;
                     if (a.k2 != b.k2) return a.k2 < b.k2;
                     return a.k3 < b.k3;
                   });
}

// Parse every packet of a tile's bitstream, accumulating per-codeblock
// codeword segments and pass counts (T.800 B.10).
bool j2k_read_packets(const J2kParams& P, J2kTile& t, char* err,
                      size_t err_cap) {
  std::vector<J2kPktRef> order;
  j2k_packet_order(P, t, &order);
  const uint8_t* d = t.data.data();
  const size_t n = t.data.size();
  size_t pos = 0;
  struct Seg {
    J2kCodeBlock* cb;
    uint32_t newpasses, nbytes;
  };
  std::vector<Seg> segs;
  for (const J2kPktRef& pk : order) {
    J2kRes& R = t.res[pk.r];
    J2kPrecinct& PR = R.precincts[pk.p];
    if (P.sop) {  // optional per-packet SOP marker segment (6 bytes)
      if (pos + 2 <= n && d[pos] == 0xFF && d[pos + 1] == 0x91) {
        if (pos + 6 > n) {
          snprintf(err, err_cap, "J2K truncated SOP marker");
          return false;
        }
        pos += 6;
      }
    }
    J2kHdrReader br(d, n, pos);
    const int nonzero = br.bit();
    if (nonzero < 0) {
      snprintf(err, err_cap, "J2K packet header truncated (layer %d res %d)",
               pk.l, pk.r);
      return false;
    }
    segs.clear();
    if (nonzero) {
      for (int bi = 0; bi < R.nbands; ++bi) {
        J2kBand& B = R.bands[bi];
        J2kPrecBand& PB = PR.pb[bi];
        for (int gj = 0; gj < PB.gh; ++gj) {
          for (int gi = 0; gi < PB.gw; ++gi) {
            const int leaf = gj * PB.gw + gi;
            const size_t cbi =
                static_cast<size_t>(PB.gy0 + gj - B.g_y0) * B.g_w +
                (PB.gx0 + gi - B.g_x0);
            J2kCodeBlock& cb = B.cbs[cbi];
            bool inc;
            if (!cb.included) {
              const int rr = PB.incl.decode(br, leaf, pk.l + 1);
              if (rr < 0) {
                snprintf(err, err_cap, "J2K inclusion tag tree truncated");
                return false;
              }
              inc = rr == 1;
            } else {
              const int b = br.bit();
              if (b < 0) {
                snprintf(err, err_cap, "J2K packet header truncated");
                return false;
              }
              inc = b != 0;
            }
            if (!inc) continue;
            if (!cb.included) {
              if (PB.zbps.decode_full(br, leaf, &cb.zbp) < 0) {
                snprintf(err, err_cap, "J2K zero-bitplane tag tree invalid");
                return false;
              }
              cb.included = true;
            }
            // New coding passes (Table B.4).
            uint32_t np;
            int b = br.bit();
            if (b == 0) {
              np = 1;
            } else if (b > 0 && (b = br.bit()) == 0) {
              np = 2;
            } else if (b > 0) {
              uint32_t v;
              if (br.bits(2, &v) < 0) b = -1;
              else if (v < 3) np = 3 + v;
              else if (br.bits(5, &v) < 0) b = -1;
              else if (v < 31) np = 6 + v;
              else if (br.bits(7, &v) < 0) b = -1;
              else np = 37 + v;
            }
            if (b < 0) {
              snprintf(err, err_cap, "J2K pass-count code truncated");
              return false;
            }
            // Lblock update (unary) then the segment length.
            while ((b = br.bit()) == 1) {
              if (++cb.lblock > 24) {
                snprintf(err, err_cap, "J2K Lblock overflow");
                return false;
              }
            }
            if (b < 0) {
              snprintf(err, err_cap, "J2K Lblock code truncated");
              return false;
            }
            int lg = 0;
            while ((np >> lg) > 1) ++lg;
            const int nbits = cb.lblock + lg;
            if (nbits > 28) {
              snprintf(err, err_cap, "J2K segment length field %d bits", nbits);
              return false;
            }
            uint32_t nbytes;
            if (br.bits(nbits, &nbytes) < 0) {
              snprintf(err, err_cap, "J2K segment length truncated");
              return false;
            }
            cb.numpasses += np;
            if (cb.numpasses > 3u * 31 - 2) {
              snprintf(err, err_cap, "J2K codeblock pass count %u too large",
                       cb.numpasses);
              return false;
            }
            segs.push_back(Seg{&cb, np, nbytes});
          }
        }
      }
    }
    if (!br.align()) {
      snprintf(err, err_cap, "J2K packet header ends on stuffed byte");
      return false;
    }
    pos = br.off;
    if (P.eph) {
      if (pos + 2 > n || d[pos] != 0xFF || d[pos + 1] != 0x92) {
        snprintf(err, err_cap, "J2K missing EPH marker");
        return false;
      }
      pos += 2;
    }
    for (const Seg& s : segs) {
      if (s.nbytes > n - pos) {
        snprintf(err, err_cap, "J2K packet body truncated (%u bytes short)",
                 s.nbytes);
        return false;
      }
      s.cb->data.insert(s.cb->data.end(), d + pos, d + pos + s.nbytes);
      pos += s.nbytes;
    }
  }
  return true;
}

// Reversible 5/3 1-D synthesis (T.800 F.3.6-F.3.8, equation 5-3 lifting)
// over the absolute index range [i0, i1); `y` is the interleaved input,
// `x` the output, both indexed relative to i0.  Whole-sample symmetric
// extension at the boundaries.
void j2k_sr_1d(const int32_t* y, int32_t* x, int64_t i0, int64_t i1) {
  const int64_t len = i1 - i0;
  if (len == 1) {
    x[0] = (i0 & 1) ? y[0] / 2 : y[0];
    return;
  }
  auto Y = [&](int64_t i) -> int64_t {
    while (i < i0 || i >= i1) {
      if (i < i0) i = 2 * i0 - i;
      if (i >= i1) i = 2 * (i1 - 1) - i;
    }
    return y[i - i0];
  };
  // Even (lowpass) samples over an extended range so every odd sample in
  // [i0, i1) sees both even neighbors.
  const int64_t evlo = (i0 - 1) - (((i0 - 1) % 2 + 2) % 2);
  const int64_t evhi = i1 - (i1 & 1);
  std::vector<int64_t> xe(static_cast<size_t>((evhi - evlo) / 2 + 1));
  for (int64_t u = evlo; u <= evhi; u += 2) {
    xe[static_cast<size_t>((u - evlo) / 2)] =
        Y(u) - ((Y(u - 1) + Y(u + 1) + 2) >> 2);
  }
  for (int64_t u = i0; u < i1; ++u) {
    if ((u & 1) == 0) {
      x[u - i0] = static_cast<int32_t>(xe[static_cast<size_t>((u - evlo) / 2)]);
    } else {
      const int64_t a = xe[static_cast<size_t>((u - 1 - evlo) / 2)];
      const int64_t b = xe[static_cast<size_t>((u + 1 - evlo) / 2)];
      x[u - i0] = static_cast<int32_t>(Y(u) + ((a + b) >> 1));
    }
  }
}

// One inverse-DWT composition step (T.800 F.3.2 2D_SR): interleave the
// previous resolution's samples (as LL) with this resolution's HL/LH/HH
// bands, then synthesize rows and columns.
void j2k_idwt_step(const std::vector<int32_t>& ll, const J2kRes& prev,
                   const J2kRes& R, const std::vector<int32_t> band_buf[3],
                   std::vector<int32_t>* out) {
  const int64_t w = static_cast<int64_t>(R.x1) - R.x0;
  const int64_t h = static_cast<int64_t>(R.y1) - R.y0;
  std::vector<int32_t>& a = *out;
  a.assign(static_cast<size_t>(w * h), 0);
  auto place = [&](const std::vector<int32_t>& src, uint32_t bx0, uint32_t by0,
                   uint32_t bx1, uint32_t by1, int xob, int yob) {
    const int64_t bw = static_cast<int64_t>(bx1) - bx0;
    for (uint32_t by = by0; by < by1; ++by) {
      const int64_t v = 2ll * by + yob - R.y0;
      for (uint32_t bx = bx0; bx < bx1; ++bx) {
        const int64_t u = 2ll * bx + xob - R.x0;
        a[static_cast<size_t>(v * w + u)] =
            src[static_cast<size_t>((by - by0) * bw + (bx - bx0))];
      }
    }
  };
  place(ll, prev.x0, prev.y0, prev.x1, prev.y1, 0, 0);
  const J2kBand* bands = R.bands;
  place(band_buf[0], bands[0].x0, bands[0].y0, bands[0].x1, bands[0].y1, 1, 0);
  place(band_buf[1], bands[1].x0, bands[1].y0, bands[1].x1, bands[1].y1, 0, 1);
  place(band_buf[2], bands[2].x0, bands[2].y0, bands[2].x1, bands[2].y1, 1, 1);
  // Rows, then columns.
  std::vector<int32_t> tmp_in(static_cast<size_t>(w > h ? w : h));
  std::vector<int32_t> tmp_out(static_cast<size_t>(w > h ? w : h));
  for (int64_t v = 0; v < h; ++v) {
    memcpy(tmp_in.data(), &a[static_cast<size_t>(v * w)], w * sizeof(int32_t));
    j2k_sr_1d(tmp_in.data(), tmp_out.data(), R.x0, R.x1);
    memcpy(&a[static_cast<size_t>(v * w)], tmp_out.data(), w * sizeof(int32_t));
  }
  for (int64_t u = 0; u < w; ++u) {
    for (int64_t v = 0; v < h; ++v) tmp_in[v] = a[static_cast<size_t>(v * w + u)];
    j2k_sr_1d(tmp_in.data(), tmp_out.data(), R.y0, R.y1);
    for (int64_t v = 0; v < h; ++v) a[static_cast<size_t>(v * w + u)] = tmp_out[v];
  }
}

// Tier-1-decode every codeblock of a tile and run the inverse wavelet;
// result is the tile's samples (pre-DC-shift) over [x0,x1)x[y0,y1).
bool j2k_decode_tile(const J2kParams& P, J2kTile& t, std::vector<int32_t>* img,
                     char* err, size_t err_cap) {
  std::vector<int32_t> ll;
  std::vector<int32_t> band_buf[3];
  for (int r = 0; r <= P.nl; ++r) {
    J2kRes& R = t.res[r];
    const int first = r == 0 ? 0 : 0;
    (void)first;
    for (int bi = 0; bi < R.nbands; ++bi) {
      J2kBand& B = R.bands[bi];
      const int64_t bw = static_cast<int64_t>(B.x1) - B.x0;
      const int64_t bh = static_cast<int64_t>(B.y1) - B.y0;
      std::vector<int32_t>& buf = r == 0 ? ll : band_buf[bi];
      buf.assign(static_cast<size_t>(bw > 0 && bh > 0 ? bw * bh : 0), 0);
      for (J2kCodeBlock& cb : B.cbs) {
        if (cb.numpasses == 0) continue;
        const int cw = static_cast<int>(cb.x1 - cb.x0);
        const int ch = static_cast<int>(cb.y1 - cb.y0);
        std::vector<int32_t> coef(static_cast<size_t>(cw) * ch);
        if (!j2k_t1_decode(cb.data.data(), cb.data.size(), cw, ch, B.orient,
                           B.mb, cb.zbp, static_cast<int>(cb.numpasses),
                           P.cb_style, coef.data(), err, err_cap)) {
          return false;
        }
        for (int yy = 0; yy < ch; ++yy) {
          memcpy(&buf[static_cast<size_t>(cb.y0 - B.y0 + yy) * bw +
                      (cb.x0 - B.x0)],
                 &coef[static_cast<size_t>(yy) * cw], cw * sizeof(int32_t));
        }
        cb.data.clear();
        cb.data.shrink_to_fit();
      }
    }
    if (r > 0) {
      std::vector<int32_t> next;
      j2k_idwt_step(ll, t.res[r - 1], R, band_buf, &next);
      ll.swap(next);
    }
  }
  img->swap(ll);
  return true;
}

// Top-level JPEG 2000 codestream decode (raw J2C, as DICOM encapsulates).
bool jpeg2000_decode(const uint8_t* data, size_t len, uint8_t* out,
                     uint32_t rows, uint32_t cols, uint32_t bps, char* err,
                     size_t err_cap) {
  size_t off = 0;
  auto u16 = [&](size_t i) -> uint32_t {
    return (static_cast<uint32_t>(data[i]) << 8) | data[i + 1];
  };
  auto u32 = [&](size_t i) -> uint32_t {
    return (static_cast<uint32_t>(data[i]) << 24) |
           (static_cast<uint32_t>(data[i + 1]) << 16) |
           (static_cast<uint32_t>(data[i + 2]) << 8) | data[i + 3];
  };
  // PS3.5 A.4.4 mandates a raw codestream, but real-world archives do
  // encapsulate JP2-wrapped files (pydicom tolerates them via OpenJPEG's
  // signature sniffing).  If the fragment starts with the JP2 signature
  // box, walk the ISO box structure to the 'jp2c' contiguous-codestream
  // box and decode from there.
  static const uint8_t kJp2Sig[12] = {0x00, 0x00, 0x00, 0x0C, 0x6A, 0x50,
                                      0x20, 0x20, 0x0D, 0x0A, 0x87, 0x0A};
  if (len >= 12 && memcmp(data, kJp2Sig, 12) == 0) {
    size_t boff = 12;
    bool found = false;
    while (boff + 8 <= len) {
      uint64_t blen = (static_cast<uint64_t>(data[boff]) << 24) |
                      (static_cast<uint64_t>(data[boff + 1]) << 16) |
                      (static_cast<uint64_t>(data[boff + 2]) << 8) |
                      data[boff + 3];
      const uint8_t* btype = data + boff + 4;
      size_t hdr = 8;
      if (blen == 1) {  // extended 64-bit length
        if (boff + 16 > len) break;
        blen = 0;
        for (int k = 0; k < 8; ++k) blen = (blen << 8) | data[boff + 8 + k];
        hdr = 16;
      } else if (blen == 0) {  // box runs to end of stream
        blen = len - boff;
      }
      if (blen < hdr || blen > len - boff) break;
      if (memcmp(btype, "jp2c", 4) == 0) {
        data += boff + hdr;
        len = static_cast<size_t>(blen - hdr);
        found = true;
        break;
      }
      boff += static_cast<size_t>(blen);
    }
    if (!found) {
      snprintf(err, err_cap, "JP2 wrapper held no jp2c codestream box");
      return false;
    }
  }
  if (len < 4 || data[0] != 0xFF || data[1] != 0x4F) {
    snprintf(err, err_cap, "J2K stream does not start with SOC");
    return false;
  }
  off = 2;
  J2kParams P;
  bool have_siz = false, have_cod = false, have_qcd = false;
  std::vector<J2kTile> tiles;
  int ntx = 0, nty = 0;
  bool saw_eoc = false;

  while (off + 2 <= len) {
    if (data[off] != 0xFF) {
      snprintf(err, err_cap, "J2K expected marker at offset %zu", off);
      return false;
    }
    const uint8_t m = data[off + 1];
    off += 2;
    if (m == 0xD9) {  // EOC
      saw_eoc = true;
      break;
    }
    if (m == 0x90) {  // SOT — tile-part header
      if (!have_siz || !have_cod || !have_qcd) {
        snprintf(err, err_cap, "J2K SOT before SIZ/COD/QCD");
        return false;
      }
      if (off + 10 > len || u16(off - 2 + 2) < 10) {
        snprintf(err, err_cap, "J2K truncated SOT");
        return false;
      }
      const size_t sot_start = off - 2;
      const uint32_t lsot = u16(off);
      const uint32_t isot = u16(off + 2);
      const uint32_t psot = u32(off + 4);
      off += lsot;
      if (lsot != 10 || isot >= tiles.size()) {
        snprintf(err, err_cap, "J2K SOT: bad Lsot/Isot (tile %u of %zu)",
                 isot, tiles.size());
        return false;
      }
      // Tile-part header markers until SOD.
      bool got_sod = false;
      while (off + 2 <= len) {
        if (data[off] != 0xFF) {
          snprintf(err, err_cap, "J2K expected marker in tile-part header");
          return false;
        }
        const uint8_t tm = data[off + 1];
        off += 2;
        if (tm == 0x93) {  // SOD
          got_sod = true;
          break;
        }
        if (off + 2 > len) {
          snprintf(err, err_cap, "J2K truncated tile-part header");
          return false;
        }
        const uint32_t tl = u16(off);
        if (tl < 2 || off + tl > len) {
          snprintf(err, err_cap, "J2K bad marker length in tile-part header");
          return false;
        }
        if (tm == 0x58 || tm == 0x64) {  // PLT, COM: informational
          off += tl;
        } else if (tm == 0x52 || tm == 0x5C || tm == 0x53 || tm == 0x5D ||
                   tm == 0x5F || tm == 0x61) {
          snprintf(err, err_cap,
                   "J2K per-tile marker FF%02X (COD/QCD/COC/QCC/POC/PPT "
                   "override) unsupported",
                   tm);
          return false;
        } else {
          snprintf(err, err_cap, "J2K unexpected marker FF%02X in tile-part",
                   tm);
          return false;
        }
      }
      if (!got_sod) {
        snprintf(err, err_cap, "J2K tile-part without SOD");
        return false;
      }
      size_t data_end;
      if (psot == 0) {
        // Last tile-part: data runs to just before EOC.
        data_end = len >= 2 && data[len - 2] == 0xFF && data[len - 1] == 0xD9
                       ? len - 2
                       : len;
      } else {
        data_end = sot_start + psot;
        if (data_end > len || data_end < off) {
          snprintf(err, err_cap, "J2K Psot %u out of bounds", psot);
          return false;
        }
      }
      tiles[isot].data.insert(tiles[isot].data.end(), data + off,
                              data + data_end);
      off = data_end;
      if (psot == 0) {
        saw_eoc = data_end != len;
        break;
      }
      continue;
    }
    // Main-header marker segment with a length field.
    if (off + 2 > len) {
      snprintf(err, err_cap, "J2K truncated marker FF%02X", m);
      return false;
    }
    const uint32_t l = u16(off);
    if (l < 2 || off + l > len) {
      snprintf(err, err_cap, "J2K bad length for marker FF%02X", m);
      return false;
    }
    const uint8_t* seg = data + off + 2;
    const uint32_t body = l - 2;
    if (m == 0x51) {  // SIZ
      if (body < 36 + 3) {
        snprintf(err, err_cap, "J2K SIZ too short");
        return false;
      }
      P.xsiz = u32(off + 4);
      P.ysiz = u32(off + 8);
      P.xosiz = u32(off + 12);
      P.yosiz = u32(off + 16);
      P.xtsiz = u32(off + 20);
      P.ytsiz = u32(off + 24);
      P.xtosiz = u32(off + 28);
      P.ytosiz = u32(off + 32);
      const uint32_t csiz = u16(off + 36);
      if (csiz != 1) {
        snprintf(err, err_cap,
                 "J2K %u components unsupported (grayscale only)", csiz);
        return false;
      }
      const uint8_t ssiz = seg[36];
      if (ssiz & 0x80) {
        snprintf(err, err_cap, "J2K signed samples unsupported");
        return false;
      }
      P.depth = (ssiz & 0x7F) + 1;
      if (seg[37] != 1 || seg[38] != 1) {
        snprintf(err, err_cap, "J2K component subsampling unsupported");
        return false;
      }
      if (P.depth < 2 || P.depth > 16 ||
          static_cast<uint32_t>(P.depth) > bps * 8) {
        snprintf(err, err_cap,
                 "J2K depth %d incompatible with BitsAllocated %u", P.depth,
                 bps * 8);
        return false;
      }
      if (P.xsiz <= P.xosiz || P.ysiz <= P.yosiz ||
          P.xsiz - P.xosiz != cols || P.ysiz - P.yosiz != rows) {
        snprintf(err, err_cap,
                 "J2K canvas %ux%u (origin %u,%u) disagrees with "
                 "Rows/Columns %ux%u",
                 P.xsiz, P.ysiz, P.xosiz, P.yosiz, rows, cols);
        return false;
      }
      if (P.xtsiz == 0 || P.ytsiz == 0 || P.xtosiz > P.xosiz ||
          P.ytosiz > P.yosiz || P.xtosiz + P.xtsiz <= P.xosiz ||
          P.ytosiz + P.ytsiz <= P.yosiz) {
        snprintf(err, err_cap, "J2K invalid tile grid");
        return false;
      }
      ntx = static_cast<int>(
          j2k_ceil_div(static_cast<int64_t>(P.xsiz) - P.xtosiz, P.xtsiz));
      nty = static_cast<int>(
          j2k_ceil_div(static_cast<int64_t>(P.ysiz) - P.ytosiz, P.ytsiz));
      if (ntx <= 0 || nty <= 0 || static_cast<int64_t>(ntx) * nty > 65535) {
        snprintf(err, err_cap, "J2K tile count out of range");
        return false;
      }
      tiles.assign(static_cast<size_t>(ntx) * nty, J2kTile{});
      for (int tj = 0; tj < nty; ++tj) {
        for (int ti = 0; ti < ntx; ++ti) {
          J2kTile& t = tiles[static_cast<size_t>(tj) * ntx + ti];
          const uint64_t x0 = P.xtosiz + static_cast<uint64_t>(ti) * P.xtsiz;
          const uint64_t y0 = P.ytosiz + static_cast<uint64_t>(tj) * P.ytsiz;
          t.x0 = static_cast<uint32_t>(x0 > P.xosiz ? x0 : P.xosiz);
          t.y0 = static_cast<uint32_t>(y0 > P.yosiz ? y0 : P.yosiz);
          t.x1 = static_cast<uint32_t>(
              x0 + P.xtsiz < P.xsiz ? x0 + P.xtsiz : P.xsiz);
          t.y1 = static_cast<uint32_t>(
              y0 + P.ytsiz < P.ysiz ? y0 + P.ytsiz : P.ysiz);
        }
      }
      have_siz = true;
    } else if (m == 0x52) {  // COD
      if (body < 10) {
        snprintf(err, err_cap, "J2K COD too short");
        return false;
      }
      const uint8_t scod = seg[0];
      P.user_precincts = scod & 1;
      P.sop = scod & 2;
      P.eph = scod & 4;
      P.prog = seg[1];
      if (P.prog > 4) {
        snprintf(err, err_cap, "J2K progression order %d invalid", P.prog);
        return false;
      }
      P.layers = static_cast<int>((seg[2] << 8) | seg[3]);
      if (P.layers < 1) {
        snprintf(err, err_cap, "J2K zero quality layers");
        return false;
      }
      if (seg[4] != 0) {
        snprintf(err, err_cap, "J2K multi-component transform unsupported");
        return false;
      }
      P.nl = seg[5];
      if (P.nl > 32) {
        snprintf(err, err_cap, "J2K %d decomposition levels > 32", P.nl);
        return false;
      }
      P.xcb = (seg[6] & 0x0F) + 2;
      P.ycb = (seg[7] & 0x0F) + 2;
      if (P.xcb > 10 || P.ycb > 10 || P.xcb + P.ycb > 12) {
        snprintf(err, err_cap, "J2K codeblock %dx%d exponents illegal", P.xcb,
                 P.ycb);
        return false;
      }
      P.cb_style = seg[8];
      if (P.cb_style & 0x01) {
        snprintf(err, err_cap,
                 "J2K selective arithmetic bypass style unsupported");
        return false;
      }
      if (P.cb_style & 0x04) {
        snprintf(err, err_cap,
                 "J2K terminate-each-pass style unsupported");
        return false;
      }
      if (seg[9] != 1) {
        snprintf(err, err_cap,
                 "J2K irreversible 9/7 wavelet refused under the "
                 "Lossless-Only transfer syntax (expected 5/3)");
        return false;
      }
      if (P.user_precincts) {
        if (body < 10u + P.nl + 1) {
          snprintf(err, err_cap, "J2K COD precinct list truncated");
          return false;
        }
        P.prec_sizes.assign(seg + 10, seg + 10 + P.nl + 1);
      }
      have_cod = true;
    } else if (m == 0x5C) {  // QCD
      if (body < 1) {
        snprintf(err, err_cap, "J2K QCD too short");
        return false;
      }
      const int style = seg[0] & 0x1F;
      P.guard = seg[0] >> 5;
      if (style != 0) {
        snprintf(err, err_cap,
                 "J2K quantization style %d unsupported (reversible "
                 "streams carry style 0)",
                 style);
        return false;
      }
      P.band_eps.clear();
      for (uint32_t i = 1; i < body; ++i) P.band_eps.push_back(seg[i] >> 3);
      have_qcd = true;
    } else if (m == 0x64 || m == 0x55 || m == 0x57 || m == 0x58 ||
               m == 0x63) {  // COM, TLM, PLM, PLT, CRG: informational
      // skip
    } else if (m == 0x53 || m == 0x5D || m == 0x5E || m == 0x5F ||
               m == 0x60 || m == 0x61) {
      snprintf(err, err_cap,
               "J2K marker FF%02X (COC/QCC/RGN/POC/PPM/PPT) unsupported", m);
      return false;
    } else {
      snprintf(err, err_cap, "J2K unknown marker FF%02X in main header", m);
      return false;
    }
    off += l;
  }
  if (!have_siz || !have_cod || !have_qcd) {
    snprintf(err, err_cap, "J2K codestream missing SIZ/COD/QCD");
    return false;
  }
  if (!saw_eoc) {
    snprintf(err, err_cap, "J2K codestream ended without EOC");
    return false;
  }

  const int32_t dc = 1 << (P.depth - 1);
  const int32_t vmax = (1 << P.depth) - 1;
  for (size_t ti = 0; ti < tiles.size(); ++ti) {
    J2kTile& t = tiles[ti];
    if (t.x1 <= t.x0 || t.y1 <= t.y0) continue;
    if (!j2k_build_tile(P, &t, err, err_cap)) return false;
    if (!j2k_read_packets(P, t, err, err_cap)) return false;
    std::vector<int32_t> img;
    if (!j2k_decode_tile(P, t, &img, err, err_cap)) return false;
    t.data.clear();
    t.data.shrink_to_fit();
    const int64_t tw = static_cast<int64_t>(t.x1) - t.x0;
    for (uint32_t v = t.y0; v < t.y1; ++v) {
      for (uint32_t u = t.x0; u < t.x1; ++u) {
        int32_t s = img[static_cast<size_t>(v - t.y0) * tw + (u - t.x0)] + dc;
        if (s < 0) s = 0;
        if (s > vmax) s = vmax;
        const size_t oi = (static_cast<size_t>(v - P.yosiz) * cols +
                           (u - P.xosiz)) * bps;
        out[oi] = static_cast<uint8_t>(s & 0xFF);
        if (bps == 2) out[oi + 1] = static_cast<uint8_t>((s >> 8) & 0xFF);
      }
    }
  }
  return true;
}

}  // namespace

extern "C" {

// Parse the file at `path`. Returns 0 on success, nonzero on error (with
// result->error filled). Caller must call mcgmil_dicom_free on success.
int mcgmil_dicom_read(const char* path, DicomResult* result) {
  memset(result, 0, sizeof(*result));
  FILE* f = fopen(path, "rb");
  if (!f) {
    snprintf(result->error, sizeof(result->error), "cannot open %s", path);
    return 1;
  }
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  if (size < 132 + 8) {
    fclose(f);
    snprintf(result->error, sizeof(result->error), "file too small");
    return 2;
  }
  std::vector<uint8_t> buf(static_cast<size_t>(size));
  if (fread(buf.data(), 1, buf.size(), f) != buf.size()) {
    fclose(f);
    snprintf(result->error, sizeof(result->error), "short read");
    return 3;
  }
  fclose(f);

  std::vector<uint8_t> inflated;  // deflated-syntax backing store
  Cursor c{buf.data(), buf.size()};
  // 128-byte preamble + "DICM"; tolerate raw streams without it.
  if (memcmp(buf.data() + 128, "DICM", 4) == 0) {
    c.off = 132;
  }

  bool explicit_vr = true;
  bool vr_decided = false;

  while (c.have(8)) {
    uint16_t group = c.u16();
    uint16_t elem = c.u16();
    if (!vr_decided && group != 0x0002) {
      // The meta group is over.
      if (strcmp(result->transfer_syntax, "1.2.840.10008.1.2.1.99") == 0) {
        // Deflated Explicit VR LE (PS3.5 A.5): everything from here on —
        // including the 4 tag bytes just consumed — is one raw-deflate
        // stream holding the main dataset.  Inflate, then parse that.
        char zerr[96] = {0};
        if (!inflate_raw(c.p + (c.off - 4), c.n - (c.off - 4), &inflated,
                         zerr, sizeof(zerr))) {
          snprintf(result->error, sizeof(result->error),
                   "deflated dataset (1.2.840.10008.1.2.1.99): %s", zerr);
          return 4;
        }
        c = Cursor{inflated.data(), inflated.size()};
        if (!c.have(8)) {
          snprintf(result->error, sizeof(result->error),
                   "deflated dataset inflated to fewer than 8 bytes");
          return 4;
        }
        group = c.u16();
        elem = c.u16();
      } else if (strcmp(result->transfer_syntax, "1.2.840.10008.1.2.2") == 0) {
        // Big-endian re-encodes every element; say so instead of failing
        // on garbage values.
        snprintf(result->error, sizeof(result->error),
                 "unsupported transfer syntax %s (%s)",
                 result->transfer_syntax, syntax_name(result->transfer_syntax));
        return 4;
      }
      // First non-meta element decides the VR encoding.
      explicit_vr = looks_like_vr(c.p[c.off], c.p[c.off + 1]);
      vr_decided = true;
    }
    char vr[3] = {0, 0, 0};
    uint64_t len;
    bool elem_explicit = explicit_vr || group == 0x0002;
    if (elem_explicit) {
      vr[0] = static_cast<char>(c.p[c.off]);
      vr[1] = static_cast<char>(c.p[c.off + 1]);
      c.off += 2;
      if (is_short_vr(vr)) {
        if (!c.have(2)) break;
        len = c.u16();
      } else {
        if (!c.have(6)) break;
        c.off += 2;  // reserved
        len = c.u32();
      }
    } else {
      if (!c.have(4)) break;
      len = c.u32();
    }

    if (group == kGroupPixel && elem == kElemPixelData) {
      if (len == 0xFFFFFFFFu) {
        // Encapsulated pixel data: items (FFFE,E000) — the Basic Offset
        // Table first, then frame fragments (PS3.5 A.4).  Mammography
        // exports are single-frame: for RLE the frame is exactly the first
        // fragment (Annex G requires one fragment per frame); a JPEG
        // stream may legally be SPLIT across fragments, so those
        // concatenate.
        const bool is_rle =
            strcmp(result->transfer_syntax, "1.2.840.10008.1.2.5") == 0;
        const bool is_jpegll =
            strcmp(result->transfer_syntax, "1.2.840.10008.1.2.4.57") == 0 ||
            strcmp(result->transfer_syntax, "1.2.840.10008.1.2.4.70") == 0;
        const bool is_jls =
            strcmp(result->transfer_syntax, "1.2.840.10008.1.2.4.80") == 0 ||
            strcmp(result->transfer_syntax, "1.2.840.10008.1.2.4.81") == 0;
        const bool is_jdct =
            strcmp(result->transfer_syntax, "1.2.840.10008.1.2.4.50") == 0 ||
            strcmp(result->transfer_syntax, "1.2.840.10008.1.2.4.51") == 0;
        const bool is_j2k =
            strcmp(result->transfer_syntax, "1.2.840.10008.1.2.4.90") == 0 ||
            strcmp(result->transfer_syntax, "1.2.840.10008.1.2.4.91") == 0;
        if (!is_rle && !is_jpegll && !is_jls && !is_jdct && !is_j2k) {
          snprintf(result->error, sizeof(result->error),
                   "encapsulated pixel data in unsupported transfer syntax "
                   "%s (%s); supported: uncompressed little-endian, RLE "
                   "Lossless, JPEG (baseline, extended, lossless 14), "
                   "JPEG-LS, JPEG 2000 (reversible)",
                   result->transfer_syntax[0] ? result->transfer_syntax
                                              : "(missing 0002,0010)",
                   syntax_name(result->transfer_syntax));
          return 4;
        }
        if (result->rows == 0 || result->cols == 0) {
          snprintf(result->error, sizeof(result->error),
                   "encapsulated pixel data precedes Rows/Columns");
          return 4;
        }
        uint32_t bps = (result->bits_allocated ? result->bits_allocated : 16) / 8;
        if (bps < 1 || bps > 2) {
          snprintf(result->error, sizeof(result->error),
                   "compressed pixel data with BitsAllocated %u unsupported",
                   result->bits_allocated);
          return 4;
        }
        size_t npix = static_cast<size_t>(result->rows) * result->cols;
        std::vector<uint8_t> stream;  // fragment bytes (JPEG: concatenated)
        size_t item_index = 0;
        while (c.have(8)) {
          uint16_t g2 = c.u16();
          uint16_t e2 = c.u16();
          uint32_t l2 = c.u32();
          if (g2 == 0xFFFE && e2 == 0xE0DD) break;
          if (g2 != 0xFFFE || e2 != 0xE000 || !c.have(l2)) {
            snprintf(result->error, sizeof(result->error),
                     "malformed encapsulated pixel-data item");
            return 4;
          }
          if (item_index++ > 0 &&
              (is_jpegll || is_jls || is_jdct || is_j2k || stream.empty())) {
            stream.insert(stream.end(), c.p + c.off, c.p + c.off + l2);
          }
          c.off += l2;
        }
        if (stream.empty()) {
          snprintf(result->error, sizeof(result->error),
                   "encapsulated pixel data held no fragment");
          return 4;
        }
        result->pixels = static_cast<uint8_t*>(malloc(npix * bps));
        if (!result->pixels) {
          snprintf(result->error, sizeof(result->error), "alloc failed");
          return 6;
        }
        char err[192] = {0};
        bool ok;
        if (is_rle) {
          ok = rle_decode_frame(stream.data(), stream.size(), result->pixels,
                                npix, bps, err, sizeof(err));
        } else if (is_jls) {
          const bool jls_lossless_uid =
              strcmp(result->transfer_syntax, "1.2.840.10008.1.2.4.80") == 0;
          ok = jpeg_ls_decode(stream.data(), stream.size(), result->pixels,
                              result->rows, result->cols, bps,
                              jls_lossless_uid, err, sizeof(err));
        } else if (is_jdct) {
          ok = jpeg_dct_decode(stream.data(), stream.size(), result->pixels,
                               result->rows, result->cols, bps, err,
                               sizeof(err));
        } else if (is_j2k) {
          ok = jpeg2000_decode(stream.data(), stream.size(), result->pixels,
                               result->rows, result->cols, bps, err,
                               sizeof(err));
        } else {
          ok = jpeg_lossless_decode(stream.data(), stream.size(),
                                    result->pixels, result->rows,
                                    result->cols, bps, err, sizeof(err));
        }
        if (!ok) {
          free(result->pixels);
          result->pixels = nullptr;
          snprintf(result->error, sizeof(result->error), "%s", err);
          return 4;
        }
        result->pixel_bytes = npix * bps;
        continue;
      }
      if (!c.have(len)) {
        snprintf(result->error, sizeof(result->error), "truncated pixel data");
        return 5;
      }
      result->pixels = static_cast<uint8_t*>(malloc(len));
      if (!result->pixels) {
        snprintf(result->error, sizeof(result->error), "alloc failed");
        return 6;
      }
      memcpy(result->pixels, c.p + c.off, len);
      result->pixel_bytes = len;
      c.off += len;
      continue;
    }

    if (len == 0xFFFFFFFFu) {
      // Undefined-length sequence: skip item-by-item until the sequence
      // delimiter (FFFE,E0DD).
      while (c.have(8)) {
        uint16_t g2 = c.u16();
        uint16_t e2 = c.u16();
        uint32_t l2 = c.u32();
        if (g2 == 0xFFFE && e2 == 0xE0DD) break;
        if (g2 == 0xFFFE && (e2 == 0xE000 || e2 == 0xE00D)) {
          if (l2 != 0xFFFFFFFFu) c.off += l2;
          continue;
        }
        if (l2 != 0xFFFFFFFFu) c.off += l2;
      }
      continue;
    }
    if (!c.have(len)) break;
    const uint8_t* data = c.p + c.off;

    if (group == 0x0002 && elem == 0x0010) {
      copy_trimmed(result->transfer_syntax, sizeof(result->transfer_syntax),
                   data, len);
    } else if (group == 0x0028) {
      bool is_us = !elem_explicit || (vr[0] == 'U' && vr[1] == 'S');
      switch (elem) {
        case 0x0010: result->rows = parse_uint_value(data, len, is_us); break;
        case 0x0011: result->cols = parse_uint_value(data, len, is_us); break;
        case 0x0100: result->bits_allocated = parse_uint_value(data, len, is_us); break;
        case 0x0101: result->bits_stored = parse_uint_value(data, len, is_us); break;
        case 0x0103: result->pixel_representation = parse_uint_value(data, len, is_us); break;
        default: break;
      }
    } else if (group == 0x0010) {
      if (elem == 0x0020) copy_trimmed(result->patient_id, sizeof(result->patient_id), data, len);
      if (elem == 0x1010) copy_trimmed(result->patient_age, sizeof(result->patient_age), data, len);
    } else if (group == 0x0020 && elem == 0x0062) {
      copy_trimmed(result->laterality, sizeof(result->laterality), data, len);
    }
    c.off += len;
  }

  if (!result->pixels) {
    snprintf(result->error, sizeof(result->error), "no PixelData element");
    return 7;
  }
  if (result->rows == 0 || result->cols == 0) {
    free(result->pixels);
    result->pixels = nullptr;
    snprintf(result->error, sizeof(result->error), "missing Rows/Columns");
    return 8;
  }
  if (result->bits_allocated == 0) result->bits_allocated = 16;
  if (result->bits_stored == 0) result->bits_stored = result->bits_allocated;
  // A corrupt header must fail HERE, not as an overflow in the caller's
  // 2^BitsStored normalization (found by the mutation fuzz test).
  if (result->bits_allocated != 8 && result->bits_allocated != 16) {
    free(result->pixels);
    result->pixels = nullptr;
    snprintf(result->error, sizeof(result->error),
             "BitsAllocated %u unsupported (8 or 16)", result->bits_allocated);
    return 9;
  }
  if (result->bits_stored > result->bits_allocated) {
    free(result->pixels);
    result->pixels = nullptr;
    snprintf(result->error, sizeof(result->error),
             "BitsStored %u exceeds BitsAllocated %u", result->bits_stored,
             result->bits_allocated);
    return 9;
  }
  uint64_t expect =
      static_cast<uint64_t>(result->rows) * result->cols * (result->bits_allocated / 8);
  if (result->pixel_bytes < expect) {
    free(result->pixels);
    result->pixels = nullptr;
    snprintf(result->error, sizeof(result->error),
             "pixel data smaller than Rows*Cols (%llu < %llu)",
             static_cast<unsigned long long>(result->pixel_bytes),
             static_cast<unsigned long long>(expect));
    return 9;
  }
  return 0;
}

void mcgmil_dicom_free(DicomResult* result) {
  if (result && result->pixels) {
    free(result->pixels);
    result->pixels = nullptr;
  }
}

}  // extern "C"
