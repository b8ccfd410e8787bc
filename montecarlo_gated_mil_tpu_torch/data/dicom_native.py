"""ctypes binding to the port's C++ DICOM reader (``csrc/dicom.cc``).

Counterpart of ``montecarlo_gated_mil_tpu/data/dicom_native.py``: the
DICOM reads of reference ``dataset.py:93-112,162-180`` without pydicom.
The decoder reads uncompressed Explicit/Implicit VR Little Endian, RLE
Lossless, JPEG Lossless (process 14, predictors 1-7, point transform,
restarts), JPEG Baseline/Extended, JPEG-LS (lossless and near-lossless),
JPEG 2000 Part 1 (reversible 5/3) and Deflated Explicit VR Little Endian,
and the PatientID, PatientAge, ImageLaterality and BitsStored fields; a
syntax it does not decode raises with its TransferSyntaxUID named.

The library is host code.  It builds with ``g++ -O2 -shared -fPIC ... -lz``
at first use, under a lock, into ``csrc/build/`` beside the CUDA libraries
(gitignored), named by a hash of the source and flags so an edited source
rebuilds.  A missing compiler or ``zlib.h`` fails the build with the
compiler's message; nothing stands in for it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from montecarlo_gated_mil_tpu_torch.data.dicom import DicomMeta, make_pair_reader, parse_age

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "dicom.cc"
BUILD_DIR = SOURCE.parent / "build"
# -lz: raw-deflate inflate for Deflated Explicit VR Little Endian
# (1.2.840.10008.1.2.1.99, PS3.5 A.5).
GXX_FLAGS = ("-O2", "-shared", "-fPIC")
_lock = threading.Lock()
_lib = None


class _DicomResult(ctypes.Structure):
    _fields_ = [
        ("pixels", ctypes.POINTER(ctypes.c_uint8)),
        ("pixel_bytes", ctypes.c_uint64),
        ("rows", ctypes.c_uint32),
        ("cols", ctypes.c_uint32),
        ("bits_allocated", ctypes.c_uint32),
        ("bits_stored", ctypes.c_uint32),
        ("pixel_representation", ctypes.c_uint32),
        ("patient_id", ctypes.c_char * 65),
        ("patient_age", ctypes.c_char * 17),
        ("laterality", ctypes.c_char * 17),
        ("transfer_syntax", ctypes.c_char * 65),
        ("error", ctypes.c_char * 256),
    ]


def library_path() -> Path:
    """Where the built library lives: its name carries a hash of the
    source and the flags."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"dicom-{h.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *GXX_FLAGS, "-o", str(tmp), str(SOURCE), "-lz"]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError(f"cannot build the DICOM reader: {cmd[0]} not found") from e
    if proc.returncode != 0:
        raise RuntimeError(
            f"building the DICOM reader failed ({' '.join(cmd)}):\n{proc.stderr}"
        )
    os.replace(tmp, out)


def load_library() -> ctypes.CDLL:
    """The reader's library, built on first use."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not path.exists():
            _build(path)
        lib = ctypes.CDLL(str(path))
        lib.mcgmil_dicom_read.argtypes = [ctypes.c_char_p, ctypes.POINTER(_DicomResult)]
        lib.mcgmil_dicom_read.restype = ctypes.c_int
        lib.mcgmil_dicom_free.argtypes = [ctypes.POINTER(_DicomResult)]
        lib.mcgmil_dicom_free.restype = None
        _lib = lib
        return lib


def read_dicom_native(path: str | os.PathLike) -> tuple[np.ndarray, DicomMeta]:
    """One DICOM file -> (grayscale float32 in [0, 1], metadata); the
    pixels divided by ``2^BitsStored - 1``.  A file the parser refuses
    raises ``ValueError`` with its message."""
    lib = load_library()
    res = _DicomResult()
    rc = lib.mcgmil_dicom_read(str(path).encode(), ctypes.byref(res))
    if rc != 0:
        raise ValueError(
            f"native DICOM parse failed ({rc}): {res.error.decode(errors='replace')}"
        )
    try:
        rows, cols = int(res.rows), int(res.cols)
        if res.bits_allocated == 8:
            dtype = np.uint8
        elif res.pixel_representation:
            dtype = np.int16
        else:
            dtype = np.uint16
        count = rows * cols
        raw = np.ctypeslib.as_array(res.pixels, shape=(int(res.pixel_bytes),))
        px = raw[: count * np.dtype(dtype).itemsize].view(dtype).reshape(rows, cols)
        # astype copies out of the buffer the library frees below
        img = px.astype(np.float32) / np.float32((2 ** int(res.bits_stored)) - 1)
        age_s = res.patient_age.decode(errors="replace")
        meta = DicomMeta(
            patient_id=res.patient_id.decode(errors="replace"),
            age=parse_age(age_s) if "Y" in age_s else -1,
            laterality=res.laterality.decode(errors="replace"),
        )
        return img, meta
    finally:
        lib.mcgmil_dicom_free(ctypes.byref(res))


def make_native_dicom_reader(root: str = ""):
    """:class:`BagLoader` reader over the native parser: :class:`PixelData`
    with one view or a (CC, MLO) pair, the metadata from the MLO file."""
    return make_pair_reader(read_dicom_native, root)
