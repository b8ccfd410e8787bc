"""A small writer of uncompressed DICOM Part 10 files (Explicit VR Little
Endian, PS3.5 7.1.2 and A.2): one 16-bit grayscale frame with the header
fields a mammography reader takes (PatientID, PatientAge, ImageLaterality,
rows, columns, BitsAllocated 16, BitsStored, PixelRepresentation 0)."""

from __future__ import annotations

import struct

import numpy as np

EXPLICIT_VR_LE = "1.2.840.10008.1.2.1"


def _element(group: int, elem: int, vr: bytes, value: bytes) -> bytes:
    if len(value) % 2:
        value += b"\x00" if vr in (b"OB", b"UI") else b" "
    head = struct.pack("<HH", group, elem) + vr
    if vr in (b"OB", b"OW"):
        return head + b"\x00\x00" + struct.pack("<I", len(value)) + value
    return head + struct.pack("<H", len(value)) + value


def dicom_bytes(px: np.ndarray, bits_stored: int, patient: str, age: str, side: str) -> bytes:
    rows, cols = px.shape
    out = b"\x00" * 128 + b"DICM" + _element(0x0002, 0x0010, b"UI", EXPLICIT_VR_LE.encode())
    for group, elem, vr, value in (
        (0x0010, 0x0020, b"LO", patient.encode()),
        (0x0010, 0x1010, b"AS", age.encode()),
        (0x0020, 0x0062, b"CS", side.encode()),
        (0x0028, 0x0010, b"US", struct.pack("<H", rows)),
        (0x0028, 0x0011, b"US", struct.pack("<H", cols)),
        (0x0028, 0x0100, b"US", struct.pack("<H", 16)),
        (0x0028, 0x0101, b"US", struct.pack("<H", bits_stored)),
        (0x0028, 0x0103, b"US", struct.pack("<H", 0)),
    ):
        out += _element(group, elem, vr, value)
    return out + _element(0x7FE0, 0x0010, b"OW", np.ascontiguousarray(px, "<u2").tobytes())


def write(path, px: np.ndarray, bits_stored: int, patient: str, age: str, side: str) -> None:
    with open(path, "wb") as f:
        f.write(dicom_bytes(px, bits_stored, patient, age, side))
