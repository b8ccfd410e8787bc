"""DICOM reading through pydicom, where it is installed.

Counterpart of ``montecarlo_gated_mil_tpu/data/dicom.py`` (reference
``dataset.py:82-112,162-180``): pixels normalized by ``2^BitsStored - 1``,
the CC/MLO pair found by filename tags, and the PatientID, age ('dddY') and
ImageLaterality of the header.  Paths are absolute; nothing changes the
working directory.  Without pydicom, :func:`read_dicom` and
:func:`make_dicom_reader` raise ``ImportError`` naming it, and
``data/dicom_native.py`` reads the files instead.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from montecarlo_gated_mil_tpu_torch.data.records import BagRecord, PixelData

try:
    from pydicom import dcmread

    HAVE_PYDICOM = True
except ImportError:
    dcmread = None
    HAVE_PYDICOM = False


@dataclass(frozen=True)
class DicomMeta:
    patient_id: str
    age: int
    laterality: str


def normalize_dicom_pixels(pixel_array: np.ndarray, bits_stored: int) -> np.ndarray:
    """Float32 pixels divided by ``2^bits_stored - 1`` (reference
    ``__normalize_dicom``, ``dataset.py:176-180``)."""
    max_val = (2**bits_stored) - 1
    return np.asarray(pixel_array, np.float32) / np.float32(max_val)


def parse_age(age_str: str) -> int:
    """A 'dddY' DICOM age string in years (reference ``dataset.py:162-167``)."""
    idx = age_str.find("Y")
    if idx < 0:
        raise ValueError(f"unparseable DICOM age {age_str!r}")
    return int(age_str[max(0, idx - 3) : idx])


def _require_pydicom():
    if not HAVE_PYDICOM:
        raise ImportError(
            "pydicom is not installed; read DICOM files with "
            "montecarlo_gated_mil_tpu_torch.data.dicom_native or install pydicom"
        )


def read_dicom(path: str | os.PathLike) -> tuple[np.ndarray, DicomMeta]:
    """One DICOM file -> (grayscale in [0, 1], metadata), through pydicom."""
    _require_pydicom()
    dcm = dcmread(path)
    img = normalize_dicom_pixels(dcm.pixel_array, int(dcm.BitsStored))
    meta = DicomMeta(
        patient_id=str(getattr(dcm, "PatientID", "")),
        age=parse_age(str(dcm[(0x0010, 0x1010)].value)) if (0x0010, 0x1010) in dcm else -1,
        laterality=str(getattr(dcm, "ImageLaterality", "")),
    )
    return img, meta


def split_cc_mlo(paths: tuple[str, ...]) -> tuple[str, str]:
    """The (CC, MLO) pair among ``paths`` by filename tags (reference
    ``dataset.py:83-92``)."""
    cc = mlo = None
    for p in paths:
        name = os.path.basename(p)
        if "CC" in name:
            cc = p
        if "ML" in name or "MO" in name:
            mlo = p
    if cc is None or mlo is None:
        raise ValueError(f"CC or MLO not found among {paths}")
    return cc, mlo


def make_pair_reader(read_one, root: str = ""):
    """A :class:`BagLoader` reader over ``read_one(path) -> (image, meta)``:
    one view, or the CC and MLO files of a pair, as :class:`PixelData`, the
    files under ``root/<class name>/`` when ``root`` is set.  A pair's
    metadata is the MLO file's (the reference keeps the last file it read,
    ``dataset.py:93-103``)."""

    def read(rec: BagRecord) -> PixelData:
        paths = tuple(os.path.join(root, rec.class_name, p) if root else p for p in rec.paths)
        if len(paths) == 1:
            img, meta = read_one(paths[0])
            return PixelData((img,), meta)
        cc_path, mlo_path = split_cc_mlo(paths)
        cc, _ = read_one(cc_path)
        mlo, meta = read_one(mlo_path)
        return PixelData((cc, mlo), meta)

    return read


def make_dicom_reader(root: str = ""):
    """The pydicom reader for :class:`BagLoader`; raises ``ImportError``
    without pydicom."""
    _require_pydicom()
    return make_pair_reader(read_dicom, root)
