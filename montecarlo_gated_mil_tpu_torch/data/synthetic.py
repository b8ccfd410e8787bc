"""Synthetic mammograms and records (the port's own copy of the numpy-only
generator in ``montecarlo_gated_mil_tpu/data/synthetic.py``).

The reference repo assumes private DICOM data on disk; this environment has
none (and no pydicom).  These generators produce breast-like grayscale
images — a bright lobe against a black background, optionally with a small
high-intensity "mass" for positive cases — with the same value range and
layout the DICOM path produces, so every downstream stage (tiling, fill
scoring, model, CV) runs identically.
"""

from __future__ import annotations

import numpy as np

from montecarlo_gated_mil_tpu_torch.data.records import BagRecord


def synthetic_image(
    height: int, width: int, *, positive: bool, seed: int
) -> np.ndarray:
    """Grayscale image in [0, 1]: elliptical breast lobe anchored at the left
    edge (mammograms are laterality-canonicalized to left), plus a bright
    mass for positive cases."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:height, 0:width].astype(np.float32)
    cy = height * rng.uniform(0.4, 0.6)
    ry = height * rng.uniform(0.35, 0.45)
    rx = width * rng.uniform(0.55, 0.8)
    lobe = ((y - cy) / ry) ** 2 + (x / rx) ** 2 < 1.0
    tissue = np.clip(
        rng.uniform(0.25, 0.45)
        + 0.25 * np.exp(-(((x / rx) ** 2 + ((y - cy) / ry) ** 2))).astype(np.float32)
        + rng.normal(0, 0.03, (height, width)).astype(np.float32),
        0.05,
        1.0,
    )
    img = np.where(lobe, tissue, 0.0).astype(np.float32)
    if positive:
        my = cy + ry * rng.uniform(-0.5, 0.5)
        mx = rx * rng.uniform(0.2, 0.6)
        mr = min(height, width) * rng.uniform(0.02, 0.05)
        mass = np.exp(-(((y - my) ** 2 + (x - mx) ** 2) / (2 * mr**2)))
        img = np.clip(img + 0.5 * mass.astype(np.float32) * lobe, 0.0, 1.0)
    return img


def synthetic_records(
    n: int, *, positive_fraction: float = 0.4, seed: int = 0
) -> list[BagRecord]:
    """Records whose paths encode the generator seed (``synthetic://i``)."""
    rng = np.random.default_rng(seed)
    classes = ("Normal", "Benign", "Malignant", "Lymph_nodes")
    recs = []
    for i in range(n):
        positive = rng.random() < positive_fraction
        cls = classes[2 + rng.integers(2)] if positive else classes[rng.integers(2)]
        recs.append(
            BagRecord(
                paths=(f"synthetic://{i}",),
                class_name=cls,
                view="LCC" if rng.random() < 0.5 else "RCC",
                laterality="L" if rng.random() < 0.5 else "R",
            )
        )
    return recs


def make_synthetic_reader(height: int, width: int):
    """Reader for :class:`~montecarlo_gated_mil_tpu_torch.data.pipeline.BagLoader`
    over synthetic records."""

    def read(rec: BagRecord) -> np.ndarray:
        idx = int(rec.paths[0].rsplit("//", 1)[1])
        return synthetic_image(height, width, positive=rec.label == 1, seed=idx)

    return read
