"""Bag records and class weights (the port's own copy of the numpy-only
parts of ``montecarlo_gated_mil_tpu/data/records.py``).

Labels: 1 iff the class is Malignant or Lymph_nodes (reference
``dataset.py:48``).  Reading records from the metadata table and DICOM
headers is not ported yet (ROADMAP.md).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

POSITIVE_CLASSES = frozenset({"Malignant", "Lymph_nodes"})
CLASS_TO_GROUP = {"Normal": 0, "Benign": 0, "Malignant": 1, "Lymph_nodes": 1}


@dataclass(frozen=True)
class BagRecord:
    """One bag-to-be: file path(s), class name, laterality, view."""

    paths: tuple[str, ...]  # 1 file (unimodal) or (CC, MLO) pair (multimodal)
    class_name: str
    view: str
    laterality: str = ""
    patient_id: str = ""
    age: int = -1

    @property
    def label(self) -> int:
        return 1 if self.class_name in POSITIVE_CLASSES else 0


def class_weights(records: Sequence[BagRecord]) -> tuple[dict[int, float], list[float]]:
    """Inverse-group-frequency weights (reference ``utils.py:259-275``):
    ``(group -> total / group_count, per-record sample weights)``."""
    group_counts = {0: 0, 1: 0}
    for r in records:
        group_counts[CLASS_TO_GROUP.get(r.class_name, r.label)] += 1
    total = sum(group_counts.values())
    weights = {g: (total / c if c else 0.0) for g, c in group_counts.items()}
    sample_w = [weights[CLASS_TO_GROUP.get(r.class_name, r.label)] for r in records]
    return weights, sample_w
