"""Bag records, their selection from the metadata table, and class
weights (the port's own copy of ``montecarlo_gated_mil_tpu/data/records.py``).

The reference reads a pickled pandas DataFrame with per-patient
``view``/``filename``/``class`` lists and selects either unimodal view
records or paired CC+MLO records per laterality (``dataset.py:114-160``).
Labels: 1 iff the class is Malignant or Lymph_nodes (``dataset.py:48``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

POSITIVE_CLASSES = frozenset({"Malignant", "Lymph_nodes"})
CLASS_TO_GROUP = {"Normal": 0, "Benign": 0, "Malignant": 1, "Lymph_nodes": 1}


@dataclass(frozen=True)
class BagRecord:
    """One bag-to-be: file path(s), class name, laterality, view.

    ``laterality`` starts as the table's view heuristic; the loader yields
    the record with the DICOM header's ImageLaterality, ``patient_id`` and
    ``age`` in place once the pixels are read (reference
    ``dataset.py:51-64``).
    """

    paths: tuple[str, ...]  # 1 file (unimodal) or (CC, MLO) pair (multimodal)
    class_name: str
    view: str
    laterality: str = ""
    patient_id: str = ""
    age: int = -1

    @property
    def label(self) -> int:
        return 1 if self.class_name in POSITIVE_CLASSES else 0


@dataclass(frozen=True)
class PixelData:
    """A reader's pixels with the file's DICOM metadata: ``images`` is
    ``(img,)`` or ``(cc, mlo)``, ``meta`` a ``DicomMeta`` or None.  Plain
    arrays and ``(cc, mlo)`` tuples stay valid reader outputs."""

    images: tuple
    meta: object | None = None


def select_records(
    patients: Sequence[dict], view: Sequence[str], multimodal: bool
) -> list[BagRecord]:
    """Flatten the patient table (``df.to_dict("records")``: dicts of
    parallel ``view``/``filename``/``class`` lists) into records.

    Multimodal: per patient, the left CC+MLO files make one record and the
    right pair another; a side without both views, or without exactly two
    files tagged ``{side}_C`` / ``{side}_M``, is skipped (reference
    ``dataset.py:122-143``).  Unimodal: one record per file whose view
    contains any of ``view`` (``dataset.py:145-151``).
    """
    records: list[BagRecord] = []
    if multimodal:
        for p in patients:
            views, files, classes = p["view"], p["filename"], p["class"]
            for side, cc_tag, mlo_tag in (("L", "L_C", "L_M"), ("R", "R_C", "R_M")):
                if f"{side}CC" in views and f"{side}MLO" in views:
                    flist = tuple(f for f in files if cc_tag in f or mlo_tag in f)
                    if len(flist) != 2:
                        continue
                    records.append(BagRecord(
                        paths=flist,
                        class_name=classes[0] if side == "L" else classes[-1],
                        view="Left" if side == "L" else "Right",
                        laterality=side,
                    ))
    else:
        for p in patients:
            for i in range(len(p["class"])):
                for v in view:
                    if v in p["view"][i]:
                        records.append(BagRecord(
                            paths=(p["filename"][i],),
                            class_name=p["class"][i],
                            view=p["view"][i],
                            laterality="R" if "R" in p["view"][i][:1] else "L",
                        ))
    return records


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
