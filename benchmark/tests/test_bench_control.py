"""The controls, on the card: the reference put in the program's place at
the next lower precision than the configuration states fails the cell's
limits (TF32 for the float32 cells, int4 codes for the int8 cell), at the
published widths on a smaller image.  Run on the card with
``python3 -m pytest -m gpu benchmark/tests``."""

from __future__ import annotations

import copy

import pytest
import torch

from benchmark import images, spec
from benchmark.check import compare, reference_request, tf32, train_check
from benchmark.reference import model as ref_model

pytestmark = pytest.mark.gpu


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _small(workload: str) -> spec.Cell:
    cell = spec.load_cell(workload)
    cfg = copy.deepcopy(cell.config)
    cfg.update(H=1792, W=1120)
    return cell, cfg


@pytest.mark.parametrize("workload", ["r18-f32-serve-closed4", "r18-int8-serve-closed4"])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_serving_control_fails_the_limits(card, workload, seed):
    cell, cfg = _small(workload)
    w = ref_model.make_weights("r18", cfg["L"], cfg["D"], cfg["C"], seed, "cuda")
    pool = images.pool(cfg["H"], cfg["W"], dict(cell.traffic, pool=2), seed, "cuda")
    worst = {}
    for i, img in enumerate(pool):
        ref = reference_request(w, img.pixels, img.laterality, seed + i, cfg, 4095.0)
        low = reference_request(w, img.pixels, img.laterality, seed + i, cfg, 4095.0,
                                control=True)
        for k, v in compare(low, ref).items():
            worst[k] = max(worst.get(k, 0.0), v)
    limits = cfg["limits"]
    assert any(worst[k] > limits[k] for k in ("stats", "attention")), worst


def test_training_control_fails_the_limits(card):
    """TF32 forward and backward in the reference's place, one record."""
    cell, cfg = _small("r18-f32-train")
    from benchmark.reference import train as ref_train
    from benchmark.training import write_records

    w = ref_model.make_weights("r18", cfg["L"], cfg["D"], cfg["C"], 5, "cuda")
    tr = dict(cell.traffic, records=2, check_steps=1)
    import tempfile

    with tempfile.TemporaryDirectory() as root:
        _, raw = write_records(root, cfg, tr, 5, "cuda")
    bags, info = [], []
    for i in range(2):
        cc, mlo, side, label = raw[i]
        x, bucket = ref_train.bag(cc, mlo, 12, side, i, 0, 9, cfg, "cuda")
        bags.append((x, bucket, label, ref_train.fold_in(ref_train.fold_in(3, 0), i)))
        info.append((bucket, x.shape[0]))
    with tf32(True):
        losses, first, p3 = ref_train.follow(w, bags, cfg, 1)
    p0 = {k: v.clone() for k, v in w.items()}
    snap = {"m1": {k: 0.1 * g for k, g in first.items()}, "p3": p3}
    prog, _ = train_check(losses, info, snap, p0, raw, w, cfg, tr, 9, 3, False)
    assert any(prog[k] > cfg["limits"][k] for k in ("loss", "grad1", "update3")), prog
