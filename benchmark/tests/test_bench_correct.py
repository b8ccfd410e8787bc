"""What decides ``correct``, at a CPU test's size: the plain reference
agrees with the port's CPU path, and a run whose timed path is broken
underneath comes out not correct, once for each fault a cell can have."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import images, run
from benchmark.check import _program_view, compare, reference_request
from benchmark.reference import model as ref_model
from benchmark.reference import quant as ref_quant
from benchmark.tests._tiny import H, PATCH, W, args, tiny_cell, with_backbone

# Limits at this size: a bag of 20-120 small tiles.  The int8 path's codes
# flip more often over so few instances than over a full-size bag.
SERVE_LIMITS = {"r18-f32-serve-closed4": {"stats": 1e-4, "attention": 1e-3},
                "r18-int8-serve-closed4": {"stats": 5e-3, "attention": 0.3}}
SERVE_CELLS = sorted(SERVE_LIMITS)
TRAIN_LIMITS = {"loss": 1e-3, "grad1": 1e-2, "update3": 1e-1}


def _port_predictor(cell, weights):
    from montecarlo_gated_mil_tpu_torch.core.config import config_from_dict
    from montecarlo_gated_mil_tpu_torch.serve import MCDOPredictor

    return MCDOPredictor.from_config(config_from_dict(cell.config["port_config"]), weights,
                                     device="cpu")


@pytest.mark.parametrize("backbone", ["r18", "r34", "r50"])
def test_weights_schema_is_the_ports(backbone):
    from montecarlo_gated_mil_tpu_torch.core.config import config_from_dict
    from montecarlo_gated_mil_tpu_torch.experiment import build_model

    cell = with_backbone(tiny_cell("r18-f32-serve-closed4"), backbone)
    sd = build_model(config_from_dict(cell.config["port_config"])).state_dict()
    sch = ref_model.schema(backbone, cell.config["L"], 128, 2)
    assert cell.config["L"] == {"r18": 512, "r34": 512, "r50": 2048}[backbone]
    assert {k: tuple(v.shape) for k, v in sd.items()} == sch


@pytest.mark.parametrize("backbone, seed", [("r18", 11), ("r18", 12), ("r34", 11), ("r50", 11)])
def test_reference_matches_the_port_f32(backbone, seed):
    """The reference's f32 request, its embed walked from the backbone's
    file, against the port's: ResNet-18 and -34 (BasicBlocks) and -50
    (Bottlenecks, L=2048), within the same limits."""
    cell = with_backbone(tiny_cell("r18-f32-serve-closed4"), backbone)
    w = ref_model.make_weights(backbone, cell.config["L"], 128, 2, seed, "cpu")
    pred = _port_predictor(cell, w)
    pool = images.pool(H, W, {"pool": 2, "positive_share": 0.5, "right_share": 0.5,
                              "pixel_bits": 12}, seed, "cpu")
    for i, img in enumerate(pool):
        res = pred.predict(img.pixels, img.laterality, seed=seed + i, pixel_max=4095.0)
        ref = reference_request(w, img.pixels, img.laterality, seed + i, cell.config, 4095.0,
                                device="cpu")
        got = compare(_program_view(res), ref)
        assert 8 <= ref["n"] <= 200
        assert got["tiles"] == 0
        assert got["stats"] < 1e-6 and got["attention"] < 1e-4, got


@pytest.mark.parametrize("backbone", ["r18", "r50"])
def test_reference_int8_embed_matches_the_port(backbone):
    """The int8 scheme written out against the port's plain int8 embed on
    the same tiles: most codes agree; a BN statistic's last bit can flip
    an odd code, which a random ResNet amplifies, so features are compared
    by their cosine; the int4 control lies far off.  For ResNet-50 every
    conv of a Bottleneck but its last is requantized at its own bound."""
    from montecarlo_gated_mil_tpu_torch.mcdo.sampling import make_embed_fn
    from montecarlo_gated_mil_tpu_torch.core.config import config_from_dict
    from montecarlo_gated_mil_tpu_torch.experiment import build_model

    cell = with_backbone(tiny_cell("r18-int8-serve-closed4"), backbone)
    w = ref_model.make_weights(backbone, cell.config["L"], 128, 2, 3, "cpu")
    model = build_model(config_from_dict(cell.config["port_config"]))
    model.load_state_dict(w)
    g = torch.Generator().manual_seed(0)
    x = torch.rand(12, PATCH, PATCH, 3, generator=g) * 4 - 2
    with torch.no_grad():
        got = make_embed_fn(model, True)(x, torch.ones(12, dtype=torch.bool))
        ref = ref_quant.embed(w, x, backbone=backbone)
        low = ref_quant.embed(w, x, levels=7, backbone=backbone)

    def cos(a, b):
        return float(torch.nn.functional.cosine_similarity(a, b, dim=1).min())

    assert got.shape == (12, cell.config["L"])
    assert cos(got, ref) > 0.999
    assert cos(low, ref) < cos(got, ref)


def _serve(workload):
    cell = tiny_cell(workload, pool=2, clients=2, check_requests=2)
    cell.config["limits"].update(SERVE_LIMITS[workload])
    return run.run_cell(cell, args(seconds=0.5), run.T_START, device="cpu")


@pytest.mark.parametrize("workload", SERVE_CELLS)
def test_serving_run_is_correct_on_the_cpu(workload):
    out = _serve(workload)
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("workload", SERVE_CELLS)
def test_serving_fault_an_answer_altered(monkeypatch, workload):
    from montecarlo_gated_mil_tpu_torch import serve

    real = serve.predictive_stats

    def altered(y, *a, **k):
        s = real(y, *a, **k)
        return type(s)(**dict(vars(s), mean=s.mean + 0.05))

    monkeypatch.setattr(serve, "predictive_stats", altered)
    out = _serve(workload)
    assert not out["correct"]
    assert out["checks"]["stats"]["value"] > SERVE_LIMITS[workload]["stats"]


@pytest.mark.parametrize("workload", SERVE_CELLS)
def test_serving_fault_half_the_bag_left_out(monkeypatch, workload):
    """Half of the valid tiles masked out: the mean is taken over the rest."""
    from montecarlo_gated_mil_tpu_torch import serve

    real = serve.image_to_bag

    def half(*a, **k):
        bag = real(*a, **k)
        n = int(bag.mask.sum())
        mask = bag.mask.clone()
        mask[n // 2:] = False
        return type(bag)(patches=bag.patches, mask=mask, label=bag.label,
                         tile_indices=bag.tile_indices)

    monkeypatch.setattr(serve, "image_to_bag", half)
    out = _serve(workload)
    assert not out["correct"]


def _train(cell):
    cell.config["limits"].update(TRAIN_LIMITS)
    return run.run_cell(cell, args(seconds=1.0), run.T_START, device="cpu")


def _train_cell():
    return tiny_cell("r18-f32-train", records=4, setup_bags=4, check_steps=2)


def test_training_run_is_correct_on_the_cpu():
    out = _train(_train_cell())
    assert out["correct"], out["checks"]


def test_training_fault_state_unchanged(monkeypatch):
    from montecarlo_gated_mil_tpu_torch.train import state as st

    monkeypatch.setattr(st.TrainState, "apply_update",
                        lambda self, mean=False: (self.optimizer.zero_grad(), None)[1])
    out = _train(_train_cell())
    assert not out["correct"]


def test_training_fault_half_the_bag_left_out(monkeypatch):
    from montecarlo_gated_mil_tpu_torch.train import state as st

    real = st.make_train_step

    def half_step(*a, **k):
        step = real(*a, **k)

        def f(state, bag, seed, do_update):
            n = int(bag.mask.sum())
            mask = bag.mask.clone()
            mask[n // 2:] = False
            return step(state, type(bag)(bag.patches, mask, bag.label, bag.tile_indices), seed,
                        do_update)
        return f

    monkeypatch.setattr(st, "make_train_step", half_step)
    out = _train(_train_cell())
    assert not out["correct"]


def test_the_pool_is_the_same_work_for_every_seed():
    tr = {"pool": 8, "positive_share": 0.25, "right_share": 0.5, "pixel_bits": 12}
    a = images.pool(H, W, tr, 1, "cpu")
    b = images.pool(H, W, tr, 2, "cpu")
    assert sorted((m.laterality, m.positive) for m in a) == sorted(
        (m.laterality, m.positive) for m in b)
    nz = lambda p: sorted(int((m.pixels > 0).sum()) // 1000 for m in p)  # noqa: E731
    assert np.allclose(nz(a), nz(b), atol=2)
    assert not np.array_equal(a[0].pixels, b[0].pixels)
