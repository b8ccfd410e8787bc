"""The slice whole: the port's MCDOPredictor against the JAX package's, and
the port's independence from JAX."""

import ast
import subprocess
import sys
import threading
import time
import weakref
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from montecarlo_gated_mil_tpu.data.pipeline import PipelineConfig as JaxPipelineConfig
from montecarlo_gated_mil_tpu.models import MultiHeadGatedAttentionMIL as JaxMIL
from montecarlo_gated_mil_tpu.serve import MCDOPredictor as JaxPredictor
from montecarlo_gated_mil_tpu_torch.core.config import Config, config_from_dict
from montecarlo_gated_mil_tpu_torch.data.pipeline import PipelineConfig
from montecarlo_gated_mil_tpu_torch.data.synthetic import synthetic_image
from montecarlo_gated_mil_tpu_torch.experiment import build_model
from montecarlo_gated_mil_tpu_torch.models.gamil import MultiHeadGatedAttentionMIL
from montecarlo_gated_mil_tpu_torch.serve import MCDOPredictor
from montecarlo_gated_mil_tpu_torch.weights import from_jax_params
from test_torch_viz import _np_box_mean

# test_serve.py's geometry
PIPE = dict(height=128, width=128, patch_size=64, overlap=0.0, empty_threshold=0.05, bucket=8)


def _port_predictor(p, num_samples=4, seed=0):
    model = MultiHeadGatedAttentionMIL(
        feature_dropout=p, attention_dropout=p, shared_attention=False
    )
    cfg = Config(shared_att=False)
    model.load_state_dict(build_model(cfg, seed=seed).state_dict())
    return MCDOPredictor(model, PipelineConfig(**PIPE), num_samples=num_samples, device="cpu")


def test_predictor_matches_jax_at_dropout_zero():
    """Dropout 0, the same weights: the port's whole request path (bag
    extraction, r18 embed, MC head, stats) against the JAX predictor, for
    float and uint16 input."""
    jmodel = JaxMIL(feature_dropout=0.0, attention_dropout=0.0, shared_attention=False)
    x = jnp.zeros((2, 64, 64, 3))
    params = jax.tree.map(
        np.asarray, jax.jit(jmodel.init)(jax.random.key(0), x, jnp.ones(2, bool))["params"]
    )
    jpred = JaxPredictor(
        jmodel, params, JaxPipelineConfig(**PIPE), num_samples=4, use_pallas=False
    )
    tmodel = MultiHeadGatedAttentionMIL(
        feature_dropout=0.0, attention_dropout=0.0, shared_attention=False
    )
    tmodel.load_state_dict(from_jax_params(params))
    tpred = MCDOPredictor(tmodel, PipelineConfig(**PIPE), num_samples=4, device="cpu")

    img16 = np.round(synthetic_image(128, 128, positive=True, seed=1) * 65535).astype(np.uint16)
    img = (img16 / 65535.0).astype(np.float32)
    want = jpred.predict(img, "R", seed=3)
    for image in (img, img16):
        got = tpred.predict(image, "R", seed=3)
        assert got.num_instances == want.num_instances > 0
        assert got.prediction == want.prediction
        for f in ("mean_probs", "mean", "std", "median", "iqr", "low", "high", "mean_entropy"):
            np.testing.assert_allclose(
                np.asarray(getattr(got.stats, f)), np.asarray(getattr(want.stats, f)),
                atol=1e-4, err_msg=f,
            )
        for f in ("mean", "std", "var"):
            np.testing.assert_allclose(
                np.asarray(getattr(got.attention, f)), np.asarray(getattr(want.attention, f)),
                atol=1e-4, err_msg=f,
            )


def test_dropout_on_is_deterministic_per_seed():
    pred = _port_predictor(0.1)
    img = synthetic_image(128, 128, positive=False, seed=2)
    a, b = pred.predict(img, "L", seed=11), pred.predict(img, "L", seed=11)
    c = pred.predict(img, "L", seed=12)
    assert torch.equal(a.stats.mean_probs, b.stats.mean_probs)
    assert torch.equal(a.attention.mean, b.attention.mean)
    assert not torch.equal(a.stats.mean_probs, c.stats.mean_probs)
    many = pred.predict_many([img, img], ["L", "L"], seeds=[11, 12])
    assert torch.equal(many[0].attention.mean, a.attention.mean)
    assert torch.equal(many[1].attention.mean, c.attention.mean)
    att = a.attention.mean
    n = a.num_instances
    torch.testing.assert_close(att[:, :n].sum(-1), torch.ones(2), atol=1e-5, rtol=0)
    assert torch.all(att[:, n:] == 0)


def test_unported_options_raise():
    pred = _port_predictor(0.0)
    assert pred.quantized is False
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        MCDOPredictor(pred.model, PipelineConfig(**PIPE), quantized=True, device="cpu")


def test_predict_returns_maps():
    """``return_maps``: per-class mean and std maps at full resolution,
    peak-normalized; ``map_downsample=k`` is their exact box mean (3 and 48
    leave partial edge windows at 128); the statistics do not change."""
    pred = _port_predictor(0.1)
    img = synthetic_image(128, 128, positive=True, seed=3)
    plain = pred.predict(img, "R", seed=5)
    full = pred.predict(img, "R", seed=5, return_maps=True)
    assert plain.attention_mean_maps is None and plain.attention_std_maps is None
    assert torch.equal(full.stats.mean_probs, plain.stats.mean_probs)
    assert torch.equal(full.attention.mean, plain.attention.mean)
    for m in (full.attention_mean_maps, full.attention_std_maps):
        assert isinstance(m, np.ndarray) and m.shape == (2, 128, 128) and m.dtype == np.float32
    peaks = full.attention_mean_maps.max(axis=(1, 2))  # mean over T of maps with peak 1
    assert np.all(peaks <= 1.0) and np.all(peaks > 0.5)
    assert full.attention_std_maps.min() >= 0 and full.attention_std_maps.max() > 0
    for k in (3, 48):
        small = pred.predict(img, "R", seed=5, return_maps=True, map_downsample=k)
        for name in ("attention_mean_maps", "attention_std_maps"):
            got = getattr(small, name)
            assert got.shape == (2, -(-128 // k), -(-128 // k))
            np.testing.assert_allclose(got, _np_box_mean(getattr(full, name), k), atol=1e-6)
    with pytest.raises(ValueError, match="map_downsample"):
        pred.predict(img, return_maps=True, map_downsample=0)


def test_queued_uploads_are_bounded():
    """Eight concurrent callers on a predictor with ``max_inflight=1``: no
    more than 2 uploaded images are alive at once (counted from the upload
    until the tensor is freed).  With the bound lifted, the same callers
    hold more, so the count does see queued uploads."""
    img = synthetic_image(128, 128, positive=True, seed=6)

    def peak_resident(pred):
        lock, state = threading.Lock(), {"now": 0, "peak": 0}
        upload, infer = pred._upload, pred._infer

        def release():
            with lock:
                state["now"] -= 1

        def counting_upload(arr):
            t = upload(arr)
            with lock:
                state["now"] += 1
                state["peak"] = max(state["peak"], state["now"])
            weakref.finalize(t, release)
            return t

        def slow_infer(*args):
            time.sleep(0.05)  # callers pile up behind the gate
            return infer(*args)

        pred._upload, pred._infer = counting_upload, slow_infer
        out = {}
        threads = [threading.Thread(target=lambda i=i: out.__setitem__(i, pred.predict(img, seed=i)))
                   for i in range(8)]
        interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)
        try:
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
        finally:
            sys.setswitchinterval(interval)
        assert not any(t.is_alive() for t in threads) and len(out) == 8
        assert state["now"] == 0
        return state["peak"]

    assert peak_resident(_port_predictor(0.0, num_samples=2)) <= 2
    unbounded = _port_predictor(0.0, num_samples=2)
    unbounded._upload_slots = threading.BoundedSemaphore(8)
    assert peak_resident(unbounded) > 2


def test_background_warmup_routes_to_warm_bucket():
    """``warmup(background=True)`` warms the cap bucket before it returns
    and the rest in the thread it returns; while it runs, a request whose
    bucket is cold runs at the smallest warm bucket that holds it, with the
    same result at dropout 0."""
    from montecarlo_gated_mil_tpu_torch.core.bag import BucketSpec

    model = _port_predictor(0.0).model
    pred = MCDOPredictor(model, PipelineConfig(**PIPE), num_samples=2,
                         bucket_spec=BucketSpec((2, 4, 8)), device="cpu")
    sparse = np.zeros((128, 128), np.float32)
    sparse[:64, :64] = 0.8  # one filled tile: bucket 2
    assert pred._pick_bucket(sparse, "L") == 2
    pred._warm, pred._warming = frozenset({4, 8}), True  # as while warming
    routed = pred.predict(sparse, seed=5)
    assert routed.bucket == 4 and routed.attention.mean.shape == (2, 4)
    pred._warm, pred._warming = frozenset(), False

    thread = pred.warmup(dtypes=(np.float32,), background=True)
    assert 8 in pred._warm  # the cap bucket, before returning
    thread.join(timeout=120)
    assert not thread.is_alive() and not pred._warming
    assert pred._warm == {2, 4, 8}
    own = pred.predict(sparse, seed=5)
    assert own.bucket == 2 and own.prediction == routed.prediction
    torch.testing.assert_close(own.stats.mean_probs, routed.stats.mean_probs, atol=1e-6, rtol=0)
    assert pred.warmup(dtypes=(np.float32,)) is None


def test_oversized_bucket_pick_equals_jax():
    """Host bucket pick, oversize extension included: both packages run the
    same numpy estimator and decision, so they pick identical buckets."""
    pipe = dict(height=256, width=256, patch_size=32, overlap=0.5, empty_threshold=0.5, bucket=16)
    from montecarlo_gated_mil_tpu.core.bag import BucketSpec as JaxBucketSpec
    from montecarlo_gated_mil_tpu_torch.core.bag import BucketSpec

    jpred = JaxPredictor(
        JaxMIL(), None, JaxPipelineConfig(**pipe), use_pallas=False,
        bucket_spec=JaxBucketSpec((8, 16)),
    )
    tpred = MCDOPredictor(
        MultiHeadGatedAttentionMIL(), PipelineConfig(**pipe),
        bucket_spec=BucketSpec((8, 16)), device="cpu",
    )
    picked = set()
    for seed in range(4):
        img = synthetic_image(256, 256, positive=bool(seed % 2), seed=seed)
        for lat in ("L", "R"):
            b = tpred._pick_bucket(img, lat)
            assert b == jpred._pick_bucket(img, lat)
            picked.add(b)
    assert max(picked) > 16  # extended past the cap, every tile kept
    assert tpred._pick_bucket(np.zeros((256, 256), np.float32), "L") == 8


def test_from_config_builds_the_shipped_geometry():
    cfg = config_from_dict({"tpu": {"buckets": [64, 128]}})
    sd = build_model(cfg, seed=0).state_dict()
    pred = MCDOPredictor.from_config(cfg, sd, device="cpu")
    assert pred.num_samples == 50 and pred.pipeline.overlap == 0.75
    assert pred._grid.num_tiles == 5781 and pred.pipeline.bucket == 128
    assert not pred.model.shared_attention


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "import montecarlo_gated_mil_tpu_torch.serve, montecarlo_gated_mil_tpu_torch.weights\n"
        "import montecarlo_gated_mil_tpu_torch.ops.cuda_build\n"
        "import montecarlo_gated_mil_tpu_torch.server, montecarlo_gated_mil_tpu_torch.cli\n"
        "import montecarlo_gated_mil_tpu_torch.viz.attention\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib', 'flax'))"
        " or m == 'montecarlo_gated_mil_tpu' or m.startswith('montecarlo_gated_mil_tpu.')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


def test_no_jax_import_statement_in_port_or_chip_smoke():
    """Every import statement of the port's modules and of chip_smoke.py,
    those inside functions included, names neither JAX nor the JAX package."""
    repo = Path(__file__).resolve().parents[1]
    files = sorted((repo / "montecarlo_gated_mil_tpu_torch").rglob("*.py"))
    files.append(repo / "chip_smoke.py")
    bad = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path.name}: {n}" for n in names
                    if n.split(".")[0] in ("jax", "jaxlib", "flax", "montecarlo_gated_mil_tpu")]
    assert len(files) > 30 and not bad, bad
