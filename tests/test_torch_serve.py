"""The slice whole: the port's MCDOPredictor against the JAX package's, and
the port's independence from JAX."""

import subprocess
import sys

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
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        pred.predict(np.zeros((128, 128), np.float32), return_maps=True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        MCDOPredictor(pred.model, PipelineConfig(**PIPE), quantized=True, device="cpu")


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
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib', 'flax'))"
        " or m == 'montecarlo_gated_mil_tpu' or m.startswith('montecarlo_gated_mil_tpu.')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
