"""Port's MC uncertainty reductions vs the JAX package's, at even and odd T."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from montecarlo_gated_mil_tpu.mcdo import sampling as js
from montecarlo_gated_mil_tpu_torch.mcdo import sampling as ts


@pytest.mark.parametrize("T", [30, 31, 50, 2])
def test_predictive_stats_match_jax(T):
    """Even T exercises the median's average of the two middle values
    (``torch.median`` would return the lower one); std is ddof=0."""
    rng = np.random.default_rng(T)
    y = (rng.standard_normal((T, 2)) * 2).astype(np.float32)
    got = ts.predictive_stats(torch.from_numpy(y))
    want = js.predictive_stats(jnp.asarray(y))
    for field in ("mean_probs", "mean", "std", "median", "iqr", "low", "high", "mean_entropy"):
        np.testing.assert_allclose(
            getattr(got, field).numpy(), np.asarray(getattr(want, field)), atol=1e-6,
            err_msg=field,
        )
    assert int(got.prediction) == int(want.prediction)


@pytest.mark.parametrize("T", [30, 31, 1])
def test_attention_stats_match_jax(T):
    """std is ddof=1; padded slots are exactly zero; T=1 gives zero spread.
    The tolerance covers f32 summation order over T."""
    rng = np.random.default_rng(10 + T)
    mask = np.arange(9) < 6
    a = rng.random((T, 2, 9)).astype(np.float32) * mask
    got = ts.attention_stats(torch.from_numpy(a), torch.from_numpy(mask))
    want = js.attention_stats(jnp.asarray(a), jnp.asarray(mask))
    for field in ("mean", "std", "var"):
        np.testing.assert_allclose(
            getattr(got, field).numpy(), np.asarray(getattr(want, field)), atol=1e-6,
            err_msg=field,
        )
    assert np.all(got.mean.numpy()[:, 6:] == 0) and np.all(got.std.numpy()[:, 6:] == 0)


def test_interpret_entropy_buckets():
    for h in (0.0, 0.25, 0.5, 0.9):
        assert ts.interpret_entropy(h) == js.interpret_entropy(h)


def test_mc_inference_matches_jax_at_dropout_zero():
    """Embed once, then T head samples: at dropout 0 every sample equals the
    JAX package's ``mc_inference`` on the same weights."""
    import jax

    from montecarlo_gated_mil_tpu.models import MultiHeadGatedAttentionMIL as JaxMIL
    from montecarlo_gated_mil_tpu_torch.models.gamil import MultiHeadGatedAttentionMIL
    from montecarlo_gated_mil_tpu_torch.weights import from_jax_params

    jmodel = JaxMIL(feature_dropout=0.0, attention_dropout=0.0, shared_attention=False)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((6, 96, 96, 3)).astype(np.float32)
    mask = np.array([True, True, False, True, True, True])
    variables = jax.jit(jmodel.init)(jax.random.key(0), jnp.asarray(x), jnp.asarray(mask))
    want = js.mc_inference(
        jmodel, variables, jnp.asarray(x), jnp.asarray(mask), 3, jax.random.key(1)
    )
    tmodel = MultiHeadGatedAttentionMIL(
        feature_dropout=0.0, attention_dropout=0.0, shared_attention=False
    )
    tmodel.load_state_dict(from_jax_params(jax.tree.map(np.asarray, variables)))
    got = ts.mc_inference(tmodel, x, mask, 3, 1, device="cpu")
    np.testing.assert_allclose(got.predictions.numpy(), np.asarray(want.predictions), atol=1e-4)
    np.testing.assert_allclose(got.attention.numpy(), np.asarray(want.attention), atol=1e-5)
    with pytest.raises(ValueError, match="model is on"):
        ts.mc_inference(tmodel, x, mask, 3, 1, device="meta")
