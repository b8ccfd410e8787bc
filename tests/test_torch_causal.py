"""Causal counterfactual dropout on the port against the JAX package (CPU).

The port's ``causal_counterfactual_dropout`` and JAX's run the same
multi-head weights on the same bag (r18, 64x64 patches, 8 instances of
which 2 are masked).  Tolerances:

- ``importance`` (sigmoid of the closed-form dY/dA) within 1e-6 of JAX's
  (sigmoid of ``jax.grad``) in f64; in f32 within 1e-5, as the f32 embeds
  of XLA and PyTorch differ by rounding (about 2e-6 here); the kept
  counterfactual attention within 1e-5;
- each counterfactual prediction within 1e-6 of the pooling and classifier
  recomputed in f64 from its own counterfactual attention;
- ``drop_rates`` over T=512 within 5 standard errors of their expectation
  ``sum over valid n of importance[c, n] / N`` (JAX's division by the bucket
  size ``N``);
- bit-equal outputs for one seed, other masks for another.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from montecarlo_gated_mil_tpu.models import MultiHeadGatedAttentionMIL as JaxMIL
from montecarlo_gated_mil_tpu.models.causal import (
    causal_counterfactual_dropout as jax_counterfactual,
)
from montecarlo_gated_mil_tpu_torch.models.causal import causal_counterfactual_dropout
from montecarlo_gated_mil_tpu_torch.models.gamil import MultiHeadGatedAttentionMIL
from montecarlo_gated_mil_tpu_torch.weights import from_jax_params

N = 8
MASK = np.arange(N) < 6


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the suite runs several worker
    processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=[False, True], ids=["separate", "shared"])
def models(request):
    """A JAX model and the port's on its weights, with the bag."""
    shared = request.param
    x = np.random.default_rng(3).standard_normal((N, 64, 64, 3)).astype(np.float32)
    x *= MASK[:, None, None, None]
    jm = JaxMIL(shared_attention=shared)
    variables = jax.jit(jm.init)(jax.random.key(1), jnp.asarray(x), jnp.asarray(MASK))
    tm = MultiHeadGatedAttentionMIL(shared_attention=shared)
    tm.load_state_dict(from_jax_params(jax.tree.map(np.asarray, variables)))
    return jm, variables, tm, x


def test_importance_and_attention_match_jax(models):
    jm, variables, tm, x = models
    want = jax_counterfactual(jm, variables, jnp.asarray(x), jnp.asarray(MASK), 4,
                              jax.random.key(0))
    got = causal_counterfactual_dropout(tm, x, MASK, 4, 0, device="cpu")
    assert got.counterfactual_predictions.shape == (4, 2)
    assert got.counterfactual_attention.shape == (4, 2, N)
    assert got.importance.shape == (2, N) and got.drop_rates.shape == (2,)
    imp = got.importance.numpy()
    assert np.all((imp > 0) & (imp < 1))
    np.testing.assert_allclose(imp, np.asarray(want.importance), atol=1e-5, rtol=0)
    # Where JAX and the port both keep an instance, they keep the same attention.
    a, b = got.counterfactual_attention.numpy(), np.asarray(want.counterfactual_attention)
    both = (a != 0) & (b != 0)
    np.testing.assert_allclose(a[both], b[both], atol=1e-5, rtol=0)
    assert np.all(a.sum(-1) <= 1.0 + 1e-5)
    assert np.all(a[..., ~MASK] == 0)


@pytest.mark.parametrize("shared", [False, True])
def test_importance_matches_jax_grad_f64(shared):
    """In f64 the embeds agree to rounding, so the closed form and
    ``jax.grad`` give the same importance within 1e-6."""
    jax.config.update("jax_enable_x64", True)
    try:
        x = np.random.default_rng(4).standard_normal((N, 32, 32, 3)) * MASK[:, None, None, None]
        jm = JaxMIL(shared_attention=shared, dtype=jnp.float64)
        params = jax.jit(jm.init)(jax.random.key(1), jnp.asarray(x), jnp.asarray(MASK))
        params = jax.tree.map(lambda a: np.asarray(a, np.float64), params)
        want = jax_counterfactual(jm, jax.tree.map(jnp.asarray, params), jnp.asarray(x),
                                  jnp.asarray(MASK), 2, jax.random.key(0))
        want = np.asarray(want.importance)
    finally:
        jax.config.update("jax_enable_x64", False)
    tm = MultiHeadGatedAttentionMIL(shared_attention=shared, dtype=torch.float64).double()
    tm.load_state_dict(from_jax_params(params))
    got = causal_counterfactual_dropout(tm, x, MASK, 2, 0, device="cpu").importance
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


def test_counterfactual_predictions_recompute_from_their_masks(models):
    _, _, tm, x = models
    got = causal_counterfactual_dropout(tm, x, MASK, 6, 5, device="cpu")
    with torch.no_grad():
        H = tm.embed(torch.from_numpy(x), torch.from_numpy(MASK)).double().numpy()
    w = torch.cat([c.weight for c in tm.classifiers]).detach().double().numpy()  # (C, L)
    a_cf = got.counterfactual_attention.double().numpy()  # (T, C, N)
    want = np.einsum("tcn,nl,cl->tc", a_cf, H, w)
    np.testing.assert_allclose(got.counterfactual_predictions.numpy(), want, atol=1e-6, rtol=0)


def test_drop_rates_near_their_expectation(models):
    """Each instance drops with probability ``importance``; the mean drop
    rate over T samples divides the dropped valid instances by N."""
    _, _, tm, x = models
    T = 512
    got = causal_counterfactual_dropout(tm, x, MASK, T, 7, device="cpu")
    imp = got.importance.double().numpy() * MASK
    expect = imp.sum(-1) / N
    se = np.sqrt((imp * (1 - imp)).sum(-1)) / N / np.sqrt(T)
    rates = got.drop_rates.numpy()
    assert np.all(np.abs(rates - expect) <= 5 * se), (rates, expect, se)
    kept = got.counterfactual_attention.numpy() != 0  # A > 0 on every valid slot
    assert np.all(~kept[..., ~MASK])
    realized = ((~kept) * MASK).sum(-1).mean(0) / N
    np.testing.assert_allclose(rates, realized, atol=1e-6, rtol=0)


def test_deterministic_per_seed(models):
    _, _, tm, x = models
    a = causal_counterfactual_dropout(tm, x, MASK, 5, 2, device="cpu")
    b = causal_counterfactual_dropout(tm, x, MASK, 5, 2, device="cpu")
    c = causal_counterfactual_dropout(tm, x, MASK, 5, 3, device="cpu")
    for f in ("counterfactual_predictions", "counterfactual_attention", "importance",
              "drop_rates"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert not torch.equal(a.counterfactual_attention, c.counterfactual_attention)
