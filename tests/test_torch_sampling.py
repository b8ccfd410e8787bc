"""The port's MC sampling against the JAX package's (CPU).

The uncertainty reductions at even and odd T (1e-6); ``mc_inference`` at
dropout 0 (logits 1e-4, attention 1e-5: the f32 embeds differ by
rounding); ``mc_inference_serial`` bit-equal to ``mc_inference`` with
dropout on; the auxiliary losses of ``targets=`` within 1e-6 of JAX's on
shared features; and the ``ValueError`` for targets on a model without
exactly 2 class heads.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from montecarlo_gated_mil_tpu.mcdo import sampling as js
from montecarlo_gated_mil_tpu_torch.mcdo import sampling as ts


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the suite runs several worker
    processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


@pytest.fixture(scope="module")
def jax_multihead():
    """JAX multi-head models (separate and shared gates) at dropout 0 with
    their parameters, and the port's models on the same weights at dropout
    0 and 0.1: 64x64 patches, 8 instances, 6 valid."""
    import jax

    from montecarlo_gated_mil_tpu.models import MultiHeadGatedAttentionMIL as JaxMIL
    from montecarlo_gated_mil_tpu_torch.models.gamil import MultiHeadGatedAttentionMIL
    from montecarlo_gated_mil_tpu_torch.weights import from_jax_params

    x = np.random.default_rng(11).standard_normal((8, 64, 64, 3)).astype(np.float32)
    mask = np.arange(8) < 6
    out = {}
    for shared in (False, True):
        jm = JaxMIL(feature_dropout=0.0, attention_dropout=0.0, shared_attention=shared)
        variables = jax.jit(jm.init)(jax.random.key(2), jnp.asarray(x), jnp.asarray(mask))
        sd = from_jax_params(jax.tree.map(np.asarray, variables))
        ports = {}
        for p in (0.0, 0.1):
            tm = MultiHeadGatedAttentionMIL(feature_dropout=p, attention_dropout=p,
                                            shared_attention=shared)
            tm.load_state_dict(sd)
            ports[p] = tm
        out[shared] = (jm, variables, ports)
    return x, mask, out


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("target", [None, 0, 1])
def test_mc_inference_serial_equals_mc_inference(jax_multihead, shared, target):
    """Dropout 0.1, separate and shared gates: T serial samples (each a
    T=1 head pass seeded ``seed + t``) equal the batched ``mc_inference``
    bit for bit on the CPU, auxiliary losses included."""
    x, mask, models = jax_multihead
    tm = models[shared][2][0.1]
    a = ts.mc_inference(tm, x, mask, 5, 21, targets=target, device="cpu")
    b = ts.mc_inference_serial(tm, x, mask, 5, 21, targets=target, device="cpu")
    assert torch.equal(a.predictions, b.predictions) and torch.equal(a.attention, b.attention)
    if target is None:
        assert a.aux_losses is None and b.aux_losses is None
    else:
        assert b.aux_losses.shape == (5,) and torch.equal(a.aux_losses, b.aux_losses)
    assert not torch.equal(b.predictions[0], b.predictions[1])


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("target", [0, 1])
@pytest.mark.parametrize("loss_type", ["pairwise", "cosine"])
def test_aux_losses_match_jax_at_dropout_zero(jax_multihead, shared, target, loss_type):
    """``mc_head(..., targets=)`` on shared features: the per-sample scaled
    auxiliary losses within 1e-6 of the JAX package's, for both loss types
    and both labels."""
    import jax

    x, mask, models = jax_multihead
    jm, variables, ports = models[shared]
    jm = jm.clone(aux_loss_type=loss_type)
    tm = ports[0.0]
    tm.aux_loss_type = loss_type
    H = np.abs(np.random.default_rng(12).standard_normal((8, 512))).astype(np.float32)
    want = js.mc_head(jm, variables, jnp.asarray(H), jnp.asarray(mask), 3, jax.random.key(0),
                      targets=jnp.asarray(target))
    with torch.no_grad():
        got = ts.mc_head(tm, torch.from_numpy(H), torch.from_numpy(mask), 3, 0, targets=target)
    tm.aux_loss_type = "pairwise"
    assert got.aux_losses.shape == (3,)
    np.testing.assert_allclose(got.aux_losses.numpy(), np.asarray(want.aux_losses), atol=1e-6,
                               rtol=0)


def test_mc_inference_targets_match_jax_at_dropout_zero(jax_multihead):
    """The whole ``mc_inference`` with ``targets``: logits, attention and
    auxiliary losses against JAX's (1e-4, 1e-5, 1e-5: the f32 embeds differ
    by rounding)."""
    import jax

    x, mask, models = jax_multihead
    jm, variables, ports = models[False]
    want = js.mc_inference(jm, variables, jnp.asarray(x), jnp.asarray(mask), 2,
                           jax.random.key(0), targets=jnp.asarray(1))
    got = ts.mc_inference(ports[0.0], x, mask, 2, 0, targets=1, device="cpu")
    np.testing.assert_allclose(got.predictions.numpy(), np.asarray(want.predictions), atol=1e-4)
    np.testing.assert_allclose(got.attention.numpy(), np.asarray(want.attention), atol=1e-5)
    np.testing.assert_allclose(got.aux_losses.numpy(), np.asarray(want.aux_losses), atol=1e-5)


@pytest.mark.parametrize("num_classes", [1, 3])
def test_targets_need_two_class_heads(num_classes):
    """Targets on a model with other than 2 class heads raise ValueError
    in every path, as in the JAX package."""
    import jax

    from montecarlo_gated_mil_tpu.models import MultiHeadGatedAttentionMIL as JaxMIL
    from montecarlo_gated_mil_tpu_torch.models.gamil import MultiHeadGatedAttentionMIL

    x = np.random.default_rng(13).standard_normal((8, 32, 32, 3)).astype(np.float32)
    jm = JaxMIL(num_classes=num_classes)
    variables = jax.jit(jm.init)(jax.random.key(0), jnp.asarray(x), None)
    with pytest.raises(ValueError, match="exactly 2 class heads"):
        js.mc_inference_serial(jm, variables, jnp.asarray(x), None, 2, jax.random.key(1),
                               targets=jnp.asarray(1))
    tm = MultiHeadGatedAttentionMIL(num_classes=num_classes)
    for fn in (ts.mc_inference, ts.mc_inference_serial):
        with pytest.raises(ValueError, match="exactly 2 class heads"):
            fn(tm, x, None, 2, 1, targets=1, device="cpu")
    with pytest.raises(ValueError, match="exactly 2 class heads"):
        ts.mc_head(tm, torch.rand(8, 512), None, 2, 1, targets=torch.tensor(0))
