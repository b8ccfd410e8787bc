"""The single-head GA-MIL on the port against the JAX package (CPU).

The port's ``GatedAttentionMIL`` is loaded with the JAX model's weights
(``weights.from_jax_singlehead_params``) and run on the same bags: r18 at
64x64 patches, 8 instances of which 2 are masked.  Tolerances:

- full forward at dropout 0: Y within 1e-4, A within 1e-5 (f32 embeds of
  XLA and PyTorch differ by rounding); the head alone on shared features
  within 1e-6;
- the weights' round trip through ``models/port.py::port_singlehead_gamil``
  bit for bit, both ways;
- ``mc_inference_single_head`` at dropout 0: every sample within 1e-4 of
  JAX's sigmoid output (A within 1e-5); with dropout on, bit-equal to a
  recomputation from the same Philox masks, and over T=256 samples its mean
  P and mean attention within 5 standard errors of JAX's (the streams
  differ by design), its std of P within 30 % of JAX's;
- ``train_epoch_plain``: 3 SGD steps at dropout 0 in f64, every parameter
  within 1e-8 of JAX's, ``step`` 3, and the same metric records (values
  within 1e-8).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from montecarlo_gated_mil_tpu.core.bag import Bag as JaxBag
from montecarlo_gated_mil_tpu.mcdo import sampling as js
from montecarlo_gated_mil_tpu.models import GatedAttentionMIL as JaxGAMIL
from montecarlo_gated_mil_tpu.models.port import port_singlehead_gamil
from montecarlo_gated_mil_tpu.train import loops as jloops
from montecarlo_gated_mil_tpu.train import state as jstate
from montecarlo_gated_mil_tpu.utils.metrics import MemorySink as JaxMemorySink
from montecarlo_gated_mil_tpu.utils.metrics import Metrics as JaxMetrics
from montecarlo_gated_mil_tpu_torch.core.bag import Bag
from montecarlo_gated_mil_tpu_torch.mcdo import sampling as ts
from montecarlo_gated_mil_tpu_torch.models import gamil as tgamil
from montecarlo_gated_mil_tpu_torch.models.gamil import GatedAttentionMIL
from montecarlo_gated_mil_tpu_torch.ops import gated_attention as tga
from montecarlo_gated_mil_tpu_torch.ops.masked import masked_softmax
from montecarlo_gated_mil_tpu_torch.train import loops as tloops
from montecarlo_gated_mil_tpu_torch.train.state import TrainState
from montecarlo_gated_mil_tpu_torch.utils.metrics import MemorySink, Metrics
from montecarlo_gated_mil_tpu_torch.weights import from_jax_singlehead_params

N, HW = 8, 64
MASK = np.arange(N) < 6
SHAPES = [(1, 1), (2, 2)]  # (K attention heads, num_classes)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the suite runs several worker
    processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _patches(seed: int) -> np.ndarray:
    x = np.random.default_rng(seed).standard_normal((N, HW, HW, 3)).astype(np.float32)
    return x * MASK[:, None, None, None]


def _np_params(variables) -> dict:
    return jax.tree.map(np.asarray, variables["params"])


@pytest.fixture(scope="module")
def jax_models():
    """JAX single-head models at dropout 0 and 0.25 per (K, C), with their
    initial parameters (one init per shape, shared by both rates)."""
    out = {}
    x = jnp.asarray(_patches(0))
    for K, C in SHAPES:
        init = jax.jit(JaxGAMIL(num_classes=C, K=K).init)
        variables = init({"params": jax.random.key(K), "dropout": jax.random.key(0)}, x,
                         jnp.asarray(MASK))
        for p in (0.0, 0.25):
            out[K, C, p] = (JaxGAMIL(num_classes=C, K=K, feature_dropout=p,
                                     attention_dropout=p), variables)
    return out


def _port(jax_models, K, C, p, dtype=torch.float32) -> GatedAttentionMIL:
    _, variables = jax_models[K, C, p]
    tm = GatedAttentionMIL(num_classes=C, K=K, feature_dropout=p, attention_dropout=p,
                           dtype=dtype).to(dtype)
    tm.load_state_dict(from_jax_singlehead_params(_np_params(variables)))
    return tm


@pytest.mark.parametrize("K, C", SHAPES)
def test_forward_matches_jax_at_dropout_zero(jax_models, K, C):
    jm, variables = jax_models[K, C, 0.0]
    x = _patches(1)
    y_j, a_j = jm.apply(variables, jnp.asarray(x), jnp.asarray(MASK))
    with torch.no_grad():
        y_t, a_t = _port(jax_models, K, C, 0.0)(torch.from_numpy(x), torch.from_numpy(MASK))
    assert y_t.shape == (C,) and a_t.shape == (K, N)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=1e-4, rtol=0)
    np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), atol=1e-5, rtol=0)
    assert np.all(a_t.numpy()[:, ~MASK] == 0)


@pytest.mark.parametrize("K, C", SHAPES)
@pytest.mark.parametrize("masked", [True, False])
def test_head_matches_jax_on_shared_features(jax_models, K, C, masked):
    """The head alone on the same features ``H``, with and without a mask."""
    jm, variables = jax_models[K, C, 0.0]
    H = np.abs(np.random.default_rng(2).standard_normal((N, 512))).astype(np.float32)
    mask = MASK if masked else None
    y_j, a_j = jm.apply(variables, jnp.asarray(H), None if mask is None else jnp.asarray(mask),
                        method="head")
    with torch.no_grad():
        y_t, a_t = _port(jax_models, K, C, 0.0).head(
            torch.from_numpy(H), None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=1e-6, rtol=0)
    np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), atol=1e-6, rtol=0)


@pytest.mark.parametrize("K, C", SHAPES)
def test_weights_round_trip_through_port_singlehead_gamil(jax_models, K, C):
    """JAX params -> port state_dict -> ``port_singlehead_gamil`` gives the
    JAX params back, and the port's state_dict survives the other way
    round, bit for bit."""
    _, variables = jax_models[K, C, 0.0]
    want = _np_params(variables)
    back = port_singlehead_gamil(
        {k: v.numpy() for k, v in from_jax_singlehead_params(want).items()})["params"]
    flat_w, flat_b = jax.tree_util.tree_flatten_with_path(want)[0], dict(
        jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_w) == len(flat_b)
    for path, leaf in flat_w:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), leaf, err_msg=str(path))
    torch.manual_seed(5)
    sd = GatedAttentionMIL(num_classes=C, K=K).state_dict()
    again = from_jax_singlehead_params(port_singlehead_gamil(
        {k: v.numpy() for k, v in sd.items()}))
    assert set(again) == {k for k in sd if not k.endswith("num_batches_tracked")}
    for k, v in again.items():
        assert torch.equal(v, sd[k]), k


def test_mc_inference_single_head_matches_jax_at_dropout_zero(jax_models):
    jm, variables = jax_models[1, 1, 0.0]
    x = _patches(3)
    want = js.mc_inference_single_head(jm, variables, jnp.asarray(x), jnp.asarray(MASK), 4,
                                       jax.random.key(0))
    got = ts.mc_inference_single_head(_port(jax_models, 1, 1, 0.0), x, MASK, 4, 0,
                                      device="cpu")
    assert got.aux_losses is None and got.predictions.shape == (4, 1)
    assert got.attention.shape == (4, 1, N)
    p = got.predictions.numpy()
    assert np.all((p >= 0) & (p <= 1))
    np.testing.assert_allclose(p, np.asarray(want.predictions), atol=1e-4, rtol=0)
    np.testing.assert_allclose(got.attention.numpy(), np.asarray(want.attention), atol=1e-5,
                               rtol=0)


def _recompute(tm: GatedAttentionMIL, H, mask, seed, p):
    """One MC sample of the single-head head written out, from the three
    Philox masks keyed on ``seed`` (draws 0, 1 and 2)."""

    def drop(x, draw):
        u = tga.dropout_uniform(seed, draw, x.numel(), "cpu").view(x.shape)
        return x * (u >= p).to(torch.float32) * (1.0 / (1.0 - p))

    Hd = drop(H, tga.FEATURE_DRAW)
    V = drop(torch.tanh(F.linear(Hd, tm.attention_V[0].weight, tm.attention_V[0].bias)),
             tgamil.V_DRAW)
    U = drop(torch.sigmoid(F.linear(Hd, tm.attention_U[0].weight, tm.attention_U[0].bias)),
             tgamil.U_DRAW)
    logits = F.linear(V * U, tm.attention_weights.weight, tm.attention_weights.bias).T
    A = masked_softmax(logits, mask[None, :])
    y = F.linear((A @ Hd).reshape(-1), tm.classifier[0].weight, tm.classifier[0].bias)
    return torch.sigmoid(y), A


@pytest.mark.parametrize("K, C", SHAPES)
def test_mc_inference_single_head_dropout_masks_are_the_philox_masks(jax_models, K, C):
    """With dropout on, sample t equals the head written out from the masks
    of key ``seed + t``, and a second run reproduces the first."""
    tm = _port(jax_models, K, C, 0.25)
    x, mask = torch.from_numpy(_patches(4)), torch.from_numpy(MASK)
    got = ts.mc_inference_single_head(tm, x, mask, 5, 17, device="cpu")
    again = ts.mc_inference_single_head(tm, x, mask, 5, 17, device="cpu")
    assert torch.equal(got.predictions, again.predictions)
    assert torch.equal(got.attention, again.attention)
    with torch.no_grad():
        H = tm.embed(x, mask)
        for t in range(5):
            p_t, a_t = _recompute(tm, H, mask, 17 + t, 0.25)
            torch.testing.assert_close(got.predictions[t], p_t, atol=0, rtol=0)
            torch.testing.assert_close(got.attention[t], a_t, atol=0, rtol=0)
    assert not torch.equal(got.predictions[0], got.predictions[1])


def test_mc_inference_single_head_matches_jax_statistically(jax_models):
    """Dropout 0.25 over T=256: the two packages' streams differ, their
    statistics agree.  Mean P and each valid slot's mean attention within 5
    standard errors of the difference; std of P within 30 % (the standard
    error of a std over 256 samples is about 4.4 %)."""
    T = 256
    jm, variables = jax_models[1, 1, 0.25]
    x = _patches(5)
    want = js.mc_inference_single_head(jm, variables, jnp.asarray(x), jnp.asarray(MASK), T,
                                       jax.random.key(9))
    got = ts.mc_inference_single_head(_port(jax_models, 1, 1, 0.25), x, MASK, T, 9,
                                      device="cpu")
    for a, b in ((got.predictions.numpy()[:, 0], np.asarray(want.predictions)[:, 0]),
                 *((got.attention.numpy()[:, 0, n], np.asarray(want.attention)[:, 0, n])
                   for n in np.flatnonzero(MASK))):
        se = np.sqrt(a.var() / T + b.var() / T)
        assert abs(a.mean() - b.mean()) <= 5 * se + 1e-7, (a.mean(), b.mean(), se)
    sp, sj = got.predictions.numpy().std(), np.asarray(want.predictions).std()
    assert sp > 0 and abs(sp / sj - 1) <= 0.3, (sp, sj)


class _x64:
    def __enter__(self):
        jax.config.update("jax_enable_x64", True)

    def __exit__(self, *exc):
        jax.config.update("jax_enable_x64", False)


def test_train_epoch_plain_matches_jax_f64():
    """Three bags, one SGD step each, dropout 0, f64: every parameter after
    the epoch within 1e-8 of JAX's ``train_epoch_plain``, ``step`` 3, the
    same metric records and the same printed line."""
    import optax

    rng = np.random.default_rng(6)
    x = rng.standard_normal((N, HW, HW, 3)) * MASK[:, None, None, None]
    with _x64():
        jm = JaxGAMIL(feature_dropout=0.0, attention_dropout=0.0, dtype=jnp.float64)
        params = jax.jit(jm.init)(jax.random.key(0), jnp.asarray(x), jnp.asarray(MASK))["params"]
        params = jax.tree.map(lambda a: np.asarray(a, np.float64), params)
        jbags = [(JaxBag(patches=jnp.asarray(x * (0.5 + 0.1 * i)), mask=jnp.asarray(MASK),
                         label=jnp.asarray(i % 2, jnp.int32), tile_indices=jnp.arange(N)), None)
                 for i in range(3)]
        opt = optax.sgd(0.05)
        jst = jstate.TrainState.create(jax.tree.map(jnp.asarray, params), opt)
        jsink = JaxMemorySink()
        jst = jloops.train_epoch_plain(jm, jst, jbags, opt, epoch=1, key=jax.random.key(3),
                                       metrics=JaxMetrics([jsink]))
        want = from_jax_singlehead_params(jax.tree.map(np.asarray, jst.params))
    tm = GatedAttentionMIL(feature_dropout=0.0, attention_dropout=0.0,
                           dtype=torch.float64).to(torch.float64)
    tm.load_state_dict(from_jax_singlehead_params(params))
    tbags = [(Bag(torch.from_numpy(x * (0.5 + 0.1 * i)), torch.from_numpy(MASK),
                  torch.tensor(i % 2), torch.arange(N)), None) for i in range(3)]
    opt_t = torch.optim.SGD(tm.parameters(), lr=0.05)
    sink = MemorySink()
    state = tloops.train_epoch_plain(tm, TrainState(tm, opt_t), tbags, opt_t, epoch=1, key=3,
                                     metrics=Metrics([sink]))
    assert state.step == 3 and int(jst.step) == 3
    got = tm.state_dict()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=1e-8, rtol=0,
                                   err_msg=k)
    assert [(n, s) for n, _, s in sink.records] == [(n, s) for n, _, s in jsink.records]
    np.testing.assert_allclose([v for _, v, _ in sink.records],
                               [v for _, v, _ in jsink.records], atol=1e-8, rtol=0)


def test_train_epoch_plain_seeds_each_step_from_the_key(monkeypatch):
    """Bag ``i`` of epoch ``e`` trains with dropout seed
    ``fold_in(fold_in(key, e), i)``, and the optimizer steps once a bag."""
    from montecarlo_gated_mil_tpu_torch.core import rng

    torch.manual_seed(0)
    tm = GatedAttentionMIL()
    seeds = []
    real_head = tm.head

    def spy(H, mask=None, **kw):
        seeds.append(kw["seed"])
        assert kw["train"]
        return real_head(H, mask, **kw)

    monkeypatch.setattr(tm, "head", spy)
    x = torch.from_numpy(_patches(7))
    bags = [(Bag(x, torch.from_numpy(MASK), torch.tensor(i % 2), torch.arange(N)), None)
            for i in range(2)]
    opt = torch.optim.SGD(tm.parameters(), lr=1e-3)
    state = tloops.train_epoch_plain(tm, TrainState(tm, opt), bags, opt, epoch=4, key=11)
    assert state.step == 2
    assert seeds == [rng.fold_in(rng.fold_in(11, 4), i) for i in range(2)]
