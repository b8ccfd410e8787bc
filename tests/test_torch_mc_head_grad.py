"""Gradients of the MC gated-attention head: the plain version of the
backward kernels (K4/K5) against the JAX package's custom VJP and against
torch autograd, the ``autograd.Function`` that runs the kernels on the card,
the head's gradients in the model, and a train step through the kernels'
JAX twins (CPU; the kernels themselves are held against these on the card
by ``chip_smoke.py`` and ``test_torch_kernels_gpu.py``)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from montecarlo_gated_mil_tpu.core import config as jcfg
from montecarlo_gated_mil_tpu.core.bag import Bag as JaxBag
from montecarlo_gated_mil_tpu.models import MultiHeadGatedAttentionMIL as JaxMIL
from montecarlo_gated_mil_tpu.models import gamil as jgamil
from montecarlo_gated_mil_tpu.ops import gated_attention as jga
from montecarlo_gated_mil_tpu.train import criteria as jcrit
from montecarlo_gated_mil_tpu.train import optim as joptim
from montecarlo_gated_mil_tpu.train import state as jstate
from montecarlo_gated_mil_tpu_torch.core import config as tcfg
from montecarlo_gated_mil_tpu_torch.core.bag import Bag
from montecarlo_gated_mil_tpu_torch.models import gamil as tgamil
from montecarlo_gated_mil_tpu_torch.models.resnet import _MaskedBatchNorm
from montecarlo_gated_mil_tpu_torch.ops import gated_attention as tga
from montecarlo_gated_mil_tpu_torch.train import criteria as tcrit
from montecarlo_gated_mil_tpu_torch.train import optim as toptim
from montecarlo_gated_mil_tpu_torch.train.state import TrainState, make_train_step
from montecarlo_gated_mil_tpu_torch.weights import from_jax_params


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the suite runs several worker
    processes at once, and oversubscribed OpenMP threads slow these many
    small CPU ops down tenfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


FIELDS = ("w_V", "b_V", "w_U", "b_U", "w_att", "b_att")


def _params_np(seed, L=128, D=32, C=2, separate=False, scale=0.05):
    rng = np.random.default_rng(seed)

    def r(*shape):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    if separate:
        return dict(w_V=r(C, L, D), b_V=r(C, D), w_U=r(C, L, D), b_U=r(C, D),
                    w_att=r(C, D), b_att=r(C), w_cls=r(C, L))
    return dict(w_V=r(L, D), b_V=r(D), w_U=r(L, D), b_U=r(D),
                w_att=r(D, C), b_att=r(C), w_cls=r(C, L))


def _inputs(seed, N, L, T, C=2, n_valid=None):
    rng = np.random.default_rng(seed)
    H = np.abs(rng.standard_normal((N, L))).astype(np.float32)
    mask = np.arange(N) < (n_valid if n_valid is not None else N - N // 4)
    dY = rng.standard_normal((T, C)).astype(np.float32)
    dA = (rng.standard_normal((T, C, N)) * 0.1).astype(np.float32)
    return H, mask, dY, dA


def _autograd_grads(H, mask, params, T, seed, p, dY, dA):
    """Gradients of ``sum(Y dY) + sum(A dA)`` by autograd of the plain head."""
    leaves = [H.clone().requires_grad_(True)] + [
        getattr(params, f).clone().requires_grad_(True) for f in FIELDS
    ]
    prm = tga.GatedAttentionParams(*leaves[1:], params.w_cls)
    y, a = tga.mc_head_reference(leaves[0], mask, prm, T, seed, p, p)
    return torch.autograd.grad((y * dY).sum() + (a * dA).sum(), leaves)


@pytest.mark.parametrize("separate", [False, True])
def test_backward_twin_matches_jax_custom_vjp(separate):
    """Dropout 0: ``mc_head_backward_reference`` equals the VJP of JAX
    ``mc_gated_attention_fused`` (its Pallas backward, interpreted) for dH
    and every head weight, at the JAX package's CPU tolerance 2e-5."""
    N, L, T = 64, 128, 3
    H, mask, dY, dA = _inputs(1, N, L, T)
    p = _params_np(0, L=L, separate=separate)
    jp = jga.GatedAttentionParams(**{k: jnp.asarray(v) for k, v in p.items()})
    tp = tga.GatedAttentionParams(**{k: torch.from_numpy(v) for k, v in p.items()})

    def f(h, prm):
        return jga.mc_gated_attention_fused(h, jnp.asarray(mask), prm, T,
                                            jnp.asarray(1, jnp.int32), 0.0, 0.0, interpret=True)

    _, vjp = jax.vjp(f, jnp.asarray(H), jp)
    jdH, jdp = vjp((jnp.asarray(dY), jnp.asarray(dA)))
    dM = torch.from_numpy(dY)[:, :, None] * tp.w_cls[None]
    got = tga.mc_head_backward_reference(torch.from_numpy(H), torch.from_numpy(mask), tp, T, 1,
                                         0.0, 0.0, dM, torch.from_numpy(dA))
    want = [jdH] + [getattr(jdp, f) for f in FIELDS]
    for name, g, w in zip(("H",) + FIELDS, got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5, err_msg=name)
    assert np.all(got[0].numpy()[~mask] == 0)


@pytest.mark.parametrize("separate", [False, True])
@pytest.mark.parametrize("p", [0.0, 0.1])
def test_backward_twin_matches_autograd(separate, p):
    """With dropout off and on (the same Philox masks replayed), the plain
    backward equals torch autograd of the plain forward within 1e-6, T=3."""
    N, L, T = 40, 64, 3
    H, mask, dY, dA = _inputs(2, N, L, T)
    tp = tga.GatedAttentionParams(**{
        k: torch.from_numpy(v) for k, v in _params_np(3, L=L, D=16, separate=separate).items()
    })
    H, mask, dY, dA = (torch.from_numpy(x) for x in (H, mask, dY, dA))
    want = _autograd_grads(H, mask, tp, T, 9, p, dY, dA)
    got = tga.mc_head_backward_reference(H, mask, tp, T, 9, p, p, dY[:, :, None] * tp.w_cls, dA)
    for name, g, w in zip(("H",) + FIELDS, got, want):
        torch.testing.assert_close(g, w, atol=1e-6, rtol=0, msg=name)


def _fake_launchers(mask):
    """CPU stand-ins for the two CUDA launchers, built from the plain
    versions, so the autograd wiring around the kernels runs on the CPU."""

    def full(params):  # the launchers get the six head fields, w_cls None
        return dataclasses.replace(params, w_cls=torch.zeros(params.b_att.shape[0], 1))

    def fwd(H, _mask, params, T, seed, pf, pa):
        params = full(params)
        with torch.no_grad():
            _, A = tga.mc_head_reference(H, mask, params, T, seed, pf, pa)
            M = torch.stack([
                A[t] @ (tga._dropout(H, pf, seed + t, tga.FEATURE_DRAW) if pf > 0 else H)
                for t in range(T)
            ])
        return M, A

    def bwd(H, params, T, seed, pf, pa, A, dM, dA):
        params = full(params)
        dH, dw_V, db_V, dw_U, db_U, dw_att, db_att = tga.mc_head_backward_reference(
            H, mask, params, T, seed, pf, pa, dM, dA
        )
        if params.separate:
            return dH, dw_V, db_V, dw_U, db_U, dw_att, db_att
        return dH, dw_V[None], db_V[None], dw_U[None], db_U[None], dw_att.T, db_att

    return fwd, bwd


@pytest.mark.parametrize("separate", [False, True])
def test_autograd_function_routes_kernel_gradients(separate, monkeypatch):
    """``_MCHead`` (forward K1/K2, backward K4/K5 on the card) hands each
    kernel-layout gradient back to the right weight, in its layout and
    dtype, with and without a cotangent on M."""
    N, L, T = 24, 64, 2
    H, mask, dY, dA = (torch.from_numpy(x) for x in _inputs(4, N, L, T))
    tp = tga.GatedAttentionParams(**{
        k: torch.from_numpy(v) for k, v in _params_np(5, L=L, D=8, separate=separate).items()
    })
    fwd, bwd = _fake_launchers(mask)
    monkeypatch.setattr(tga, "_mc_head_cuda", fwd)
    monkeypatch.setattr(tga, "_mc_head_bwd_cuda", bwd)
    for with_y in (True, False):
        leaves = [H.clone().requires_grad_(True)] + [
            getattr(tp, f).clone().requires_grad_(True) for f in FIELDS
        ]
        M, A = tga._MCHead.apply(leaves[0], mask, *leaves[1:], T, 6, 0.1, 0.1)
        Y = torch.einsum("tcl,cl->tc", M, tp.w_cls)
        loss = (A * dA).sum() + ((Y * dY).sum() if with_y else 0.0)
        got = torch.autograd.grad(loss, leaves)
        want = _autograd_grads(H, mask, tp, T, 6, 0.1, dY if with_y else 0 * dY, dA)
        for name, g, w in zip(("H",) + FIELDS, got, want):
            assert g.dtype == w.dtype and g.shape == w.shape, name
            torch.testing.assert_close(g, w, atol=1e-6, rtol=0, msg=name)


def test_head_trains_every_head_weight():
    """The model's head keeps the graph to its weights (the inference copy
    does not): one backward reaches H and every head parameter."""
    model = tgamil.MultiHeadGatedAttentionMIL(shared_attention=False)
    H = torch.rand(12, 512, generator=torch.Generator().manual_seed(0), requires_grad=True)
    mask = torch.arange(12) < 9
    y, a = model.head(H, mask, train=True, seed=3)
    (y.sum() + (a * torch.linspace(0, 1, 12)).sum()).backward()
    assert H.grad is not None and torch.all(H.grad[~mask] == 0) and H.grad[mask].abs().sum() > 0
    for name, p in model.named_parameters():
        if not name.startswith("feature_extractor."):
            assert p.grad is not None, name
            # b_att shifts every logit of its class, which the softmax ignores
            # unless attention dropout hit one of them: its gradient may be 0.
            assert p.grad.abs().sum() > 0 or name.startswith("attention_weights.") and (
                name.endswith(".bias")
            ), name
    frozen = tga.GatedAttentionParams.from_module(model)
    assert not any(getattr(frozen, f).requires_grad for f in FIELDS + ("w_cls",))


@pytest.mark.parametrize("loss_type", ["pairwise", "cosine"])
def test_auxiliary_loss_matches_jax(loss_type):
    rng = np.random.default_rng(6)
    pos, neg = (rng.random((4, 16)).astype(np.float32) for _ in range(2))
    is_pos = np.array([True, False, True, False])
    want = jgamil.auxiliary_loss(jnp.asarray(pos), jnp.asarray(neg), jnp.asarray(is_pos),
                                 loss_type=loss_type, margin=1.0)
    got = tgamil.auxiliary_loss(torch.from_numpy(pos), torch.from_numpy(neg),
                                torch.from_numpy(is_pos), loss_type=loss_type, margin=1.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("mask", [None, [1, 1, 0, 1, 0, 1], [0] * 6], ids=["none", "some", "all"])
def test_lean_batchnorm_backward_is_exact(mask):
    """The masked BN's hand-written backward passes ``gradcheck`` (f64),
    with no mask, padded instances and an all-masked bag."""
    m = None if mask is None else torch.tensor(mask, dtype=torch.bool)
    g = torch.Generator().manual_seed(0)
    x = (torch.randn(6, 4, 5, 5, generator=g, dtype=torch.float64) * 3 + 1).requires_grad_(True)
    w = torch.randn(4, generator=g, dtype=torch.float64).requires_grad_(True)
    b = torch.randn(4, generator=g, dtype=torch.float64).requires_grad_(True)
    assert torch.autograd.gradcheck(lambda *a: _MaskedBatchNorm.apply(*a, m, 1e-5), (x, w, b))


@pytest.mark.parametrize("shared", [True, False])
def test_train_step_matches_interpreted_pallas_step(shared):
    """The JAX step through its fused kernels (``use_pallas=True``, run
    interpreted on the CPU at dropout 0) against the port's step, f32 at
    64x64, with the JAX test's tolerances (loss 1e-5, weights 2e-5 + 1e-4
    relative)."""
    rng = np.random.default_rng(3)
    mask = np.arange(8) < 6
    x = (rng.standard_normal((8, 64, 64, 3)) * mask[:, None, None, None]).astype(np.float32)
    plans = [c.TrainingPlan(parameters=c.TrainingParameters(lr=0.05, wd=0.0))
             for c in (jcfg, tcfg)]
    jm = JaxMIL(feature_dropout=0.0, attention_dropout=0.0, shared_attention=shared)
    jp = jax.jit(jm.init)(jax.random.key(0), jnp.zeros((8, 64, 64, 3)), jnp.ones(8, bool))["params"]
    tm = tgamil.MultiHeadGatedAttentionMIL(feature_dropout=0.0, attention_dropout=0.0,
                                           shared_attention=shared)
    tm.load_state_dict(from_jax_params(jax.tree.map(np.asarray, jp)))
    jbag = JaxBag(patches=jnp.asarray(x), mask=jnp.asarray(mask), label=jnp.asarray(1, jnp.int32),
                  tile_indices=jnp.arange(8))
    tbag = Bag(patches=torch.from_numpy(x), mask=torch.from_numpy(mask), label=torch.tensor(1),
               tile_indices=torch.arange(8))
    jopt = joptim.make_optimizer(plans[0])
    js, jout = jstate.make_train_step(jm, jcrit.cross_entropy, jopt, 1, use_pallas=True)(
        jstate.TrainState.create(jp, jopt), jbag, jax.random.key(2), jnp.asarray(True)
    )
    opt, sched = toptim.make_optimizer(plans[1], tm.parameters())
    _, out = make_train_step(tm, tcrit.cross_entropy, opt, 1)(
        TrainState(tm, opt, sched), tbag, 2, True
    )
    assert float(out["loss"]) == pytest.approx(float(jout["loss"]), abs=1e-5)
    assert float(out["aux_loss"]) == pytest.approx(float(jout["aux_loss"]), abs=1e-5)
    want = from_jax_params(jax.tree.map(np.asarray, js.params))
    for k, v in tm.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=2e-5, rtol=1e-4, err_msg=k)
