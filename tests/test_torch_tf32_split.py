"""The numerical premise of the MC head kernels' tensor-core products.

``csrc/mc_tile.cuh`` takes every f32 product of K1/K2 and K4/K5 on the
tensor cores as 3xTF32: hi = tf32(x), lo = tf32(x - hi), and a*b as
a_lo*b_hi + a_hi*b_lo + a_hi*b_hi with f32 accumulation.  Its TF32 rounding
is integer arithmetic on the f32 bits (add half a unit of the 13 dropped
bits, clear them), which these tests repeat bit for bit on f32 tensors.  At
the model's widths (N = 256 rows, L = 512, D = 128, H in [0, 2),
``torch.nn.Linear``'s init) they show that 3xTF32 keeps the gate
pre-activations and logits within 1e-5 of the plain f32 product, the
tightest tolerance the kernels are held to (1e-5 on A, 1e-4 on Y), and that
plain TF32 does not.  Those tolerances alone cannot tell the two apart on
the card (plain TF32 moves A by about 1e-7), so the card's tests also hold
the forward's logits and the backward's products against f64 at the limits
below, which sit between the two: 3xTF32 meets them, and plain TF32 fails
them here.
"""

import numpy as np
import pytest
import torch

N, L, D = 256, 512, 128
# The card's f64 checks in tests/test_torch_kernels_gpu.py use the same limits.
LOGITS_VS_F64 = 5e-6  # max |logit - exact logit|
PRODUCTS_VS_F64 = 1e-5  # max |d - exact| / max |exact| of dH and dW


def tf32(x: torch.Tensor) -> torch.Tensor:
    """Round f32 to TF32 as ``tf32_round`` in ``csrc/mc_tile.cuh`` does."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)  # -0x2000 == 0xFFFFE000


def split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    hi = tf32(x)
    return hi, tf32(x - hi)


def product(a: torch.Tensor, b: torch.Tensor, mode: str) -> torch.Tensor:
    if mode == "f32":
        return a @ b
    (ah, al), (bh, bl) = split(a), split(b)
    if mode == "tf32":
        return ah @ bh
    return al @ bh + ah @ bl + ah @ bh  # 3xTF32, the kernels' order


@pytest.fixture(scope="module")
def head():
    rng = np.random.default_rng(0)

    def init(shape, fan_in):  # torch.nn.Linear's default init
        return torch.from_numpy((rng.uniform(-1, 1, shape) / fan_in**0.5).astype(np.float32))

    H = torch.from_numpy(rng.uniform(0, 2, (N, L)).astype(np.float32))
    return dict(H=H, W=init((L, 2 * D), L), b=init((2 * D,), L), wa=init((D,), D),
                ba=init((1,), D), wc=init((L,), L))


def _forward(h, z):
    """Logits, attention and output of one class from pre-activations z, in
    z's precision."""
    w = {k: v.to(z.dtype) for k, v in h.items()}
    gate = torch.tanh(z[:, :D] + w["b"][:D]) * torch.sigmoid(z[:, D:] + w["b"][D:])
    logits = gate @ w["wa"] + w["ba"]
    A = torch.softmax(logits, 0)
    return logits, A, (A @ w["H"]) @ w["wc"]


def test_tf32_rounding_matches_the_kernels_rule():
    x = torch.tensor([1.0, 1 + 2**-11, 1 + 3 * 2**-12, -(1 + 2**-11), 3.0e-3, -7.25])
    hi = tf32(x)
    assert torch.all(hi.view(torch.int32) & 0x1FFF == 0)
    # ties go away from zero, as cvt.rna.tf32.f32
    assert hi[1] == 1 + 2**-10 and hi[3] == -(1 + 2**-10) and hi[2] == 1 + 2**-10
    assert hi[0] == 1.0 and hi[5] == -7.25
    g = torch.Generator().manual_seed(0)
    y = torch.randn(4096, generator=g) * 10
    hi, lo = split(y)
    assert float(((hi - y) / y).abs().max()) <= 2.0**-11
    assert float(((hi.double() + lo.double() - y.double()) / y.double()).abs().max()) <= 2.0**-21


@pytest.mark.parametrize("mode,within", [("3xtf32", True), ("tf32", False)])
def test_gate_preactivations_and_logits_against_f32(head, mode, within):
    """3xTF32 stays within 1e-5 of the f32 product on the pre-activations and
    the logits (and so on A and Y); plain TF32 misses it by over 10x."""
    z_ref = product(head["H"], head["W"], "f32")
    z = product(head["H"], head["W"], mode)
    lg_ref, A_ref, y_ref = _forward(head, z_ref)
    lg, A, y = _forward(head, z)
    dz = float((z - z_ref).abs().max())
    dlg = float((lg - lg_ref).abs().max())
    if within:
        assert dz <= 1e-5 and dlg <= 1e-5
        assert float((A - A_ref).abs().max()) <= 1e-5
        assert float((y - y_ref).abs().max()) <= 1e-4
    else:
        assert dz > 1e-4 and dlg > 1e-5


def test_3xtf32_is_as_close_to_exact_as_f32(head):
    """Against the exact (f64) product, 3xTF32's error is of the size of
    f32's own rounding, not of TF32's."""
    exact = head["H"].double() @ head["W"].double()
    e_f32 = float((product(head["H"], head["W"], "f32").double() - exact).abs().max())
    e_3x = float((product(head["H"], head["W"], "3xtf32").double() - exact).abs().max())
    e_tf32 = float((product(head["H"], head["W"], "tf32").double() - exact).abs().max())
    assert e_3x <= 4 * e_f32 and e_tf32 >= 100 * e_f32


@pytest.mark.parametrize("mode,within", [("f32", True), ("3xtf32", True), ("tf32", False)])
def test_logits_against_f64(head, mode, within):
    """The card's check of K1's logits against f64: 3xTF32 (about 1.5e-7)
    and plain f32 meet LOGITS_VS_F64; plain TF32 (about 1.7e-4) fails it."""
    exact, _, _ = _forward(head, head["H"].double() @ head["W"].double())
    logits, _, _ = _forward(head, product(head["H"], head["W"], mode))
    err = float((logits.double() - exact).abs().max())
    assert (err <= LOGITS_VS_F64) == within, err


@pytest.mark.parametrize("mode,within", [("f32", True), ("3xtf32", True), ("tf32", False)])
def test_backward_products_against_f64(head, mode, within):
    """The card's check of K4/K5's products against f64, on a gate
    cotangent dz of the head's own gates: dH = dz W^T and dW = H^T dz stay
    within PRODUCTS_VS_F64 of their size for 3xTF32 and plain f32 (about
    5e-7) and miss it for plain TF32 (2e-4 and more)."""
    z = head["H"].double() @ head["W"].double()
    b = head["b"].double()
    V, U = torch.tanh(z[:, :D] + b[:D]), torch.sigmoid(z[:, D:] + b[D:])
    dlg = torch.randn(N, generator=torch.Generator().manual_seed(1), dtype=torch.float64) * 1e-2
    dG = dlg[:, None] * head["wa"].double()[None]
    dz = torch.cat([dG * U * (1 - V * V), dG * V * U * (1 - U)], 1).float()
    Wt, Ht = head["W"].T.contiguous(), head["H"].T.contiguous()
    for got, exact in ((product(dz, Wt, mode), dz.double() @ Wt.double()),
                       (product(Ht, dz, mode), Ht.double() @ dz.double())):
        rel = float((got.double() - exact).abs().max() / exact.abs().max())
        assert (rel <= PRODUCTS_VS_F64) == within, rel


def test_gate_split_is_the_kernels_rounding_in_its_layout():
    """The forward kernel's wgmma pass reads the gate weights pre-split on
    the host (``ops/gated_attention.py::gate_split``): each plane equals
    this file's emulation of ``split_tf32`` bit for bit, laid out per gate
    and 64 columns of D as those columns of Wv then of Wu, along L."""
    from montecarlo_gated_mil_tpu_torch.ops.gated_attention import gate_split, split_tf32

    g = torch.Generator().manual_seed(5)
    G, L_, D_ = 2, 96, 128
    wv = torch.randn(G, L_, D_, generator=g) * 0.05
    wu = torch.randn(G, L_, D_, generator=g) * 0.05
    wv[0, 0, :4] = torch.tensor([1 + 2**-11, -(1 + 2**-11), 3.0e-3, 0.0])  # ties, zero
    ws = gate_split(wv, wu)
    assert ws.shape == (2, G, D_ // 64, 128, L_) and ws.is_contiguous()
    for gi in range(G):
        for p in range(D_ // 64):
            block = torch.cat([wv[gi, :, 64 * p: 64 * p + 64], wu[gi, :, 64 * p: 64 * p + 64]], 1)
            for plane, want in enumerate(split(block.T.contiguous())):
                assert torch.equal(ws[plane, gi, p].view(torch.int32), want.view(torch.int32))
    y = torch.randn(4096, generator=g) * 10
    assert all(torch.equal(a.view(torch.int32), b.view(torch.int32))
               for a, b in zip(split_tf32(y), split(y)))


def test_gate_split_is_cached_per_weight_set():
    """The split is made once per weight set and made again after the
    weights change in place (an optimizer step) or for other weights."""
    from montecarlo_gated_mil_tpu_torch.ops import gated_attention as tga

    g = torch.Generator().manual_seed(6)
    p = tga.GatedAttentionParams(*(torch.randn(*s, generator=g) for s in (
        (2, 64, 64), (2, 64), (2, 64, 64), (2, 64), (2, 64), (2,), (2, 64))))
    wv, _, wu, *_ = tga._kernel_operands(p, torch.device("cpu"))
    first = tga._cached_gate_split(p, wv, wu)
    assert tga._cached_gate_split(p, wv, wu) is first
    with torch.no_grad():
        p.w_U.mul_(2.0)
    again = tga._cached_gate_split(p, wv, p.w_U)
    assert again is not first and torch.equal(again, tga.gate_split(wv, p.w_U))
    assert tga._cached_gate_split(p, wv[:, :, :32].contiguous(), wu[:, :, :32].contiguous()) is None
    with torch.inference_mode():  # no version counter: a fresh split every call
        q = tga.GatedAttentionParams(*(x.clone() for x in (p.w_V, p.b_V, p.w_U, p.b_U, p.w_att,
                                                           p.b_att, p.w_cls)))
        a, b = tga._cached_gate_split(q, q.w_V, q.w_U), tga._cached_gate_split(q, q.w_V, q.w_U)
    assert a is not b and torch.equal(a, b)
