"""The port's CUDA kernels against their plain versions, on the card.

These import no JAX, so they also run on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_kernels_gpu.py

Where ``torch.cuda.is_available()`` is false each test skips.
"""

import pytest
import torch

from montecarlo_gated_mil_tpu_torch.ops import cuda_build
from montecarlo_gated_mil_tpu_torch.ops import gated_attention as tga
from montecarlo_gated_mil_tpu_torch.ops import patching as tp

FIELDS = ("w_V", "b_V", "w_U", "b_U", "w_att", "b_att")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _params(separate, L=128, D=32, C=2):
    g = torch.Generator().manual_seed(8)

    def r(*shape):
        return torch.randn(*shape, generator=g) * 0.05

    if separate:
        return tga.GatedAttentionParams(r(C, L, D), r(C, D), r(C, L, D), r(C, D),
                                        r(C, D), r(C), r(C, L))
    return tga.GatedAttentionParams(r(L, D), r(D), r(L, D), r(D), r(D, C), r(C), r(C, L))


@pytest.mark.gpu
@pytest.mark.parametrize("separate", [False, True])
@pytest.mark.parametrize("p", [0.0, 0.1])
def test_mc_head_kernel_matches_plain(cuda, separate, p):
    """Dropout off and on: the same Philox bits feed kernel and plain version."""
    N, L, T = 200, 128, 4
    g = torch.Generator().manual_seed(7)
    H = torch.rand(N, L, generator=g).to(cuda)
    mask = (torch.arange(N) % 4 != 3).to(cuda)
    params = _params(separate).to(cuda)
    y_k, a_k = tga.mc_gated_attention(H, mask, params, T, 3, p, p)
    y_r, a_r = tga.mc_head_reference(H, mask, params, T, 3, p, p)
    torch.cuda.synchronize()
    torch.testing.assert_close(y_k, y_r, atol=1e-4, rtol=0)
    torch.testing.assert_close(a_k, a_r, atol=1e-5, rtol=0)
    assert torch.all(a_k[:, :, ~mask] == 0)
    y_again, a_again = tga.mc_gated_attention(H, mask, params, T, 3, p, p)
    assert torch.equal(y_again, y_k) and torch.equal(a_again, a_k)


def _bwd_case(cuda, separate, T, N=200, L=128):
    g = torch.Generator().manual_seed(7)
    H = torch.rand(N, L, generator=g).to(cuda)
    mask = (torch.arange(N) % 4 != 3).to(cuda)
    params = _params(separate, L=L).to(cuda)
    dY = torch.randn(T, 2, generator=g).to(cuda)
    dA = (torch.randn(T, 2, N, generator=g) * 0.1).to(cuda)
    return H, mask, params, dY, dA


def _assert_grads_close(got, want):
    """Each gradient within 1e-3 of its own largest entry, plus 5e-5 of the
    largest entry of any of them: the f32 rounding floor of db_att, a sum
    over the bag that cancels to 0 at dropout 0."""
    floor = 5e-5 * max(float(r.abs().max()) for r in want)
    for name, k, r in zip(("H",) + FIELDS, got, want):
        tol = 1e-3 * float(r.abs().max()) + floor
        torch.testing.assert_close(k, r, atol=tol, rtol=0, msg=lambda m, n=name: f"d{n}: {m}")


@pytest.mark.gpu
@pytest.mark.parametrize("separate", [False, True])
@pytest.mark.parametrize("p", [0.0, 0.1])
def test_backward_kernel_matches_plain(cuda, separate, p):
    """K4/K5 replay the forward's Philox masks: they equal the plain
    backward; padded rows of dH are exactly 0; two calls are bitwise equal."""
    H, mask, params, dY, dA = _bwd_case(cuda, separate, T=3)
    _, A = tga._mc_head_cuda(H, mask, params, 3, 3, p, p)
    dM = dY[:, :, None] * params.w_cls[None]
    dH, *w = tga._mc_head_bwd_cuda(H, params, 3, 3, p, p, A, dM, dA)
    want = tga.mc_head_backward_reference(H, mask, params, 3, 3, p, p, dM, dA)
    torch.cuda.synchronize()
    _assert_grads_close((dH, *tga.param_layout_grads(params.separate, *w)), want)
    assert torch.all(dH[~mask] == 0)
    again = tga._mc_head_bwd_cuda(H, params, 3, 3, p, p, A, dM, dA)
    assert all(torch.equal(x, y) for x, y in zip((dH, *w), again))


@pytest.mark.gpu
@pytest.mark.parametrize("separate", [False, True])
def test_autograd_through_the_kernels(cuda, separate):
    """``mc_gated_attention`` on the card with weights that require a
    gradient runs K1/K2 forward and K4/K5 backward; its gradients equal
    autograd of the plain head."""
    H, mask, params, dY, dA = _bwd_case(cuda, separate, T=1)
    kernel = cuda_build.KERNELS["mc_head_bwd_sep" if separate else "mc_head_bwd_shared"]

    def grads(fn):
        leaves = [H.clone().requires_grad_(True)] + [
            getattr(params, f).clone().requires_grad_(True) for f in FIELDS
        ]
        prm = tga.GatedAttentionParams(*leaves[1:], params.w_cls)
        y, a = fn(leaves[0], mask, prm, 1, 5, 0.1, 0.1)
        return torch.autograd.grad((y * dY).sum() + (a * dA).sum(), leaves)

    before = kernel.launches
    got = grads(tga.mc_gated_attention)
    assert kernel.launches == before + 1
    _assert_grads_close(got, grads(tga.mc_head_reference))


@pytest.mark.gpu
def test_gather_kernel_bit_exact(cuda):
    grid = tp.compute_tile_grid(703, 280, 224, 0.75)
    img = torch.rand(703, 280, generator=torch.Generator().manual_seed(0)).to(cuda)
    starts = torch.from_numpy(grid.tiles_array()[:, :2]).long()
    starts = torch.cat([starts, torch.tensor([[600, 0], [0, -1]])]).to(cuda)
    got = tp.gather_selected(img, starts, 224)
    want = tp.gather_tiles_reference(img, starts, 224)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.all(got[-2:] == 0)


@pytest.mark.gpu
def test_kernels_refuse_wrong_inputs(cuda):
    with pytest.raises(ValueError, match="float32"):
        tp.gather_selected(torch.zeros(300, 300, dtype=torch.float64, device=cuda),
                           torch.zeros(1, 2, dtype=torch.long, device=cuda), 224)
    H = torch.rand(16, 128, device=cuda)
    bad = _params(True, D=6).to(cuda)  # D not a multiple of 4
    with pytest.raises(ValueError, match="unsupported shapes"):
        tga.mc_gated_attention(H, torch.ones(16, dtype=torch.bool, device=cuda), bad, 2, 0)
    H, mask, params, _, dA = _bwd_case(cuda, True, T=3)
    _, A = tga._mc_head_cuda(H, mask, params, 3, 0, 0.0, 0.0)
    dM = torch.zeros(3, 2, 128, device=cuda)
    with pytest.raises(ValueError, match="do not fit"):
        tga._mc_head_bwd_cuda(H, params, 2, 0, 0.0, 0.0, A, dM, dA)
    with pytest.raises(ValueError, match="unsupported shapes"):
        tga._mc_head_bwd_cuda(H, bad, 3, 0, 0.0, 0.0, A, dM, dA)
