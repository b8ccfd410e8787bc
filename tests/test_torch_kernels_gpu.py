"""The port's CUDA kernels against their plain versions, on the card.

These import no JAX, so they also run on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_kernels_gpu.py

Where ``torch.cuda.is_available()`` is false each ``gpu`` test skips; the
two checks without the marker (the padded-tile cases and the list of
device functions) read only the test data and the sources, and run
anywhere.
"""

import pytest
import torch

from montecarlo_gated_mil_tpu_torch.ops import cuda_build
from montecarlo_gated_mil_tpu_torch.ops import gated_attention as tga
from montecarlo_gated_mil_tpu_torch.ops import patching as tp
from montecarlo_gated_mil_tpu_torch.utils.profiling import (
    PhaseTimer,
    kernel_table,
    slope_time,
    time_ms,
)

FIELDS = ("w_V", "b_V", "w_U", "b_U", "w_att", "b_att")
# Limits against f64, as in tests/test_torch_tf32_split.py, which shows on
# the CPU that 3xTF32 meets them and plain TF32 fails them.
LOGITS_VS_F64 = 5e-6  # max |logit - exact logit| on the valid rows
PRODUCTS_VS_F64 = 1e-5  # max |d - exact| / max |exact| of dH, dw_V, dw_U


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


# Full-width cases (separate gates, C = 2, D = 128): (N, valid rows, where
# they lie, T, L).  "first" is how serving lays a bag out; "random" leaves
# few tiles empty; "gap" pads whole tiles in the middle of the bag.
FULL_CASES = {
    "ragged_random_T1": (1000, 700, "random", 1, 512),
    "valid_first_T1": (1024, 650, "first", 1, 512),
    "padded_tiles_T50": (1031, 600, "gap", 50, 512),
    "random_T50": (3072, 2400, "random", 50, 512),
    "random_T50_n6144": (6144, 4800, "random", 50, 512),  # the extended bucket
    "r50_L2048_T4": (600, 450, "random", 4, 2048),
}


def _full_case(cuda, case, seed=11):
    N, n_valid, where, T, L = FULL_CASES[case]
    D, C = 128, 2
    g = torch.Generator().manual_seed(seed)

    def init(*shape, fan_in):  # torch.nn.Linear's default init
        return (torch.rand(*shape, generator=g) * 2 - 1) / fan_in**0.5

    params = tga.GatedAttentionParams(
        init(C, L, D, fan_in=L), init(C, D, fan_in=L), init(C, L, D, fan_in=L),
        init(C, D, fan_in=L), init(C, D, fan_in=D), init(C, fan_in=D), init(C, L, fan_in=L),
    ).to(cuda)
    H = (torch.rand(N, L, generator=g) * 2.0).to(cuda)
    mask = torch.zeros(N, dtype=torch.bool)
    if where == "first":
        mask[:n_valid] = True
    elif where == "gap":
        mask[: n_valid // 2] = True
        mask[N - (n_valid - n_valid // 2):] = True
    else:
        mask[torch.randperm(N, generator=g)[:n_valid]] = True
    dY = torch.randn(T, C, generator=g).to(cuda)
    dA = (torch.randn(T, C, N, generator=g) * 0.1).to(cuda)
    return H, mask.to(cuda), params, T, dY, dA


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(FULL_CASES))
@pytest.mark.parametrize("p", [0.0, 0.1])
def test_mc_head_kernel_full_width(cuda, case, p):
    """K1 at the model's widths against its plain version: Y within 1e-4,
    A within 1e-5, padded rows exactly 0, two calls bitwise equal."""
    H, mask, params, T, _, _ = _full_case(cuda, case)
    y_k, a_k = tga.mc_gated_attention(H, mask, params, T, 21, p, p)
    y_r, a_r = tga.mc_head_reference(H, mask, params, T, 21, p, p)
    torch.cuda.synchronize()
    torch.testing.assert_close(y_k, y_r, atol=1e-4, rtol=0)
    torch.testing.assert_close(a_k, a_r, atol=1e-5, rtol=0)
    assert torch.all(a_k[:, :, ~mask] == 0)
    y_again, a_again = tga.mc_gated_attention(H, mask, params, T, 21, p, p)
    assert torch.equal(y_again, y_k) and torch.equal(a_again, a_k)


@pytest.mark.gpu
@pytest.mark.parametrize("case", [c for c in FULL_CASES if not c.startswith("random_T50")])
@pytest.mark.parametrize("p", [0.0, 0.1])
def test_backward_kernel_full_width(cuda, case, p):
    """K5 at the model's widths against its plain version, each gradient
    within 1e-3 of its size plus the 5e-5 floor; dH exactly 0 on padded
    rows; two calls bitwise equal."""
    H, mask, params, T, dY, dA = _full_case(cuda, case)
    _, A = tga._mc_head_cuda(H, mask, params, T, 4, p, p)
    dM = dY[:, :, None] * params.w_cls[None]
    got = tga._mc_head_bwd_cuda(H, params, T, 4, p, p, A, dM, dA)
    want = tga.mc_head_backward_reference(H, mask, params, T, 4, p, p, dM, dA)
    torch.cuda.synchronize()
    _assert_grads_close((got[0], *tga.param_layout_grads(True, *got[1:])), want)
    assert torch.all(got[0][~mask] == 0)
    again = tga._mc_head_bwd_cuda(H, params, T, 4, p, p, A, dM, dA)
    assert all(torch.equal(x, y) for x, y in zip(got, again))


F64_CASES = ["ragged_random_T1", "valid_first_T1", "r50_L2048_T4"]


@pytest.mark.gpu
@pytest.mark.parametrize("case", F64_CASES)
def test_forward_logits_against_f64(cuda, case):
    """K1's logits on the valid rows within LOGITS_VS_F64 of the f64
    product.  A and Y alone cannot tell 3xTF32 from plain TF32 (which moves
    A by about 1e-7); the logits can (plain TF32 moves them by about 2e-4)."""
    H, mask, params, T, _, _ = _full_case(cuda, case)
    _, _, logits = tga._mc_head_cuda(H, mask, params, T, 21, 0.1, 0.1, keep_logits=True)
    exact = tga.mc_head_logits_reference(H.double(), params.to(dtype=torch.float64), T, 21,
                                         0.1, 0.1)
    err = float((logits.double() - exact)[:, :, mask].abs().max())
    assert err <= LOGITS_VS_F64, err


@pytest.mark.gpu
@pytest.mark.parametrize("case", F64_CASES)
def test_backward_products_against_f64(cuda, case):
    """K5's dH, dw_V and dw_U within PRODUCTS_VS_F64 of their size against
    the f64 plain backward; plain TF32 products would miss it by over 10x."""
    H, mask, params, T, dY, dA = _full_case(cuda, case)
    _, A = tga._mc_head_cuda(H, mask, params, T, 4, 0.1, 0.1)
    dM = dY[:, :, None] * params.w_cls[None]
    dH, dwv, _, dwu, *_ = tga._mc_head_bwd_cuda(H, params, T, 4, 0.1, 0.1, A, dM, dA)
    exact = tga.mc_head_backward_reference(
        H.double(), mask, params.to(dtype=torch.float64), T, 4, 0.1, 0.1, dM.double(),
        dA.double(),
    )
    for name, got, ref in (("H", dH, exact[0]), ("w_V", dwv, exact[1]), ("w_U", dwu, exact[3])):
        rel = float((got.double() - ref).abs().max() / ref.abs().max())
        assert rel <= PRODUCTS_VS_F64, (name, rel)


def test_full_width_cases_pad_whole_tiles():
    """The "gap" case leaves 16-row tiles with no valid row, which the
    kernels must skip; "first" leaves them at the end."""
    for case in ("padded_tiles_T50", "valid_first_T1"):
        H, mask, *_ = _full_case(torch.device("cpu"), case)
        tiles = torch.nn.functional.pad(mask, (0, -len(mask) % 16)).view(-1, 16)
        assert int((~tiles.any(1)).sum()) >= 4


def test_device_function_names_cover_every_kernel():
    """``cuda_build.DEVICE_FUNCTIONS`` names every ``__global__`` function of
    each source, in the order they are defined, so that the profiler's
    per-kernel sums in ``chip_smoke.py`` miss none."""
    import re

    for source in {k.source for k in cuda_build.KERNELS.values()}:
        text = (cuda_build.CSRC / source).read_text()
        defined = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([\w, ]+\)\s+)?(\w+)\(",
                             text)
        assert tuple(defined) == cuda_build.DEVICE_FUNCTIONS[source], source


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
def test_gather_kernel_extended_bucket(cuda):
    """K3 with 6144 starts, an oversized bag's extended bucket, on a
    full-size 7036 x 2800 image: starts drawn with repeats from the serving
    grid, and two that leave the image."""
    g = torch.Generator().manual_seed(1)
    grid = tp.compute_tile_grid(7036, 2800, 224, 0.75)
    img = torch.rand(7036, 2800, generator=g).to(cuda)
    starts = torch.from_numpy(grid.tiles_array()[:, :2]).long()
    starts = starts[torch.randint(grid.num_tiles, (6142,), generator=g)]
    starts = torch.cat([starts, torch.tensor([[6900, 0], [0, 2700]])]).to(cuda)
    got = tp.gather_selected(img, starts, 224)
    want = tp.gather_tiles_reference(img, starts, 224)
    torch.cuda.synchronize()
    assert got.shape == (6144, 224, 224) and torch.equal(got, want)
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


# ---------------------------------------------------------------- K6-K8
# The int8 embed's kernels (ops/quant_kernels.py).  Their plain versions
# repeat the kernels' arithmetic op for op, so the outputs are held equal.

from montecarlo_gated_mil_tpu_torch.ops import quant_kernels as qk  # noqa: E402

# (N, H, W, Cin, Cout, k, stride, pad (top, bottom, left, right)): every conv
# geometry of r18 and r50 at a few instances and odd sizes, r50's widest
# 1x1s, an oversize-extended bag, and the s2d stem.
QCONV_CASES = {
    "3x3_s1_64": (3, 15, 13, 64, 64, 3, 1, (1, 1, 1, 1)),
    "3x3_s2_64_128": (3, 15, 14, 64, 128, 3, 2, (1, 1, 1, 1)),
    "1x1_s2_64_128": (3, 15, 14, 64, 128, 1, 2, (0, 0, 0, 0)),
    "3x3_s1_256": (2, 7, 7, 256, 256, 3, 1, (1, 1, 1, 1)),
    "3x3_s1_512": (5, 4, 3, 512, 512, 3, 1, (1, 1, 1, 1)),
    "1x1_s1_256_64": (2, 9, 9, 256, 64, 1, 1, (0, 0, 0, 0)),
    "1x1_s1_64_256": (2, 9, 9, 64, 256, 1, 1, (0, 0, 0, 0)),
    "3x3_s2_128_256": (3, 9, 11, 128, 256, 3, 2, (1, 1, 1, 1)),
    "1x1_s1_2048_512": (2, 4, 5, 2048, 512, 1, 1, (0, 0, 0, 0)),
    "1x1_s2_1024_2048": (2, 7, 7, 1024, 2048, 1, 2, (0, 0, 0, 0)),
    "3x3_s1_512_n6144": (6144, 3, 3, 512, 512, 3, 1, (1, 1, 1, 1)),  # an extended bucket
    # Layer 1's 3x3 at the extended bucket: the bf16 output passes 2^31 bytes.
    "layer1_3x3_n6144": (6144, 56, 56, 64, 64, 3, 1, (1, 1, 1, 1)),
    # Output 7 x 6, not a multiple of the 8 x 8 tile, at stride 2.
    "3x3_s2_out_7x6": (5, 13, 11, 64, 128, 3, 2, (1, 1, 1, 1)),
    # M = 5 * 9 * 7, not a multiple of the tile's 64 rows; an odd tile count.
    "3x3_s1_m_315": (5, 9, 7, 128, 128, 3, 1, (1, 1, 1, 1)),
    "s2d_stem_4x4": (3, 20, 18, 12, 64, 4, 1, (2, 1, 2, 1)),
}


def _qconv_inputs(cuda, case, extreme=False, seed=3):
    n, h, w, cin, cout, k, stride, pad = QCONV_CASES[case]
    g = torch.Generator().manual_seed(seed)
    if extreme:  # |acc| up to 127^2 * K, past 2^24 where float32 has gaps
        a = torch.full((n, h, w, cin), 127, dtype=torch.int8)
        wt = torch.where(torch.rand(cout, k, k, cin, generator=g) < 0.98, 127, -127).to(torch.int8)
    else:
        a = torch.randint(-127, 128, (n, h, w, cin), generator=g, dtype=torch.int8)
        wt = torch.randint(-127, 128, (cout, k, k, cin), generator=g, dtype=torch.int8)
    scale = torch.rand(cout, generator=g) * 2e-4 + 1e-5
    return a.to(cuda), wt.to(cuda), scale.to(cuda), stride, pad


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(QCONV_CASES))
@pytest.mark.parametrize("store", ["bf16", "f8", "i8"])
def test_qconv_kernel_bit_exact(cuda, case, store):
    """K6 equals its plain version (exact f64 accumulators, the same
    epilogue) bit for bit, and launches once."""
    a, w, scale, stride, pad = _qconv_inputs(cuda, case)
    if store == "i8":
        scale = scale * 50.0  # s / t: codes spread over the int8 range
    before = cuda_build.KERNELS["qconv_i8"].launches
    got = qk.qconv(a, w, scale, stride, pad, store)
    want = qk.qconv_reference(a, w, scale, stride, pad, store)
    torch.cuda.synchronize()
    assert cuda_build.KERNELS["qconv_i8"].launches == before + 1
    assert got.dtype == want.dtype == qk.STORE_DTYPES[store] and got.shape == want.shape
    assert torch.equal(got.view(torch.int8) if store == "f8" else got,
                       want.view(torch.int8) if store == "f8" else want)


def _device_launches(fn, source: str = "qconv.cu") -> dict:
    """Launches of each device function of ``source`` while ``fn`` runs, by
    the kernel names the profiler records (``utils/profiling.py::
    kernel_table``, whose spin-kernel marks and retakes keep a trace that
    drops its first records exact): ``qconv_i8`` alone picks K6's path.
    Prints a line when the trace dropped its first records."""
    fn()  # warm, untraced
    table = kernel_table(fn)
    if table.dropped:
        print(f"trace dropped its first {table.dropped} record(s)")
    return {f: table.count(f) for f in cuda_build.DEVICE_FUNCTIONS[source]}


@pytest.mark.gpu
@pytest.mark.parametrize("backbone, stem, convs", [
    ("r18", "bf16", 19), ("r34", "bf16", 35), ("r50", "bf16", 52), ("r18", "s2d_i8", 20),
])
def test_qconv_plan_convs_run_the_wgmma_kernel(cuda, backbone, stem, convs):
    """Every int8 conv of an r18, r34 or r50 embed at 224 px runs
    ``qconv_wgmma_kernel``; with the s2d stem (Cin = 12) the stem alone runs
    ``qconv_gather_kernel``."""
    from montecarlo_gated_mil_tpu_torch.models.resnet import make_backbone
    from montecarlo_gated_mil_tpu_torch.ops import quantized

    torch.manual_seed(0)
    plan = quantized.quantize_backbone_static(make_backbone(backbone).to(cuda), backbone,
                                              stem=stem)
    g = torch.Generator().manual_seed(1)
    patches = torch.clamp(torch.randn(2, 224, 224, 3, generator=g), -2.0, 2.5).to(cuda)

    def embed():
        with torch.inference_mode():
            quantized.quantized_embed_static(plan, patches, backbone=backbone)

    kernel = cuda_build.KERNELS["qconv_i8"]
    before = kernel.launches
    got = _device_launches(embed)
    assert kernel.launches - before == 2 * convs
    gathers = 1 if stem == "s2d_i8" else 0
    wgmma_fn, gather_fn = cuda_build.DEVICE_FUNCTIONS["qconv.cu"]
    assert got == {wgmma_fn: convs - gathers, gather_fn: gathers}


@pytest.mark.gpu
def test_qconv_extended_bucket_runs_the_wgmma_kernel(cuda):
    """Layer 1's 3x3 at the extended bucket of 6144 instances, whose bf16
    output passes 2^31 bytes, runs ``qconv_wgmma_kernel``."""
    a, w, scale, stride, pad = _qconv_inputs(cuda, "layer1_3x3_n6144")
    got = _device_launches(lambda: qk.qconv(a, w, scale, stride, pad, "bf16"))
    wgmma_fn, gather_fn = cuda_build.DEVICE_FUNCTIONS["qconv.cu"]
    assert got == {wgmma_fn: 1, gather_fn: 0}


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["3x3_s1_512", "s2d_stem_4x4"])
def test_qconv_kernel_large_accumulators(cuda, case):
    """Accumulators past 2^24 convert with round-to-nearest-even, as
    torch's int32 -> float32 does."""
    a, w, scale, stride, pad = _qconv_inputs(cuda, case, extreme=True)
    acc = qk.qconv_accumulate(a, w, stride, pad)
    if case == "3x3_s1_512":
        assert int(acc.abs().max()) > 2**24
    got = qk.qconv(a, w, scale, stride, pad, "bf16")
    assert torch.equal(got, qk.store_epilogue(acc, scale, "bf16"))


def _stored(cuda, dtype, shape, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(*shape, generator=g) * 3.0
    if dtype == torch.int8:
        return torch.clamp(torch.round(x * 20), -127, 127).to(torch.int8).to(cuda), (
            torch.rand(shape[-1], generator=g) * 0.05 + 0.01).to(cuda)
    return x.to(dtype).to(cuda), None


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float8_e4m3fn, torch.int8])
@pytest.mark.parametrize("shape", [(3, 33, 31, 64), (4, 7, 7, 512), (2, 3, 3, 2048)])
def test_bn_stats_kernel(cuda, dtype, shape):
    """K7 sums in float64: within 1e-6 of the size of the plain f32 sums."""
    t, tq = _stored(cuda, dtype, shape, 5)
    s1, s2 = qk.bn_stats(t, tq)
    r1, r2 = qk.bn_stats_reference(t, tq)
    torch.cuda.synchronize()
    for got, want in ((s1, r1), (s2, r2)):
        assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())
    again = qk.bn_stats(t, tq)
    assert torch.equal(again[0], s1) and torch.equal(again[1], s2)


def _affine(cuda, c, seed):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(c, generator=g) * 4).to(cuda), (torch.randn(c, generator=g) * 10).to(cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float8_e4m3fn, torch.int8])
@pytest.mark.parametrize("residual", ["none", "identity", "downsample"])
@pytest.mark.parametrize("mode", ["i8", "mean"])
def test_bn_relu_quant_kernel(cuda, dtype, residual, mode):
    """K8's codes equal the plain version's; the mean mode within 1e-6 of
    the features' size."""
    shape = (3, 9, 7, 128)
    t, tq = _stored(cuda, dtype, shape, 6)
    scale, shift = _affine(cuda, 128, 7)
    res = None
    if residual == "identity":
        x, _ = _stored(cuda, torch.int8, shape, 8)
        res = qk.Residual(x, None, _affine(cuda, 128, 9)[0].abs(), None)
    elif residual == "downsample":
        d, dtq = _stored(cuda, dtype, shape, 10)
        res = qk.Residual(d, dtq, *_affine(cuda, 128, 11))
    got = qk.bn_relu_quant(t, tq, scale, shift, res, mode=mode)
    want = qk.bn_relu_quant_reference(t, tq, scale, shift, res, mode=mode)
    torch.cuda.synchronize()
    if mode == "i8":
        assert got.dtype == torch.int8 and torch.equal(got, want)
        assert int((got != 0).sum()) > got.numel() // 10  # not all clipped away
    else:
        assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("hw", [(112, 112), (17, 14)])
def test_stem_pool_quant_kernel(cuda, hw):
    """K8's stem mode: affine, ReLU, 3x3/2 max-pool padded with -inf and
    the rounding, code for code."""
    t, _ = _stored(cuda, torch.bfloat16, (2, *hw, 64), 12)
    scale, shift = _affine(cuda, 64, 13)
    got = qk.bn_relu_quant(t, None, scale, shift, mode="pool_i8")
    want = qk.bn_relu_quant_reference(t, None, scale, shift, mode="pool_i8")
    torch.cuda.synchronize()
    assert got.shape == want.shape == (2, (hw[0] + 1) // 2, (hw[1] + 1) // 2, 64)
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("stem", ["bf16", "s2d_i8"])
@pytest.mark.parametrize("store", ["bf16", "f8", "i8"])
def test_quantized_embed_on_the_card(cuda, stem, store):
    """The int8 embed of a small r18 bag on the card goes through K6, K7 and
    K8 only (19 int8 convs), and tracks the float embed as the CPU tests
    hold it (cosine > 0.97 per valid instance)."""
    from montecarlo_gated_mil_tpu_torch.models.resnet import make_backbone
    from montecarlo_gated_mil_tpu_torch.ops.quantized import (
        quantize_backbone_static,
        quantized_embed_static,
    )

    torch.manual_seed(0)
    backbone = make_backbone("r18").to(cuda)
    g = torch.Generator().manual_seed(1)
    patches = torch.clamp(torch.randn(12, 64, 64, 3, generator=g) * 0.8, -2.2, 2.7).to(cuda)
    mask = (torch.arange(12) < 10).to(cuda)
    plan = quantize_backbone_static(backbone, "r18", conv_store=store, stem=stem)
    cuda_build.reset_launch_counts()
    with torch.inference_mode():
        hq = quantized_embed_static(plan, patches, mask)
        hf = backbone(patches, mask)
    torch.cuda.synchronize()
    launches = {k: cuda_build.KERNELS[k].launches for k in ("qconv_i8", "bn_stats", "bn_relu_quant")}
    assert launches == {"qconv_i8": 19 + (stem == "s2d_i8"), "bn_stats": 20, "bn_relu_quant": 17}
    cos = torch.nn.functional.cosine_similarity(hq[:10], hf[:10], dim=-1)
    assert bool(torch.isfinite(hq).all()) and float(cos.min()) > 0.97


@pytest.mark.gpu
def test_quant_kernels_refuse_wrong_inputs(cuda):
    a, w, scale, stride, pad = _qconv_inputs(cuda, "3x3_s1_64")
    with pytest.raises(ValueError, match="qconv_i8"):
        qk.qconv(a.float(), w, scale, stride, pad, "bf16")
    with pytest.raises(ValueError, match="unsupported conv"):
        qk.qconv(a[..., :6].contiguous(), w[..., :6].contiguous(), scale, stride, pad, "bf16")
    t, _ = _stored(cuda, torch.bfloat16, (2, 4, 4, 12), 1)
    with pytest.raises(ValueError, match="bn_stats"):
        qk.bn_stats(t)
    t, tq = _stored(cuda, torch.int8, (2, 4, 4, 64), 1)
    with pytest.raises(ValueError, match="bn_stats"):
        qk.bn_stats(t)  # an int8 store without its tq
    with pytest.raises(ValueError, match="bn_relu_quant"):
        qk.bn_relu_quant(t, tq, *_affine(cuda, 64, 1), mode="pool_i8")


def _chip_smoke():
    import importlib.util
    import sys
    from pathlib import Path

    if "chip_smoke" not in sys.modules:
        path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
        spec = importlib.util.spec_from_file_location("chip_smoke", path)
        module = importlib.util.module_from_spec(spec)
        sys.modules["chip_smoke"] = module
        spec.loader.exec_module(module)
    return sys.modules["chip_smoke"]


# K8 at every launch of an r18 request (chip_smoke.K8_SHAPES), at 3
# instances, for each store of the conv output (the stem's is bf16 only).
K8_SHAPES = {label: rest for label, *rest in _chip_smoke().K8_SHAPES}
K8_LAUNCH_CASES = [(label, dtype) for label, (_, mode, *_) in K8_SHAPES.items()
                   for dtype in (torch.bfloat16, torch.float8_e4m3fn, torch.int8)
                   if mode != "pool_i8" or dtype == torch.bfloat16]


@pytest.mark.gpu
@pytest.mark.parametrize("label, dtype", K8_LAUNCH_CASES)
def test_bn_relu_quant_every_r18_launch_shape(cuda, label, dtype):
    """K8's codes equal the plain version's at each r18 launch shape, mode
    and residual, with scales of both signs; the mean mode within 1e-6 of
    the features' size."""
    hwc, mode, res, _ = K8_SHAPES[label]
    shape = (3, *hwc)
    t, tq = _stored(cuda, dtype, shape, 20)
    scale, shift = _affine(cuda, hwc[-1], 21)
    residual = None
    if res == "identity":
        x, _ = _stored(cuda, torch.int8, shape, 22)
        residual = qk.Residual(x, None, _affine(cuda, hwc[-1], 23)[0].abs() / 10, None)
    elif res == "downsample":
        d, dtq = _stored(cuda, dtype, shape, 24)
        residual = qk.Residual(d, dtq, *_affine(cuda, hwc[-1], 25))
    before = cuda_build.KERNELS["bn_relu_quant"].launches
    got = qk.bn_relu_quant(t, tq, scale, shift, residual, mode=mode)
    want = qk.bn_relu_quant_reference(t, tq, scale, shift, residual, mode=mode)
    torch.cuda.synchronize()
    assert cuda_build.KERNELS["bn_relu_quant"].launches == before + 1
    assert got.dtype == want.dtype and got.shape == want.shape
    if mode == "mean":
        assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())
    else:
        assert torch.equal(got, want)
        assert 0 < int((got != 0).sum()) < got.numel()


@pytest.mark.gpu
@pytest.mark.parametrize("hw", [(17, 15), (1, 3), (112, 112)])
def test_stem_pool_quant_negative_and_zero_scales(cuda, hw):
    """The stem kernel pools max where A > 0 and min where A < 0; at A = 0
    (either sign) every tap gives the same code.  Odd sizes pad the last
    row and column."""
    t, _ = _stored(cuda, torch.bfloat16, (2, *hw, 64), 26)
    scale, shift = _affine(cuda, 64, 27)
    scale[::7] = 0.0
    scale[3::7] = -0.0
    assert int((scale < 0).sum()) > 10 and int((scale > 0).sum()) > 10
    got = qk.bn_relu_quant(t, None, scale, shift, mode="pool_i8")
    want = qk.bn_relu_quant_reference(t, None, scale, shift, mode="pool_i8")
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_stem_pool_quant_input_past_2_31_elements(cuda):
    """At 2675 instances the stem's input passes 2^31 elements: the last
    instances, past it, equal the plain version's codes (which runs on a
    few instances, each independent of the others)."""
    n = 2675
    assert n * 112 * 112 * 64 > 2**31
    g = torch.Generator(device=cuda).manual_seed(28)
    t = torch.randn(n, 112, 112, 64, generator=g, device=cuda, dtype=torch.bfloat16) * 3
    scale, shift = _affine(cuda, 64, 29)
    got = qk.bn_relu_quant(t, None, scale, shift, mode="pool_i8")
    torch.cuda.synchronize()
    for part in (slice(0, 2), slice(n - 3, n)):
        want = qk.bn_relu_quant_reference(t[part], None, scale, shift, mode="pool_i8")
        assert torch.equal(got[part], want)


@pytest.mark.gpu
def test_int8_embed_runs_k7_and_k8_by_device_function(cuda):
    """The profiled r18 int8 embed at 224 px launches K8's device functions
    17 times (the stem pool once, the mean once, the elementwise mode 15
    times) and K7's 20 times."""
    from montecarlo_gated_mil_tpu_torch.models.resnet import make_backbone
    from montecarlo_gated_mil_tpu_torch.ops import quantized

    torch.manual_seed(0)
    plan = quantized.quantize_backbone_static(make_backbone("r18").to(cuda), "r18")
    g = torch.Generator().manual_seed(1)
    patches = torch.clamp(torch.randn(2, 224, 224, 3, generator=g), -2.0, 2.5).to(cuda)

    def embed():
        with torch.inference_mode():
            quantized.quantized_embed_static(plan, patches)

    got = _device_launches(embed, "bn_quant.cu")
    assert got == {"bn_stats_kernel": 20, "bn_relu_quant_kernel": 15,
                   "bn_relu_mean_kernel": 1, "stem_pool_quant_kernel": 1}


@pytest.mark.gpu
def test_bench_int8_embed_at_256_runs_the_wgmma_kernel(cuda):
    """The bench's int8 embed: the bag of 256 patches at 224 px, bf16, of
    ``bench.run_bench`` runs each of r18's 19 convs on ``qconv_wgmma_kernel``
    and its epilogues on K7 and K8."""
    from montecarlo_gated_mil_tpu_torch import bench
    from montecarlo_gated_mil_tpu_torch.models.gamil import MultiHeadGatedAttentionMIL
    from montecarlo_gated_mil_tpu_torch.ops import quantized

    model = bench._seeded(lambda: MultiHeadGatedAttentionMIL(dtype=torch.bfloat16)).to(cuda)
    plan = quantized.quantize_backbone_static(model.feature_extractor, "r18")
    patches, mask = bench._workload(256, 224, torch.bfloat16, cuda)

    def embed():
        with torch.inference_mode():
            quantized.quantized_embed_static(plan, patches, mask)

    wgmma_fn, gather_fn = cuda_build.DEVICE_FUNCTIONS["qconv.cu"]
    assert _device_launches(embed) == {wgmma_fn: 19, gather_fn: 0}
    assert _device_launches(embed, "bn_quant.cu") == {
        "bn_stats_kernel": 20, "bn_relu_quant_kernel": 15, "bn_relu_mean_kernel": 1,
        "stem_pool_quant_kernel": 1}


@pytest.mark.gpu
def test_bench_head_runs_mc_head_shared(cuda):
    """The bench's head (the model's default shared gate) launches K2,
    ``mc_head_shared``, once per bag, never K1, and its device functions run."""
    from montecarlo_gated_mil_tpu_torch import bench

    repeats = 2

    def run():
        return bench.run_bench(bag_size=16, patch=64, num_samples=4, repeats=repeats,
                               quantized=False, device=cuda)

    cuda_build.reset_launch_counts()
    rec = run()
    assert rec["value"] > 0 and rec["device"] != "cpu"
    k = cuda_build.KERNELS
    assert k["mc_head_shared"].launches == 1 + bench.TRIALS * repeats
    assert k["mc_head_sep"].launches == 0
    got = _device_launches(run, "mc_head.cu")
    assert got["mc_fwd_tile_kernel"] >= 1 + bench.TRIALS * repeats


@pytest.mark.gpu
def test_ensemble_on_the_card_matches_cpu(cuda):
    """At dropout 0 the fold ensemble on the card (cuDNN f32 convs with TF32
    off, K1) equals its CPU plain path within 1e-4 on the pooled logits and
    attention, member-major."""
    from montecarlo_gated_mil_tpu_torch.core.config import Config
    from montecarlo_gated_mil_tpu_torch.experiment import build_model
    from montecarlo_gated_mil_tpu_torch.mcdo.ensemble import ensemble_mc_inference, stack_params

    cfg = Config(feature_dropout=0.0, attention_dropout=0.0)
    members = stack_params([build_model(cfg, seed=s).state_dict() for s in (1, 2)])
    g = torch.Generator().manual_seed(3)
    mask = torch.arange(16) < 12
    patches = torch.randn(16, 64, 64, 3, generator=g) * mask[:, None, None, None]
    allow = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        before = cuda_build.KERNELS["mc_head_sep"].launches
        got = ensemble_mc_inference(build_model(cfg).to(cuda), members, patches.to(cuda),
                                    mask.to(cuda), 4, 9)
        assert cuda_build.KERNELS["mc_head_sep"].launches - before == 2
    finally:
        torch.backends.cudnn.allow_tf32 = allow
    want = ensemble_mc_inference(build_model(cfg), members, patches, mask, 4, 9)
    torch.testing.assert_close(got.predictions.cpu(), want.predictions, atol=1e-4, rtol=0)
    torch.testing.assert_close(got.attention.cpu(), want.attention, atol=1e-4, rtol=0)


@pytest.mark.gpu
def test_infer_item_on_the_card_matches_cpu(cuda, tmp_path, monkeypatch):
    """``run_inference`` per fold at the CPU tests' geometry (128x128, patch
    64, 10 synthetic records, 2 folds, T=3, dropout 0): each item's bag goes
    through K3 and its head through K1, once per fold and item, and the
    display image, maps and statistics handed to the figure equal the CPU
    path's within 1e-4."""
    import json

    from montecarlo_gated_mil_tpu_torch.core.config import config_from_dict
    from montecarlo_gated_mil_tpu_torch.experiment import build_model
    from montecarlo_gated_mil_tpu_torch.train.state import Checkpointer
    from montecarlo_gated_mil_tpu_torch.viz import infer

    cfg = config_from_dict({
        "seed": 7, "model_path": str(tmp_path), "model": "r18", "N": 3,
        "feature_dropout": 0.0, "attention_dropout": 0.0,
        "data": {"H": 128, "W": 128, "patch_size": 64, "overlap_train": 0.0,
                 "overlap_val_test": 0.0, "empty_threshold": 0.05, "cv_folds": 2,
                 "fraction_test": 0.3, "synthetic_count": 10},
        "tpu": {"buckets": [8, 16]},
    })
    ck = Checkpointer(str(tmp_path))
    folds = [{"fold": k, "checkpoint": ck.save_params(f"fold_{k}", build_model(
        cfg, seed=k).state_dict()), "accuracy": 0.0} for k in (1, 2)]
    (tmp_path / "cv_manifest.json").write_text(json.dumps({"folds": folds}))
    allow = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    runs = {}
    try:
        for dev in ("cuda", "cpu"):
            got = []
            monkeypatch.setattr(infer, "plot_attention_and_density",
                                lambda *a, save_path, **kw: got.append(a) or save_path)
            cuda_build.reset_launch_counts()
            infer.run_inference(cfg, out_dir=str(tmp_path / dev), max_items=2, device=dev)
            runs[dev] = (got, cuda_build.KERNELS["mc_head_sep"].launches,
                         cuda_build.KERNELS["gather_tiles"].launches)
    finally:
        torch.backends.cudnn.allow_tf32 = allow
    (card, k1, k3), (cpu, k1_cpu, k3_cpu) = runs["cuda"], runs["cpu"]
    assert len(card) == len(cpu) == 4 and k1 == 4 and k3 >= 4 and k1_cpu == k3_cpu == 0
    for a, b in zip(card, cpu):
        for x, y in zip(a[:5], b[:5]):
            assert x.shape == y.shape
            torch.testing.assert_close(torch.as_tensor(x), torch.as_tensor(y), atol=1e-4, rtol=0)
        for f in vars(b[5]):
            torch.testing.assert_close(getattr(a[5], f).double(), getattr(b[5], f).double(),
                                       atol=1e-4, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("shared", [False, True])
def test_mc_inference_serial_on_the_card(cuda, shared):
    """``mc_inference_serial`` with dropout on: T launches of the head
    kernel at T=1 (by the wrapper's counter and by device function), the
    auxiliary losses of ``targets``, and every sample within K1's
    tolerances (1e-4 on Y, 1e-5 on A) of the batched ``mc_inference``: the
    row plan may differ between T=1 and T=6, so the sums' order may too."""
    from montecarlo_gated_mil_tpu_torch.mcdo.sampling import mc_inference, mc_inference_serial
    from montecarlo_gated_mil_tpu_torch.models.gamil import MultiHeadGatedAttentionMIL

    torch.manual_seed(2)
    model = MultiHeadGatedAttentionMIL(shared_attention=shared).to(cuda)
    g = torch.Generator().manual_seed(4)
    mask = (torch.arange(16) < 12).to(cuda)
    patches = torch.randn(16, 64, 64, 3, generator=g).to(cuda) * mask[:, None, None, None]
    T = 6
    kernel = cuda_build.KERNELS["mc_head_shared" if shared else "mc_head_sep"]
    allow = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        batched = mc_inference(model, patches, mask, T, 5, targets=1)
        before = kernel.launches
        serial = mc_inference_serial(model, patches, mask, T, 5, targets=1)
        assert kernel.launches - before == T
        got = _device_launches(lambda: mc_inference_serial(model, patches, mask, T, 5),
                               "mc_head.cu")
    finally:
        torch.backends.cudnn.allow_tf32 = allow
    assert got == {"mc_fwd_tile_kernel": T, "mc_fwd_finalize_kernel": T}
    torch.testing.assert_close(serial.predictions, batched.predictions, atol=1e-4, rtol=0)
    torch.testing.assert_close(serial.attention, batched.attention, atol=1e-5, rtol=0)
    assert serial.aux_losses.shape == (T,) and bool(torch.isfinite(serial.aux_losses).all())
    torch.testing.assert_close(serial.aux_losses, batched.aux_losses, atol=1e-5, rtol=0)


@pytest.mark.gpu
def test_single_head_mc_on_the_card_matches_cpu(cuda):
    """The single-head model's MC samples with dropout 0.25 on the card
    equal the CPU's within 1e-5 (probabilities and attention): one seed
    draws the same Philox masks on both.  The head alone on the same
    features agrees within 1e-6."""
    from montecarlo_gated_mil_tpu_torch.mcdo.sampling import mc_inference_single_head
    from montecarlo_gated_mil_tpu_torch.models.gamil import GatedAttentionMIL

    torch.manual_seed(3)
    model = GatedAttentionMIL(feature_dropout=0.25, attention_dropout=0.25)
    g = torch.Generator().manual_seed(5)
    mask = torch.arange(16) < 12
    patches = torch.randn(16, 64, 64, 3, generator=g) * mask[:, None, None, None]
    want = mc_inference_single_head(model, patches, mask, 8, 31, device="cpu")
    allow = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        model_c = model.to(cuda)
        got = mc_inference_single_head(model_c, patches, mask, 8, 31)
    finally:
        torch.backends.cudnn.allow_tf32 = allow
    torch.testing.assert_close(got.predictions.cpu(), want.predictions, atol=1e-5, rtol=0)
    torch.testing.assert_close(got.attention.cpu(), want.attention, atol=1e-5, rtol=0)
    H = torch.rand(16, 512, generator=g)
    with torch.no_grad():
        y_c, a_c = model_c.head(H.to(cuda), mask.to(cuda), mc_dropout=True, seed=7)
        y, a = model.cpu().head(H, mask, mc_dropout=True, seed=7)
    torch.testing.assert_close(y_c.cpu(), y, atol=1e-6, rtol=0)
    torch.testing.assert_close(a_c.cpu(), a, atol=1e-6, rtol=0)


def _cuda_mesh(cuda, data: int = -1, inst: int = 1):
    """A mesh of repeated entries of the one card."""
    from montecarlo_gated_mil_tpu_torch.parallel.mesh import make_mesh

    k = data * inst if data > 0 else inst
    return make_mesh(data=data, inst=inst, devices=[cuda] * k)


@pytest.mark.gpu
@pytest.mark.parametrize("separate", [False, True])
def test_sharded_mc_head_on_the_card_matches_k1(cuda, separate):
    """The instance-sharded head (plain PyTorch, 4 shards of 50 rows, T
    samples in one Philox call per shard) on the card draws K1's dropout
    elements: it equals K1 on the whole bag within K1's limits (1e-4 on Y,
    1e-5 on A)."""
    from montecarlo_gated_mil_tpu_torch.parallel.instance import sharded_mc_gated_attention

    N, L, T = 200, 128, 4
    g = torch.Generator().manual_seed(7)
    H = torch.rand(N, L, generator=g).to(cuda)
    mask = (torch.arange(N) % 4 != 3).to(cuda)
    params = _params(separate).to(cuda)
    y_k, a_k = tga.mc_gated_attention(H, mask, params, T, 3, 0.1, 0.1)
    y, a = sharded_mc_gated_attention(H, mask, params, T, 3, _cuda_mesh(cuda, data=1, inst=4))
    torch.testing.assert_close(y, y_k, atol=1e-4, rtol=0)
    torch.testing.assert_close(a, a_k, atol=1e-5, rtol=0)


@pytest.mark.gpu
def test_sharded_embed_on_the_card_matches_whole(cuda):
    """The instance-sharded r18 embed on the card (cuDNN f32 convs per
    shard, TF32 off) equals the whole-bag embed within 1e-5."""
    from montecarlo_gated_mil_tpu_torch.models.gamil import MultiHeadGatedAttentionMIL
    from montecarlo_gated_mil_tpu_torch.parallel.instance import sharded_embed

    torch.manual_seed(0)
    model = MultiHeadGatedAttentionMIL(shared_attention=False).to(cuda).eval()
    g = torch.Generator().manual_seed(2)
    mask = (torch.arange(16) < 13).to(cuda)
    x = (torch.randn(16, 64, 64, 3, generator=g).to(cuda)) * mask[:, None, None, None]
    allow = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.inference_mode():
            whole = model.embed(x, mask)
            got = sharded_embed(model, x, mask, _cuda_mesh(cuda, data=1, inst=4))
    finally:
        torch.backends.cudnn.allow_tf32 = allow
    torch.testing.assert_close(got, whole, atol=1e-5, rtol=0)


@pytest.mark.gpu
def test_mc_test_dp_on_the_card_equals_sequential(cuda):
    """``mc_test_dp`` over a ``data`` mesh of 2 on the card, with an
    oversized bag that diverts to the sharded route: labels and MC logits
    equal the sequential ``mc_test``'s with the same ``shard_over`` and mesh,
    bag for bag; K1 ran for every regular bag."""
    from montecarlo_gated_mil_tpu_torch.core.bag import Bag
    from montecarlo_gated_mil_tpu_torch.evaluation.dp_eval import _mc_test_dp_outputs
    from montecarlo_gated_mil_tpu_torch.models.gamil import MultiHeadGatedAttentionMIL
    from montecarlo_gated_mil_tpu_torch.train.loops import _mc_test_outputs

    torch.manual_seed(1)
    model = MultiHeadGatedAttentionMIL(shared_attention=False).to(cuda).eval()
    g = torch.Generator().manual_seed(4)
    bags = []
    for i, (bucket, n) in enumerate([(8, 5), (16, 12), (8, 7), (32, 30), (16, 9)]):
        mask = torch.arange(bucket) < n
        x = torch.randn(bucket, 32, 32, 3, generator=g) * mask[:, None, None, None]
        bags.append((Bag(x.to(cuda), mask.to(cuda), torch.tensor(i % 2, device=cuda),
                         torch.arange(bucket, device=cuda)), None))
    mesh = _cuda_mesh(cuda, data=2)
    kw = dict(num_samples=3, seed=5, shard_over=16, mesh=mesh)
    seq = _mc_test_outputs(model, bags, **kw)
    before = cuda_build.KERNELS["mc_head_sep"].launches
    dp = _mc_test_dp_outputs(model, bags, **kw)
    assert cuda_build.KERNELS["mc_head_sep"].launches - before >= 4
    assert dp[1] == seq[1] and all(torch.equal(a, b) for a, b in zip(dp[2], seq[2]))


@pytest.mark.gpu
def test_predict_many_dp_on_the_card_equals_predict(cuda):
    """``predict_many(dp=True)`` on a ``data`` mesh of 2 of the card: every
    result equals ``predict``'s bit for bit."""
    from montecarlo_gated_mil_tpu_torch.core.bag import BucketSpec
    from montecarlo_gated_mil_tpu_torch.data.pipeline import PipelineConfig
    from montecarlo_gated_mil_tpu_torch.data.synthetic import synthetic_image
    from montecarlo_gated_mil_tpu_torch.models.gamil import MultiHeadGatedAttentionMIL
    from montecarlo_gated_mil_tpu_torch.serve import MCDOPredictor

    torch.manual_seed(2)
    pipe = PipelineConfig(height=256, width=256, patch_size=32, overlap=0.0, empty_threshold=0.05,
                          bucket=64)
    pred = MCDOPredictor(MultiHeadGatedAttentionMIL(shared_attention=False), pipe,
                         num_samples=4, bucket_spec=BucketSpec((16, 32, 64)), device=cuda,
                         mesh=_cuda_mesh(cuda, data=2))
    imgs = [synthetic_image(256, 256, positive=bool(s % 2), seed=s) for s in range(3)]
    many = pred.predict_many(imgs, ["L", "R", "L"], seed=3, dp=True)
    for i, (m, img, lat) in enumerate(zip(many, imgs, ["L", "R", "L"])):
        p = pred.predict(img, lat, seed=3 + i)
        assert (m.bucket, m.num_instances) == (p.bucket, p.num_instances)
        assert torch.equal(m.stats.mean_probs, p.stats.mean_probs)
        assert torch.equal(m.attention.std, p.attention.std)


@pytest.mark.gpu
def test_ensemble_sharded_on_the_card_matches_sequential(cuda):
    """The member-sharded ensemble on a ``data`` mesh of 2 of the card equals
    the sequential ensemble within 2e-5; K1 ran once per member."""
    from montecarlo_gated_mil_tpu_torch.core.config import Config
    from montecarlo_gated_mil_tpu_torch.experiment import build_model
    from montecarlo_gated_mil_tpu_torch.mcdo.ensemble import (
        ensemble_mc_inference,
        ensemble_mc_inference_sharded,
    )

    cfg = Config()
    members = [build_model(cfg, seed=s).state_dict() for s in (1, 2, 3, 4)]
    g = torch.Generator().manual_seed(3)
    mask = (torch.arange(16) < 12).to(cuda)
    patches = (torch.randn(16, 64, 64, 3, generator=g).to(cuda)) * mask[:, None, None, None]
    model = build_model(cfg).to(cuda)
    want = ensemble_mc_inference(model, members, patches, mask, 4, 9)
    before = cuda_build.KERNELS["mc_head_sep"].launches
    got = ensemble_mc_inference_sharded(model, members, patches, mask, 4, 9,
                                        _cuda_mesh(cuda, data=2))
    assert cuda_build.KERNELS["mc_head_sep"].launches - before == 4
    torch.testing.assert_close(got.predictions, want.predictions, atol=2e-5, rtol=0)
    torch.testing.assert_close(got.attention, want.attention, atol=2e-5, rtol=0)


@pytest.mark.gpu
def test_sharded_train_step_on_the_card_matches_whole(cuda):
    """The instance-sharded training step on an ``inst`` mesh of 4 of the
    card (cuDNN f32, TF32 off, dropout on) equals the whole-bag step: loss
    rtol 1e-4, gradients rtol 2e-3 / atol 2e-5; each step ran K1 and K5 once."""
    import copy

    from montecarlo_gated_mil_tpu_torch.core.bag import Bag
    from montecarlo_gated_mil_tpu_torch.models.gamil import MultiHeadGatedAttentionMIL
    from montecarlo_gated_mil_tpu_torch.train.criteria import cross_entropy
    from montecarlo_gated_mil_tpu_torch.train.state import (
        TrainState,
        make_train_step,
        make_train_step_sharded,
    )

    torch.manual_seed(3)
    base = MultiHeadGatedAttentionMIL(shared_attention=False).to(cuda)
    g = torch.Generator().manual_seed(5)
    mask = (torch.arange(32) < 27).to(cuda)
    x = (torch.randn(32, 64, 64, 3, generator=g).to(cuda)) * mask[:, None, None, None]
    bag = Bag(x, mask, torch.tensor(1, device=cuda), torch.arange(32, device=cuda))
    allow = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        runs = []
        for sharded in (False, True):
            model = copy.deepcopy(base)
            opt = torch.optim.SGD(model.parameters(), lr=0.01)
            step = (make_train_step_sharded(model, cross_entropy, opt, 2,
                                            _cuda_mesh(cuda, data=1, inst=4))
                    if sharded else make_train_step(model, cross_entropy, opt, 2))
            k1, k5 = (cuda_build.KERNELS[n].launches for n in ("mc_head_sep", "mc_head_bwd_sep"))
            _, out = step(TrainState(model, opt), bag, 7, False)
            assert cuda_build.KERNELS["mc_head_sep"].launches - k1 == 1
            assert cuda_build.KERNELS["mc_head_bwd_sep"].launches - k5 == 1
            runs.append((float(out["loss"]), {n: p.grad for n, p in model.named_parameters()}))
    finally:
        torch.backends.cudnn.allow_tf32 = allow
    (loss, want), (got_loss, got) = runs
    assert abs(got_loss - loss) <= 1e-4 * abs(loss)
    for n in want:
        torch.testing.assert_close(got[n], want[n], rtol=2e-3, atol=2e-5, msg=n)


@pytest.mark.gpu
def test_train_epoch_dp_on_the_card_equals_sequential(cuda):
    """``train_epoch_dp`` on a ``data`` mesh of 2 of the card over three bags
    (a full group and a padded one), one update at epoch end, dropout on:
    the weights equal ``train_epoch``'s within 2e-5; K1 and K5 ran once per
    real bag."""
    import copy

    from montecarlo_gated_mil_tpu_torch.core.bag import Bag
    from montecarlo_gated_mil_tpu_torch.models.gamil import MultiHeadGatedAttentionMIL
    from montecarlo_gated_mil_tpu_torch.parallel.dp import make_dp_train_step
    from montecarlo_gated_mil_tpu_torch.train import loops
    from montecarlo_gated_mil_tpu_torch.train.criteria import cross_entropy
    from montecarlo_gated_mil_tpu_torch.train.state import TrainState, make_train_step

    torch.manual_seed(4)
    base = MultiHeadGatedAttentionMIL(shared_attention=False).to(cuda)
    g = torch.Generator().manual_seed(6)
    items = []
    for i, n in enumerate((13, 16, 9)):
        mask = (torch.arange(16) < n).to(cuda)
        x = (torch.randn(16, 32, 32, 3, generator=g).to(cuda)) * mask[:, None, None, None]
        items.append((Bag(x, mask, torch.tensor(i % 2, device=cuda),
                          torch.arange(16, device=cuda)), None))
    kw = dict(epoch=1, accumulation_steps=3, key=2)
    seq, dp = copy.deepcopy(base), copy.deepcopy(base)
    opt = torch.optim.SGD(seq.parameters(), lr=0.01)
    loops.train_epoch(make_train_step(seq, cross_entropy, opt, 3), TrainState(seq, opt), items,
                      **kw)
    opt = torch.optim.SGD(dp.parameters(), lr=0.01)
    mesh = _cuda_mesh(cuda, data=2)
    step, apply_pending = make_dp_train_step(dp, cross_entropy, opt, mesh)
    k1, k5 = (cuda_build.KERNELS[n].launches for n in ("mc_head_sep", "mc_head_bwd_sep"))
    state = loops.train_epoch_dp(step, apply_pending, TrainState(dp, opt), items, mesh, **kw)
    assert state.step == 1
    assert cuda_build.KERNELS["mc_head_sep"].launches - k1 == 3
    assert cuda_build.KERNELS["mc_head_bwd_sep"].launches - k5 == 3
    for (n, a), b in zip(seq.state_dict().items(), dp.state_dict().values()):
        torch.testing.assert_close(b, a, atol=2e-5, rtol=0, msg=n)


@pytest.mark.gpu
def test_slope_time_of_k1_matches_the_event_time(cuda):
    """K1 (a) (N=3072, 2400 valid at random, T=50, shipped widths): the
    chained slope is within 10 % of the sleep-ahead event time."""
    _, params, H, mask, _ = _chip_smoke()._head_inputs(False, 3072, 2400, "random", 1)

    def k1(h):
        return tga.mc_gated_attention(h, mask, params, 50, 17, 0.1, 0.1)

    event = time_ms(lambda: k1(H), iters=10).ms
    slope = slope_time(k1, H) * 1e3
    assert abs(slope - event) <= 0.10 * event, (slope, event)


@pytest.mark.gpu
def test_kernel_table_times_k1_and_k5_in_a_train_step(cuda):
    """A profiled training step of the shipped model (separate gates) names
    K1's and K5's device functions with device time, and the launch check
    holds."""
    from montecarlo_gated_mil_tpu_torch.core.bag import Bag
    from montecarlo_gated_mil_tpu_torch.models.gamil import MultiHeadGatedAttentionMIL
    from montecarlo_gated_mil_tpu_torch.train.criteria import cross_entropy
    from montecarlo_gated_mil_tpu_torch.train.state import TrainState, make_train_step

    torch.manual_seed(2)
    model = MultiHeadGatedAttentionMIL(shared_attention=False).to(cuda)
    opt = torch.optim.SGD(model.parameters(), lr=1e-3)
    step = make_train_step(model, cross_entropy, opt, 1)
    state = TrainState(model, opt)
    mask = torch.arange(64, device=cuda) < 50
    x = torch.randn(64, 64, 64, 3, device=cuda) * mask[:, None, None, None]
    bag = Bag(x, mask, torch.tensor(1, device=cuda), torch.arange(64, device=cuda))
    step(state, bag, 2, True)  # warm, untraced
    table = kernel_table(lambda: step(state, bag, 3, True))
    table.check_launched()
    assert table.launched["mc_head_sep"] == table.launched["mc_head_bwd_sep"] == 1
    for source in ("mc_head.cu", "mc_head_bwd.cu"):
        assert table.ms(*cuda_build.DEVICE_FUNCTIONS[source]) > 0, source
    assert all(ms > 0 for ms in table.functions("mc_head_bwd.cu").values())


@pytest.mark.gpu
def test_phase_timer_on_the_card_holds_its_device_work(cuda):
    """A sleep kernel inside a phase: with the card as its device the phase
    lasts at least the sleep's event time; without a device it ends as soon
    as the host has queued the sleep."""
    cycles = 100_000_000  # about 50-60 ms at the H100's SM clocks
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    torch.cuda._sleep(cycles)
    end.record()
    end.synchronize()
    sleep_s = start.elapsed_time(end) / 1e3
    synced, host = PhaseTimer(device=cuda), PhaseTimer()
    with synced.phase("sleep"):
        torch.cuda._sleep(cycles)
    with host.phase("sleep"):
        torch.cuda._sleep(cycles)
    torch.cuda.synchronize()
    assert 0.9 * sleep_s <= synced.seconds("sleep") <= sleep_s + 0.02
    assert host.seconds("sleep") < 0.5 * sleep_s


@pytest.mark.gpu
def test_default_flags_step_gradients_match_f64(cuda):
    """One f32 training step of the shipped model (64 instances of 64 px, 48
    valid) with TF32 at PyTorch's defaults (cuDNN's on, the matrix
    products' off), through K1 and K5 (``chip_smoke.default_flags_step``):
    its gradients equal bit for bit those of the same step with TF32 off in
    the whole process, which the loss back-propagated outside
    ``exact_float_grads`` does not, and lie within phase 14's limits of an
    f64 step of the same weights, bag and dropout."""
    old = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, False
    try:
        r = _chip_smoke().default_flags_step(bucket=64, valid=0.75, patch=64, steps=1)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = old
    print({k: v for k, v in r.items() if k != "launches"})
    assert r["exact"]["equal_to_off"] and not r["tf32"]["equal_to_off"]
    assert r["exact"]["excess"] <= 0, r["exact"]
    assert r["launches"]["mc_head_sep"] == r["launches"]["mc_head_bwd_sep"] == 1
