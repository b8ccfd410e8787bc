"""K8's host side on the CPU: the algebra its stem mode relies on, the grid
geometry the wrapper hands the kernels, the launches that ``chip_smoke.py``
times, and the wrapper's refusals.

The stem kernel pools the raw stored values first (max where the channel's
scale A > 0, min where A < 0) and applies the affine, ReLU and rounding once
per output; the plain version applies them at every tap and pools after.
The property test holds the two equal code for code.  No JAX model is
built.
"""

import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from hypothesis import given, settings
from hypothesis import strategies as st

from montecarlo_gated_mil_tpu_torch.ops import cuda_build
from montecarlo_gated_mil_tpu_torch.ops import quant_kernels as qk


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the suite runs several worker
    processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _chip_smoke():
    if "chip_smoke" not in sys.modules:
        path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
        spec = importlib.util.spec_from_file_location("chip_smoke", path)
        module = importlib.util.module_from_spec(spec)
        sys.modules["chip_smoke"] = module
        spec.loader.exec_module(module)
    return sys.modules["chip_smoke"]


def _pool_first(t: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """The stem kernel's order of work: 3x3/2 max (A > 0) or min (A <= 0)
    of the stored values, then one affine, ReLU, rounding and clip."""
    v = t.to(torch.float32).permute(0, 3, 1, 2)
    hi = F.max_pool2d(v, kernel_size=3, stride=2, padding=1)
    lo = -F.max_pool2d(-v, kernel_size=3, stride=2, padding=1)
    pooled = torch.where((scale < 0)[None, :, None, None], lo, hi).permute(0, 2, 3, 1)
    y = torch.clamp(pooled * scale + shift, min=0.0)
    return torch.clamp(torch.round(y), -127, 127).to(torch.int8)


_scales = st.one_of(st.just(0.0), st.just(-0.0),
                    st.floats(-60.0, 60.0, allow_nan=False, width=32))


@settings(max_examples=150, deadline=None)
@given(
    h=st.integers(1, 9), w=st.integers(1, 9), c=st.integers(1, 6), n=st.integers(1, 2),
    seed=st.integers(0, 2**32 - 1), spread=st.sampled_from([0.01, 1.0, 40.0]),
    levels=st.sampled_from([0, 3]), data=st.data(),
)
def test_pool_first_equals_pool_after_quantize(h, w, c, n, seed, spread, levels, data):
    """On bf16 values (with ties when ``levels`` > 0) and scales of either
    sign or zero, pool-first gives exactly the plain version's codes."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0.0, spread, size=(n, h, w, c))
    if levels:  # few distinct values: ties between taps, and +-0
        x = rng.integers(-levels, levels + 1, size=(n, h, w, c)) * spread
    t = torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    scale = torch.tensor(data.draw(st.lists(_scales, min_size=c, max_size=c)),
                         dtype=torch.float32)
    shift = torch.from_numpy(rng.normal(0.0, 20.0, size=c).astype(np.float32))
    want = qk.bn_relu_quant_reference(t, None, scale, shift, mode="pool_i8")
    assert torch.equal(_pool_first(t, scale, shift), want)


def test_pool_first_needs_the_sign_of_the_scale():
    """Max-pooling first regardless of the sign would be wrong: with A < 0
    the largest code comes from the smallest stored value."""
    t = torch.tensor([1.0, 2.0, 3.0, 4.0]).view(1, 2, 2, 1).to(torch.bfloat16)
    scale, shift = torch.tensor([-10.0]), torch.tensor([50.0])
    want = qk.bn_relu_quant_reference(t, None, scale, shift, mode="pool_i8")
    assert int(want) == 40 and torch.equal(_pool_first(t, scale, shift), want)


# (N, H, W, C): every K8 launch of r18 at N=3072, r50's widest, the narrow
# and ragged channel counts, a handful of pixels.
GEOMETRY_CASES = sorted({(3072, *hwc) for _, hwc, *_ in _chip_smoke().K8_SHAPES[1:]}) + [
    (3072, 7, 7, 2048), (3, 9, 7, 24), (2, 3, 3, 8), (1, 1, 1, 64), (5, 4, 4, 1000),
]


@pytest.mark.parametrize("n, h, w, c", GEOMETRY_CASES)
@pytest.mark.parametrize("itemsize", [2, 1])
@pytest.mark.parametrize("mode", ["i8", "mean"])
def test_elementwise_geometry_covers_every_pixel(n, h, w, c, itemsize, mode):
    """A thread's channels are one 16-byte load of ``t`` where C allows
    (8 bf16; 16 one-byte values) and a block holds every channel group; the
    ``i8`` grid is at most K8_BLOCKS_PER_SM blocks an SM and has no empty
    block; the ``mean`` grid has a thread per (instance, group)."""
    sms = 132
    geo = qk.bn_relu_quant_geometry(n, h * w, c, itemsize, mode, sms)
    assert c % geo.vec == 0
    assert geo.vec * itemsize == 16 or (itemsize, geo.vec) == (1, 8) and c % 16 != 0
    groups = c // geo.vec
    assert groups <= qk.K8_THREADS
    if mode == "mean":
        assert (geo.blocks - 1) * qk.K8_THREADS < n * groups <= geo.blocks * qk.K8_THREADS
    else:
        rows = qk.K8_THREADS // groups
        assert 1 <= geo.blocks <= sms * qk.K8_BLOCKS_PER_SM
        assert (geo.blocks - 1) * rows < n * h * w  # every block owns a pixel
        if n * h * w >= sms * qk.K8_BLOCKS_PER_SM * rows:
            assert geo.blocks == sms * qk.K8_BLOCKS_PER_SM


@pytest.mark.parametrize("w, c, slab", [(112, 64, 64), (32, 64, 64), (7, 64, 64),
                                        (112, 2048, 64), (112, 24, 24), (500, 64, 8),
                                        (958, 8, 8)])
def test_stem_geometry_fits_the_ring(w, c, slab):
    """The r18 stem's 112 x 64 rows stream whole; wider rows narrow the
    slab to a multiple of 8 dividing C.  Three blocks fit an SM's 228 KB."""
    geo = qk.stem_pool_geometry(w, c)
    assert geo.slab == slab and c % geo.slab == 0 and geo.slab % 8 == 0
    smem = 128 + (3 + 2 * geo.lookahead) * w * geo.slab * 2  # as csrc/bn_quant.cu sizes it
    assert smem <= qk.STEM_SMEM_BYTES and 3 * (smem + 1024) <= 228 * 1024


def test_stem_geometry_refuses_rows_too_wide():
    with pytest.raises(ValueError, match="does not fit"):
        qk.stem_pool_geometry(959, 64)


def _launches(embed, patches):
    """(h, w, C, mode, residual kind) of every K8 launch, and (h, w, C) of
    every K7 launch and of every conv that takes K7's sums in K6's epilogue,
    while ``embed`` runs the plain versions."""
    from montecarlo_gated_mil_tpu_torch.ops import quantized

    k7, k8, fused = [], [], []
    stats, quant, conv_stats = quantized.bn_stats, quantized.bn_relu_quant, quantized.qconv_stats

    def rec_stats(t, tq=None):
        k7.append(tuple(t.shape[1:]))
        return stats(t, tq)

    def rec_conv_stats(*args):
        out = conv_stats(*args)
        fused.append(tuple(out[0].shape[1:]))
        return out

    def rec_quant(t, tq, scale, shift, residual=None, mode="i8"):
        kind = None if residual is None else ("identity" if residual.shift is None
                                              else "downsample")
        k8.append((*t.shape[1:], mode, kind))
        return quant(t, tq, scale, shift, residual, mode)

    quantized.bn_stats, quantized.bn_relu_quant = rec_stats, rec_quant
    quantized.qconv_stats = rec_conv_stats
    try:
        embed(patches)
    finally:
        quantized.bn_stats, quantized.bn_relu_quant = stats, quant
        quantized.qconv_stats = conv_stats
    return k7, k8, fused


def test_chip_smoke_times_every_k7_and_k8_launch_of_a_request():
    """``chip_smoke.py``'s K7_SHAPES and K8_SHAPES list each distinct set of
    BN sums and K8 launch of an r18 int8 embed with its count per request
    (17 K8, 20 sums: the stem's by K7, the 19 convs' in K6's epilogue).
    Here at 64 px, where every map is 3.5 times smaller than at 224 px."""
    from collections import Counter

    from montecarlo_gated_mil_tpu_torch.models.resnet import make_backbone
    from montecarlo_gated_mil_tpu_torch.ops import quantized

    torch.manual_seed(0)
    plan = quantized.quantize_backbone_static(make_backbone("r18"), "r18")
    patches = torch.from_numpy(
        np.random.default_rng(0).uniform(-2.0, 2.5, (1, 64, 64, 3)).astype(np.float32))
    with torch.inference_mode():
        k7, k8, fused = _launches(lambda p: quantized.quantized_embed_static(plan, p), patches)

    def at_224(h, w):
        return int(h * 3.5), int(w * 3.5)

    cs = _chip_smoke()
    assert [at_224(h, w) + (c,) for h, w, c in k7] == [(112, 112, 64)]  # the stem alone
    assert Counter((*at_224(h, w), c) for h, w, c in k7 + fused) == {
        hwc: k for _, hwc, k in cs.K7_SHAPES}
    assert Counter((*at_224(h, w), c, mode, res) for h, w, c, mode, res in k8) == {
        (*hwc, mode, res): k for _, hwc, mode, res, k in cs.K8_SHAPES}
    assert sum(k for *_, k in cs.K8_SHAPES) == 17 and sum(k for *_, k in cs.K7_SHAPES) == 20


def test_chip_smoke_loads_without_importing_the_port():
    """``chip_smoke.py`` imports nothing of the port when it loads, so that
    ``--kernels-from DIR`` and ``--heads-from DIR`` time the package under
    DIR, not this tree's; its fold count per request agrees with
    ``quant_kernels.sum_tiles``."""
    import subprocess

    root = Path(__file__).resolve().parents[1]
    code = ("import importlib.util, sys\n"
            "spec = importlib.util.spec_from_file_location('cs', 'chip_smoke.py')\n"
            "cs = importlib.util.module_from_spec(spec); spec.loader.exec_module(cs)\n"
            "print(sorted(m for m in sys.modules if m.startswith('montecarlo_gated_mil_tpu')))\n"
            "print(cs.FOLDS_PER_REQUEST)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                         timeout=120, check=True).stdout.split("\n")
    assert out[0] == "[]"
    cs = _chip_smoke()
    want = sum(per for _, h, w, _, _, k, s, pad, per in cs.QCONV_SHAPES
               if per and qk.sum_tiles(*qk.conv_out_hw(h, w, k, k, s, pad)) > 1)
    assert int(out[1]) == cs.FOLDS_PER_REQUEST == want == 14


@pytest.mark.parametrize("mode", qk.MODES)
def test_cpu_tensors_raise_before_any_launch(mode):
    """The CUDA wrapper refuses CPU tensors, naming ``bn_relu_quant``,
    before it builds or launches anything."""
    t = torch.zeros(2, 4, 4, 64, dtype=torch.bfloat16)
    kernel = cuda_build.KERNELS["bn_relu_quant"]
    before = kernel.launches
    with pytest.raises(ValueError, match="bn_relu_quant"):
        qk._bn_relu_quant_cuda(t, None, torch.ones(64), torch.zeros(64), None, mode)
    assert kernel.launches == before
