"""K6's host side on the CPU: the wrapper's refusals, and the input bytes
that ``chip_smoke.py`` counts into K6's bound.

``qconv_i8`` alone picks K6's device function; the card-only tests and
``chip_smoke.py`` read which one ran from the profiler.  No JAX model is
built.
"""

import importlib.util
import sys
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from montecarlo_gated_mil_tpu_torch.ops import cuda_build
from montecarlo_gated_mil_tpu_torch.ops import quant_kernels as qk


def _chip_smoke():
    if "chip_smoke" not in sys.modules:
        path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
        spec = importlib.util.spec_from_file_location("chip_smoke", path)
        module = importlib.util.module_from_spec(spec)
        sys.modules["chip_smoke"] = module
        spec.loader.exec_module(module)
    return sys.modules["chip_smoke"]


SHAPES = {s[0]: s[1:8] for s in _chip_smoke().QCONV_SHAPES}
SHAPES.update({
    "3x3_s2_out_7x6": (13, 11, 64, 128, 3, 2, (1, 1, 1, 1)),
    "1x1_s2_odd": (7, 7, 256, 512, 1, 2, (0, 0, 0, 0)),
    "3x3_s1_9x7": (9, 7, 128, 128, 3, 1, (1, 1, 1, 1)),
})


@pytest.mark.parametrize("label", list(SHAPES))
def test_pixels_read_counts_what_the_taps_touch(label):
    """The pixels whose input gradient is nonzero under a conv of ones are
    those its taps read: a 1x1/2 conv reads one in four."""
    h, w, _, _, k, stride, pad = SHAPES[label]
    x = torch.ones(1, 1, h, w, dtype=torch.float64, requires_grad=True)
    top, bottom, left, right = pad
    y = F.conv2d(F.pad(x, (left, right, top, bottom)),
                 torch.ones(1, 1, k, k, dtype=torch.float64), stride=stride)
    y.sum().backward()
    assert _chip_smoke()._pixels_read(h, w, k, stride, pad) == int((x.grad != 0).sum())


def _conv(dtype=torch.int8, cin=64, cout=64, k=3, device="cpu"):
    a = torch.zeros(2, 8, 8, cin, dtype=dtype, device=device)
    w = torch.zeros(cout, k, k, cin, dtype=torch.int8, device=device)
    return a, w, torch.ones(cout, device=device)


@pytest.mark.parametrize("case", ["cpu_tensor", "float_input", "strided", "bad_store"])
def test_wrong_inputs_raise_before_any_launch(case):
    """The CUDA wrapper refuses, naming ``qconv_i8``, before it builds or
    launches anything: here every tensor lies on the CPU, which it refuses
    first of all."""
    a, w, scale = _conv(dtype=torch.float32 if case == "float_input" else torch.int8)
    store = "bf16"
    if case == "strided":
        a = a.transpose(1, 2)
    elif case == "bad_store":
        store = "f16"
    kernel = cuda_build.KERNELS["qconv_i8"]
    before = kernel.launches
    with pytest.raises(ValueError, match="qconv_i8"):
        qk._qconv_cuda(a, w, scale, 1, (1, 1, 1, 1), store)
    assert kernel.launches == before
