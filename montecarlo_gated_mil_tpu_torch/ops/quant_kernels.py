"""The int8 embed's kernels: K6 int8 convolution, K7 BN statistics, K8
normalize + ReLU + requantize.  Each has its plain PyTorch version here.

Counterparts of work that XLA compiled for the JAX package without a Pallas
kernel (``montecarlo_gated_mil_tpu/ops/quantized.py``): the int8 convs
(``_qconv_static``/``_qconv_stored``) and the fused loops of ``_bn_affine``,
``norm_relu_quant`` and the residual/requantize/pool epilogues.  PyTorch
has no int8 convolution on CUDA, and an eager chain of the epilogue's ops
would read and write every activation about seven times, so the port writes
all three by hand (``csrc/qconv.cu``, ``csrc/bn_quant.cu``).

A CUDA tensor launches the kernel (or raises: there is no fallback); a CPU
tensor runs the plain version.  The plain versions repeat the kernels'
arithmetic op for op, so on the card the two agree code for code:

- K6: the integer sums are exact in float64 (|sum| <= 127^2 * 4608 <
  2^53), so ``F.conv2d`` of the codes in float64 is the exact int32
  accumulator; the epilogue rounds ``f32(acc) * scale`` once, to bf16, to
  e4m3 after a clamp to +-448, or to int8 after ``round`` and a clip to
  +-127 (the i8 store scales by ``s / t``, computed once in f32).
- K7: per (instance, channel) sums of the stored value and of its square,
  accumulated in float64 (in another order on the card: the two agree to
  the last bit or two of the f32 result).
- K8: ``relu(v * A + B [+ residual])`` with one rounding per operation, then
  round half to even and clip to int8, or the f32 mean over (h, w); the
  stem mode max-pools 3x3/2 (padding -inf) before rounding; the mean mode
  accumulates in float64.

Stored conv outputs are NHWC ``(N, h, w, C)`` in bf16, float8_e4m3fn or
int8; an int8 store is read back as ``f32(code) * t`` (``tq`` below).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from montecarlo_gated_mil_tpu_torch.ops import cuda_build

STORE_DTYPES = {"bf16": torch.bfloat16, "f8": torch.float8_e4m3fn, "i8": torch.int8}
_DTYPE_CODE = {torch.bfloat16: 0, torch.float8_e4m3fn: 1, torch.int8: 2}
F8_MAX = 448.0  # largest finite float8_e4m3fn


class Residual(NamedTuple):
    """What a block adds before its final ReLU: ``load(x, tq) * scale``
    (the int8 identity, ``tq`` None, ``shift`` None) or
    ``load(x, tq) * scale + shift`` (the downsample's stored conv output
    under its own BN affine)."""

    x: torch.Tensor
    tq: torch.Tensor | None
    scale: torch.Tensor
    shift: torch.Tensor | None


def load_stored(t: torch.Tensor, tq: torch.Tensor | None = None) -> torch.Tensor:
    """f32 view of a stored tensor: ``f32(t)``, times ``tq`` per channel for
    an int8 conv store (JAX ``_load_t``)."""
    v = t.to(torch.float32)
    return v if tq is None else v * tq


# --------------------------------------------------------------------- K6


def conv_out_hw(h: int, w: int, kh: int, kw: int, stride: int, pad) -> tuple[int, int]:
    top, bottom, left, right = pad
    return (h + top + bottom - kh) // stride + 1, (w + left + right - kw) // stride + 1


def store_epilogue(acc: torch.Tensor, scale: torch.Tensor, store: str) -> torch.Tensor:
    """int32 accumulators -> the stored dtype.  ``scale`` is the dequant
    scale ``s`` for bf16/f8 and ``s / t`` for i8."""
    y = acc.to(torch.float32) * scale
    if store == "i8":
        return torch.clamp(torch.round(y), -127, 127).to(torch.int8)
    if store == "f8":
        return torch.clamp(y, -F8_MAX, F8_MAX).to(torch.float8_e4m3fn)
    return y.to(torch.bfloat16)


def qconv_accumulate(a: torch.Tensor, w: torch.Tensor, stride: int, pad) -> torch.Tensor:
    """Exact int32 accumulators of an int8 conv: NHWC ``a``, ``(Cout, kh,
    kw, Cin)`` ``w``, per-side ``pad = (top, bottom, left, right)``."""
    top, bottom, left, right = pad
    x = F.pad(a.permute(0, 3, 1, 2).to(torch.float64), (left, right, top, bottom))
    acc = F.conv2d(x, w.permute(0, 3, 1, 2).to(torch.float64), stride=stride)
    return acc.permute(0, 2, 3, 1).to(torch.int32).contiguous()


def qconv_reference(a, w, scale, stride: int, pad, store: str) -> torch.Tensor:
    """Plain version of K6: exact accumulators, then the store epilogue."""
    return store_epilogue(qconv_accumulate(a, w, stride, pad), scale, store)


def _require(name: str, t: torch.Tensor, dtypes, ndim: int) -> None:
    if not (t.is_cuda and t.dtype in dtypes and t.dim() == ndim and t.is_contiguous()
            and t.data_ptr() % 16 == 0):
        raise ValueError(
            f"{name}: expected a contiguous, 16-byte aligned {ndim}-d CUDA tensor of "
            f"{[str(d) for d in dtypes]}, got {t.dtype} {tuple(t.shape)} on {t.device} "
            f"(contiguous={t.is_contiguous()})"
        )


def _vec(name: str, v: torch.Tensor, n: int) -> None:
    if not (v.is_cuda and v.dtype == torch.float32 and v.shape == (n,) and v.is_contiguous()):
        raise ValueError(f"{name}: expected a contiguous float32 CUDA vector of {n}, got "
                         f"{v.dtype} {tuple(v.shape)} on {v.device}")


def _ptr(t: torch.Tensor | None) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _qconv_cuda(a, w, scale, stride: int, pad, store: str) -> torch.Tensor:
    kernel = cuda_build.KERNELS["qconv_i8"]
    _require(kernel.name, a, (torch.int8,), 4)
    _require(kernel.name, w, (torch.int8,), 4)
    n, h, wd, cin = a.shape
    cout, kh, kw, wcin = w.shape
    _vec(kernel.name, scale, cout)
    top, bottom, left, right = pad
    if (wcin != cin or cin % 4 or cout % 64 or (kh * kw * cin) % 16 or store not in STORE_DTYPES
            or min(pad) < 0 or stride < 1):
        raise ValueError(f"{kernel.name}: unsupported conv: a {tuple(a.shape)}, w "
                         f"{tuple(w.shape)}, stride {stride}, pad {pad}, store {store!r} "
                         "(needs Cin % 4 == 0, Cout % 64 == 0, kh*kw*Cin % 16 == 0)")
    oh, ow = conv_out_hw(h, wd, kh, kw, stride, pad)
    out = torch.empty((n, oh, ow, cout), dtype=STORE_DTYPES[store], device=a.device)
    if out.numel() == 0:
        return out
    fn = cuda_build.load(kernel.source).qconv_i8
    fn.restype = ctypes.c_int
    i32, ptr = ctypes.c_int, ctypes.c_void_p
    fn.argtypes = [ptr, ptr, ptr, ptr] + [i32] * 13 + [ptr]
    err = fn(a.data_ptr(), w.data_ptr(), scale.data_ptr(), out.data_ptr(), n, h, wd, cin, cout,
             kh, kw, stride, top, left, oh, ow, ("bf16", "f8", "i8").index(store),
             cuda_build.stream_handle(a.device))
    cuda_build.check(err, kernel.name)
    kernel.launches += 1
    return out


def qconv(a, w, scale, stride: int, pad, store: str) -> torch.Tensor:
    """int8 conv (K6): NHWC int8 ``a`` x ``(Cout, kh, kw, Cin)`` int8 ``w``
    -> ``(N, oh, ow, Cout)`` in ``store``'s dtype."""
    if a.is_cuda:
        return _qconv_cuda(a, w, scale, stride, pad, store)
    return qconv_reference(a, w, scale, stride, pad, store)


# --------------------------------------------------------------------- K7


def bn_stats_reference(t: torch.Tensor, tq: torch.Tensor | None = None):
    """Plain version of K7: per (instance, channel) sum and sum of squares
    over (h, w) of the stored tensor's f32 view, accumulated in float64 as
    the kernel does, rounded to f32."""
    v = load_stored(t, tq).to(torch.float64)
    return v.sum(dim=(1, 2)).to(torch.float32), v.square().sum(dim=(1, 2)).to(torch.float32)


def _channels_ok(c: int) -> bool:
    return c % 8 == 0 and c <= 2048


def _bn_stats_cuda(t, tq):
    kernel = cuda_build.KERNELS["bn_stats"]
    _require(kernel.name, t, tuple(_DTYPE_CODE), 4)
    n, h, w, c = t.shape
    if not _channels_ok(c) or (t.dtype == torch.int8) != (tq is not None):
        raise ValueError(f"{kernel.name}: unsupported input {t.dtype} {tuple(t.shape)} "
                         "(C % 8 == 0, C <= 2048; an int8 store needs its tq and only it)")
    if tq is not None:
        _vec(kernel.name, tq, c)
    s1 = torch.empty((n, c), dtype=torch.float32, device=t.device)
    s2 = torch.empty_like(s1)
    if n == 0:
        return s1, s2
    fn = cuda_build.load(kernel.source).bn_stats
    fn.restype = ctypes.c_int
    i32, i64, ptr = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
    fn.argtypes = [ptr, i32, ptr, i32, i64, i32, ptr, ptr, ptr]
    err = fn(t.data_ptr(), _DTYPE_CODE[t.dtype], _ptr(tq), n, h * w, c, s1.data_ptr(),
             s2.data_ptr(), cuda_build.stream_handle(t.device))
    cuda_build.check(err, kernel.name)
    kernel.launches += 1
    return s1, s2


def bn_stats(t: torch.Tensor, tq: torch.Tensor | None = None):
    """BN statistics (K7) of a stored conv output: ``(sum, sum of squares)``,
    each ``(N, C)`` f32, over (h, w), in one read."""
    if t.is_cuda:
        return _bn_stats_cuda(t, tq)
    return bn_stats_reference(t, tq)


# --------------------------------------------------------------------- K8

MODES = ("i8", "mean", "pool_i8")


def bn_relu_quant_reference(t, tq, scale, shift, residual: Residual | None = None,
                            mode: str = "i8") -> torch.Tensor:
    """Plain version of K8, the JAX package's epilogue lines in order:
    ``relu(load(t) * scale + shift [+ load(x) * rs (+ rb)])``, then
    ``clip(round(.), +-127)`` to int8 (``"i8"``), the f32 mean over (h, w)
    (``"mean"``), or a 3x3/2 max-pool padded with -inf before the rounding
    (``"pool_i8"``)."""
    y = load_stored(t, tq) * scale + shift
    if residual is not None:
        r = load_stored(residual.x, residual.tq) * residual.scale
        if residual.shift is not None:
            r = r + residual.shift
        y = y + r
    a = torch.clamp(y, min=0.0)
    if mode == "mean":  # accumulated in float64, as the kernel does
        return a.to(torch.float64).mean(dim=(1, 2)).to(torch.float32)
    if mode == "pool_i8":
        a = F.max_pool2d(a.permute(0, 3, 1, 2), kernel_size=3, stride=2, padding=1)
        a = a.permute(0, 2, 3, 1)
    return torch.clamp(torch.round(a), -127, 127).to(torch.int8).contiguous()


def _bn_relu_quant_cuda(t, tq, scale, shift, residual, mode):
    kernel = cuda_build.KERNELS["bn_relu_quant"]
    _require(kernel.name, t, tuple(_DTYPE_CODE), 4)
    n, h, w, c = t.shape
    bad = (not _channels_ok(c) or mode not in MODES or (t.dtype == torch.int8) != (tq is not None)
           or (mode == "pool_i8" and (residual is not None or t.dtype != torch.bfloat16)))
    res_kind = 0
    if residual is not None and not bad:
        _require(kernel.name, residual.x, tuple(_DTYPE_CODE), 4)
        _vec(kernel.name, residual.scale, c)
        if residual.shift is None:  # the int8 identity
            res_kind = 1
            bad = residual.x.dtype != torch.int8 or residual.tq is not None
        else:  # the downsample, stored as t is
            res_kind = 2
            _vec(kernel.name, residual.shift, c)
            bad = residual.x.dtype != t.dtype or (t.dtype == torch.int8) != (
                residual.tq is not None)
            if residual.tq is not None:
                _vec(kernel.name, residual.tq, c)
        bad = bad or residual.x.shape != t.shape
    if bad:
        raise ValueError(f"{kernel.name}: unsupported inputs: t {t.dtype} {tuple(t.shape)}, "
                         f"mode {mode!r}, residual "
                         f"{None if residual is None else (residual.x.dtype, tuple(residual.x.shape))}")
    for v in (scale, shift) + (() if tq is None else (tq,)):
        _vec(kernel.name, v, c)
    lib = cuda_build.load(kernel.source)
    i32, i64, ptr = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
    stream = cuda_build.stream_handle(t.device)
    if mode == "pool_i8":
        oh, ow = (h - 1) // 2 + 1, (w - 1) // 2 + 1
        out = torch.empty((n, oh, ow, c), dtype=torch.int8, device=t.device)
        fn = lib.stem_pool_quant
        fn.argtypes = [ptr, ptr, ptr, ptr] + [i32] * 6 + [ptr]
        args = (t.data_ptr(), scale.data_ptr(), shift.data_ptr(), out.data_ptr(), n, h, w, oh,
                ow, c, stream)
    else:
        if mode == "mean":
            out = torch.empty((n, c), dtype=torch.float32, device=t.device)
        else:
            out = torch.empty((n, h, w, c), dtype=torch.int8, device=t.device)
        r = residual or Residual(None, None, None, None)
        fn = lib.bn_relu_quant
        fn.argtypes = [ptr, i32, ptr, ptr, ptr, i32, ptr, ptr, ptr, ptr, i32, ptr, i32, i64, i32,
                       ptr]
        args = (t.data_ptr(), _DTYPE_CODE[t.dtype], _ptr(tq), scale.data_ptr(), shift.data_ptr(),
                res_kind, _ptr(r.x), _ptr(r.tq), _ptr(r.scale), _ptr(r.shift),
                int(mode == "mean"), out.data_ptr(), n, h * w, c, stream)
    if out.numel() == 0:
        return out
    fn.restype = ctypes.c_int
    cuda_build.check(fn(*args), kernel.name)
    kernel.launches += 1
    return out


def bn_relu_quant(t, tq, scale, shift, residual: Residual | None = None,
                  mode: str = "i8") -> torch.Tensor:
    """Normalize + ReLU + requantize (K8) of a stored conv output with the
    per-channel affine ``(scale, shift)``; see
    :func:`bn_relu_quant_reference` for the modes."""
    if t.is_cuda:
        return _bn_relu_quant_cuda(t, tq, scale, shift, residual, mode)
    return bn_relu_quant_reference(t, tq, scale, shift, residual, mode)
