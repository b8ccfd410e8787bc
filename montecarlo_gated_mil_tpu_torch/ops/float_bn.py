"""The float embed's masked BN on the card: K7's sums, then K9's one pass.

Counterpart of the BatchNorm that XLA fuses for the JAX package's float
embed (``montecarlo_gated_mil_tpu/models/resnet.py:43``,
``MaskedBatchStatsNorm``, with the ReLU, residual add and stem max-pool
after it); no Pallas kernel.  Eager PyTorch runs that chain as about
sixteen reads and writes of the activation a BN, where three are needed,
so on a CUDA tensor the port runs two hand-written kernels instead:

- :func:`bn_sums`: the per-instance channel sums and sums of squares over
  ``(h, w)``, K7 (``csrc/bn_quant.cu``, :func:`quant_kernels.bn_stats`) in
  one read, accumulated in float64 in a fixed order.  The masked moments,
  ``(N, C)`` and ``(C,)`` ops, stay in torch (``models/resnet.py``).
- :func:`bn_apply`: K9 (``csrc/bn_apply.cu``), ``((x * scale - mean) * inv)
  * w + b`` in the statistics' dtype with one rounding an operation, as the
  chain computes it, then the call site's epilogue: ReLU; a block end's
  residual add and ReLU, the residual the identity or the downsample conv's
  raw output under its own BN (:class:`Downsample`); or, for the stem, the
  3x3/2 max-pool taken first on the raw conv output.  It may write over
  its input.

A CPU tensor runs the chain (:func:`bn_sums_chain`,
:func:`bn_apply_chain`), as the port always has.  :func:`bn_apply_reference`
writes K9's own algorithm (pool first by the sign of ``w``, the downsample's
affine inline) in torch; the CPU tests hold it to the chain bit for bit,
and the card tests hold K9 to the chain.  Stored dtypes f32, bf16 and f64,
with f32, f32 and f64 statistics; activations NCHW in ``channels_last``
memory, as the float embed keeps them.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from montecarlo_gated_mil_tpu_torch.ops import cuda_build
from montecarlo_gated_mil_tpu_torch.ops.quant_kernels import bn_stats

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float64: 2}
K9_THREADS = 256  # threads per block (THREADS in csrc/bn_apply.cu)


def stats_dtype(dtype: torch.dtype) -> torch.dtype:
    """Statistics in >= float32: promote bf16/f16, never demote float64."""
    return torch.promote_types(dtype, torch.float32)


class Norm(NamedTuple):
    """One BN's per-channel ``mean`` and ``inv = rsqrt(var + eps)``, in the
    statistics' dtype, and its affine ``weight`` and ``bias``."""

    mean: torch.Tensor
    inv: torch.Tensor
    weight: torch.Tensor
    bias: torch.Tensor


class Downsample(NamedTuple):
    """A block end's residual still to be normalized: the downsample conv's
    raw output ``x`` and its BN's :class:`Norm` (the bag's ``scale`` is
    the main BN's)."""

    x: torch.Tensor
    norm: Norm


def _ch(v: torch.Tensor) -> torch.Tensor:
    return v[None, :, None, None]


# ------------------------------------------------------------- the chain


def bn_sums_chain(x: torch.Tensor):
    """Per-instance ``(sum, sum of squares)`` over ``(h, w)`` of ``x (N, C,
    h, w)``, ``(N, C)`` each in the statistics' dtype, as PyTorch's reductions
    take them."""
    xf = x.to(stats_dtype(x.dtype))
    return xf.sum(dim=(2, 3)), xf.square().sum(dim=(2, 3))


def _normalized(x: torch.Tensor, scale: torch.Tensor | None, norm: Norm) -> torch.Tensor:
    """The chain's ``((x [* scale] - mean) * inv) * w + b`` in the statistics'
    dtype, in place on a fresh tensor, rounded to ``x``'s dtype."""
    xf = x.to(stats_dtype(x.dtype))
    y = (xf.clone() if xf is x else xf) if scale is None else xf * scale
    y.sub_(_ch(norm.mean)).mul_(_ch(norm.inv))
    y.mul_(_ch(norm.weight.to(y.dtype)))
    y.add_(_ch(norm.bias.to(y.dtype)))
    return y.to(x.dtype)


def epilogue(y: torch.Tensor, relu: bool = False, residual: torch.Tensor | None = None,
             pool: bool = False) -> torch.Tensor:
    """What follows a BN in the embed, as torch ops: ``relu(y + residual)``
    at a block end, else ``relu(y)`` with ``relu``; then the stem's 3x3/2
    max-pool (padding 1) with ``pool``."""
    if residual is not None:
        y = F.relu(y + residual)
    elif relu:
        y = F.relu(y)
    return F.max_pool2d(y, kernel_size=3, stride=2, padding=1) if pool else y


def bn_apply_chain(x, scale, norm: Norm, relu: bool = False, residual=None,
                   pool: bool = False) -> torch.Tensor:
    """Plain version of K9: the masked BN's normalize as the port has always
    run it (:func:`_normalized`), then :func:`epilogue`; a
    :class:`Downsample` residual is normalized the same way first."""
    if isinstance(residual, Downsample):
        residual = _normalized(residual.x, scale, residual.norm)
    return epilogue(_normalized(x, scale, norm), relu, residual, pool)


def bn_apply_reference(x, scale, norm: Norm, relu: bool = False, residual=None,
                       pool: bool = False) -> torch.Tensor:
    """K9's algorithm in torch: with ``pool`` the 3x3/2 max (min where the
    channel's ``w < 0``) of the raw ``x`` first, then the normalize and
    ReLU; a :class:`Downsample` residual under its own BN inline, rounded to
    the stored dtype before the add.  Equal to :func:`bn_apply_chain` bit
    for bit (the affine is monotone in ``x``: ``scale >= 0``, ``inv > 0``)."""
    if pool:
        hi = F.max_pool2d(x, kernel_size=3, stride=2, padding=1)
        lo = -F.max_pool2d(-x, kernel_size=3, stride=2, padding=1)
        x = torch.where(_ch(norm.weight < 0), lo, hi)
    y = _normalized(x, scale, norm)
    if isinstance(residual, Downsample):
        residual = _normalized(residual.x, scale, residual.norm)
    return epilogue(y, relu or pool, residual)


# ----------------------------------------------------------- the kernels


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    """``x`` in ``channels_last`` memory (a copy only where it is not)."""
    return x.contiguous(memory_format=torch.channels_last)


def bn_sums(x: torch.Tensor):
    """Per-instance ``(sum, sum of squares)`` over ``(h, w)`` of ``x (N, C,
    h, w)``, ``(N, C)`` each in the statistics' dtype: K7 on a CUDA tensor
    (float64 sums in one read, rounded to f32, or kept f64 for f64), the
    chain's reductions on a CPU tensor."""
    if not x.is_cuda:
        return bn_sums_chain(x)
    return bn_stats(_nhwc(x).permute(0, 2, 3, 1))


def _vectors(norm: Norm, sd: torch.dtype, c: int, device) -> list[torch.Tensor]:
    """The BN's four ``(C,)`` vectors as the kernel reads them."""
    out = [v.detach().to(device=device, dtype=sd).contiguous() for v in norm]
    for v in out:
        if v.shape != (c,):
            raise ValueError(f"bn_apply: a BN vector of shape {tuple(v.shape)} for {c} channels")
    return out


def _bn_apply_cuda(x, scale, norm, relu, residual, pool, inplace):
    kernel = cuda_build.KERNELS["bn_apply"]
    if x.dtype not in _DTYPE_CODE or x.dim() != 4:
        raise ValueError(f"{kernel.name}: expected a 4-d float32, bfloat16 or float64 CUDA "
                         f"tensor, got {x.dtype} {tuple(x.shape)}")
    t = _nhwc(x)
    n, c, h, w = t.shape
    vec = 16 // t.element_size()
    if c % vec or (pool and (residual is not None or not relu or c // vec > K9_THREADS)) or (
            residual is not None and not relu):
        raise ValueError(f"{kernel.name}: unsupported call: {tuple(t.shape)} {t.dtype}, relu "
                         f"{relu}, residual {type(residual).__name__}, pool {pool} (C a multiple "
                         f"of {vec}; a residual or the pool only with the ReLU)")
    sd = stats_dtype(t.dtype)
    keep = _vectors(norm, sd, c, t.device)
    sc = None if scale is None else scale.detach().to(device=t.device, dtype=sd).reshape(())
    nm = (ctypes.c_void_p * 4)(*(v.data_ptr() for v in keep))
    lib = cuda_build.load(kernel.source)
    i32, i64, ptr = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
    stream = cuda_build.stream_handle(t.device)
    if pool:
        oh, ow = (h - 1) // 2 + 1, (w - 1) // 2 + 1
        out = torch.empty((n, c, oh, ow), dtype=t.dtype, device=t.device,
                          memory_format=torch.channels_last)
        fn = lib.bn_apply_pool
        fn.argtypes = [ptr, ptr, i32, ptr, ptr] + [i32] * 6 + [ptr]
        args = (t.data_ptr(), out.data_ptr(), _DTYPE_CODE[t.dtype],
                None if sc is None else sc.data_ptr(), nm, n, h, w, oh, ow, c, stream)
    else:
        epi, xr, rn = int(relu), None, None
        if residual is not None:
            epi = 3 if isinstance(residual, Downsample) else 2
            xr = _nhwc(residual.x if epi == 3 else residual)
            if xr.shape != t.shape or xr.dtype != t.dtype or xr.device != t.device:
                raise ValueError(f"{kernel.name}: residual {xr.dtype} {tuple(xr.shape)} on "
                                 f"{xr.device} for {t.dtype} {tuple(t.shape)} on {t.device}")
            if epi == 3:
                keep += _vectors(residual.norm, sd, c, t.device)
                rn = (ctypes.c_void_p * 4)(*(v.data_ptr() for v in keep[4:]))
        out = t if inplace else torch.empty_like(t, memory_format=torch.channels_last)
        fn = lib.bn_apply
        fn.argtypes = [ptr, ptr, i32, ptr, ptr, i32, ptr, ptr, i64, i32, ptr]
        args = (t.data_ptr(), out.data_ptr(), _DTYPE_CODE[t.dtype],
                None if sc is None else sc.data_ptr(), nm, epi,
                None if xr is None else xr.data_ptr(), rn, n * h * w, c, stream)
    if out.numel():
        fn.restype = ctypes.c_int
        with torch.cuda.device(t.device):  # t's stream takes launches on t's card alone
            err = fn(*args)
        cuda_build.check(err, kernel.name)
        kernel.launches += 1
    return out


def bn_apply(x, scale, norm: Norm, relu: bool = False, residual=None, pool: bool = False,
             inplace: bool = False) -> torch.Tensor:
    """The masked BN's normalize of ``x (N, C, h, w)`` with the bag's
    ``scale`` (``min(n_valid, 1)``, None without a mask) and ``norm``, then
    the epilogue (:func:`epilogue`; ``residual`` a tensor shaped as ``x`` or
    a :class:`Downsample`).  K9 on a CUDA tensor, writing over ``x`` with
    ``inplace`` (the pool writes a new, quarter-size tensor); the chain on a
    CPU tensor, which never writes over ``x``."""
    if not x.is_cuda:
        return bn_apply_chain(x, scale, norm, relu, residual, pool)
    return _bn_apply_cuda(x, scale, norm, relu, residual, pool, inplace)
