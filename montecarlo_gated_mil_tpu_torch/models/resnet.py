"""ResNet backbones (18/34/50) with masked batch-statistics BatchNorm.

Counterpart of ``montecarlo_gated_mil_tpu/models/resnet.py``.  The
reference embeds every patch with a torchvision ResNet whose ``fc`` is the
identity and whose BatchNorm always normalizes with the current batch's
statistics; the batch is the N patches of one bag.  Bags are padded to
fixed buckets, so the statistics are taken over the valid instances only.

The public layout is the JAX package's: patches ``(N, h, w, 3)`` NHWC in,
features ``(N, L)`` out.  Inside, the convolutions run on an NCHW view in
``channels_last`` memory, which is the same bytes as NHWC.  Parameter names
follow torchvision (``conv1``, ``layer1.0.bn2``, ``layer2.0.downsample.0``),
so ``weights.py`` maps them one to one onto the JAX parameter tree.

``space_to_depth=True`` runs the stem as its exact space-to-depth form (a
4x4 stride-1 conv over 2x2-rearranged input, :func:`s2d_stem_kernel`), with
the same ``conv1.weight``; the quantized embed's ``stem="s2d_i8"`` uses the
same rearrangement.
"""

from __future__ import annotations

import contextlib
import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

# Feature dimension produced by each backbone (torchvision fc.in_features).
FEATURE_DIMS = {"r18": 512, "r34": 512, "r50": 2048}


def _stats_dtype(dtype: torch.dtype) -> torch.dtype:
    """Statistics in >= float32: promote bf16/f16, never demote float64."""
    return torch.promote_types(dtype, torch.float32)


class _MaskedBatchNorm(torch.autograd.Function):
    """Masked batch-statistics BN with a hand-written backward.

    Saves the input, the per-channel mean and ``rsqrt(var + eps)`` only, so a
    training step keeps one tensor per BN instead of the three an autograd
    of the plain ops keeps (normalized input, centred input, and the input
    of the square).  The forward runs the same operations in the same order
    as ever, in place on a fresh tensor, so its numbers are unchanged.
    """

    @staticmethod
    def forward(ctx, x, weight, bias, mask, eps):
        # x: (N, C, h, w) in any memory format.
        sd = _stats_dtype(x.dtype)
        xf = x.to(sd)
        hw = x.shape[2] * x.shape[3]
        # Per-instance spatial sums first, then the masked sum over N: the
        # (N, C) partials keep the masked reduction from materializing
        # another full-size tensor.
        s1 = xf.sum(dim=(2, 3))
        s2 = xf.square().sum(dim=(2, 3))
        if mask is None:
            m = None
            count = x.shape[0] * hw
            mean = s1.sum(0) / count
            var = s2.sum(0) / count - mean.square()
            scale = None
            y = xf.clone() if xf is x else xf
        else:
            m = mask.to(sd)
            n_valid = m.sum()
            count = torch.clamp(n_valid * hw, min=1.0)
            mean = (s1 * m[:, None]).sum(0) / count
            var = (s2 * m[:, None]).sum(0) / count - mean.square()
            scale = torch.clamp(n_valid, max=1.0)
            y = xf * scale
        inv = torch.rsqrt(var + eps)
        y.sub_(mean[None, :, None, None]).mul_(inv[None, :, None, None])
        y.mul_(weight.to(sd)[None, :, None, None])
        y.add_(bias.to(sd)[None, :, None, None])
        ctx.save_for_backward(x, weight, mean, inv)
        ctx.stats = (m, count, scale)
        return y.to(x.dtype)

    @staticmethod
    def backward(ctx, gy):
        x, weight, mean, inv = ctx.saved_tensors
        m, count, scale = ctx.stats
        sd = _stats_dtype(x.dtype)
        dims = (0, 2, 3)

        def ch(v):
            return v[None, :, None, None]

        xf, g = x.to(sd), gy.to(sd)
        xc = xf if scale is None else xf * scale  # the input the forward normalized
        xhat = (xc - ch(mean)) * ch(inv)
        d_bias = g.sum(dims)
        d_weight = (g * xhat).sum(dims)
        dxhat = g * ch(weight.to(sd))
        # xhat = (xc - mean) * inv, inv = rsqrt(var + eps), var = E_m[x^2] - mean^2,
        # mean = E_m[x]: the batch statistics pass the gradient to every valid x.
        d_var = -0.5 * (dxhat * xhat).sum(dims) * inv.square()
        d_mean = -(dxhat.sum(dims) * inv) - 2.0 * mean * d_var
        dx = dxhat * ch(inv if scale is None else inv * scale)
        w = 1.0 / count if m is None else m[:, None, None, None] / count
        dx = dx + w * (ch(d_mean) + 2.0 * ch(d_var) * xf)
        return dx.to(x.dtype), d_weight.to(weight.dtype), d_bias.to(weight.dtype), None, None


class MaskedBatchStatsNorm(nn.Module):
    """BatchNorm that always uses the current (masked) batch statistics.

    No running statistics, learned affine, eps 1e-5, biased variance taken as
    ``E[x^2] - mean^2`` over ``n_valid * h * w`` values.  ``mask`` (N,) over
    the leading instance axis excludes padded instances.  An all-masked bag
    multiplies the input by ``min(n_valid, 1) = 0`` first, so every layer
    stays finite instead of amplifying by ``rsqrt(eps)``.  Differentiable
    through :class:`_MaskedBatchNorm`.
    """

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        return _MaskedBatchNorm.apply(x, self.weight, self.bias, mask, self.eps)


def _make_conv(cin: int, cout: int, kernel: int, stride: int, pad: int) -> nn.Conv2d:
    """torch-geometry conv: explicit symmetric padding, no bias."""
    return nn.Conv2d(cin, cout, kernel, stride, pad, bias=False)


def _conv(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """Run ``conv`` in the activations' dtype (weights are stored f32)."""
    return F.conv2d(x, conv.weight.to(x.dtype), None, conv.stride, conv.padding)


class BasicBlock(nn.Module):
    """Two 3x3 convs + identity/projection shortcut (r18/r34 block)."""

    expansion = 1

    def __init__(self, cin: int, features: int, stride: int = 1):
        super().__init__()
        self.conv1 = _make_conv(cin, features, 3, stride, 1)
        self.bn1 = MaskedBatchStatsNorm(features)
        self.conv2 = _make_conv(features, features, 3, 1, 1)
        self.bn2 = MaskedBatchStatsNorm(features)
        self.downsample = None
        if stride != 1 or cin != features:
            self.downsample = nn.ModuleList(
                [_make_conv(cin, features, 1, stride, 0), MaskedBatchStatsNorm(features)]
            )

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
        y = F.relu(self.bn1(_conv(self.conv1, x), mask))
        y = self.bn2(_conv(self.conv2, y), mask)
        residual = x
        if self.downsample is not None:
            residual = self.downsample[1](_conv(self.downsample[0], x), mask)
        return F.relu(y + residual)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 -> 1x1 (x4 expansion) block (r50)."""

    expansion = 4

    def __init__(self, cin: int, features: int, stride: int = 1):
        super().__init__()
        out = features * self.expansion
        self.conv1 = _make_conv(cin, features, 1, 1, 0)
        self.bn1 = MaskedBatchStatsNorm(features)
        self.conv2 = _make_conv(features, features, 3, stride, 1)
        self.bn2 = MaskedBatchStatsNorm(features)
        self.conv3 = _make_conv(features, out, 1, 1, 0)
        self.bn3 = MaskedBatchStatsNorm(out)
        self.downsample = None
        if stride != 1 or cin != out:
            self.downsample = nn.ModuleList(
                [_make_conv(cin, out, 1, stride, 0), MaskedBatchStatsNorm(out)]
            )

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
        y = F.relu(self.bn1(_conv(self.conv1, x), mask))
        y = F.relu(self.bn2(_conv(self.conv2, y), mask))
        y = self.bn3(_conv(self.conv3, y), mask)
        residual = x
        if self.downsample is not None:
            residual = self.downsample[1](_conv(self.downsample[0], x), mask)
        return F.relu(y + residual)


def s2d_stem_kernel(w7: torch.Tensor) -> torch.Tensor:
    """``(7, 7, C, 64)`` HWIO stem kernel -> the exact ``(4, 4, 4C, 64)``
    kernel of its space-to-depth form.  The 7x7 stride-2 conv reads
    ``x[2o + k - 3]``; zero-padding the kernel at its leading edge to 8 taps
    makes that ``x[2o + k' - 4]``, which regroups into 4 stride-1 taps over
    2x2 pairs with padding (2, 1).  The channel grouping matches
    :func:`s2d_input`."""
    c = w7.shape[2]
    w8 = F.pad(w7, (0, 0, 0, 0, 1, 0, 1, 0))  # a leading zero tap on ky and kx
    return (
        w8.reshape(4, 2, 4, 2, c, 64)
        .permute(0, 2, 1, 3, 4, 5)
        .reshape(4, 4, 4 * c, 64)
    )


def s2d_input(x: torch.Tensor) -> torch.Tensor:
    """``(N, H, W, C)`` -> ``(N, H/2, W/2, 4C)`` 2x2 space-to-depth, channel
    order matching :func:`s2d_stem_kernel`."""
    n, h, w, c = x.shape
    return (
        x.reshape(n, h // 2, 2, w // 2, 2, c)
        .permute(0, 1, 3, 2, 4, 5)
        .reshape(n, h // 2, w // 2, 4 * c)
    )


def _s2d_stem(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """The 7x7 stride-2 stem as a 4x4 stride-1 conv over s2d input, padded
    (2, 1) on each spatial axis.  ``x``: NHWC; returns NCHW."""
    n, h, w, _ = x.shape
    if h % 2 or w % 2:
        raise ValueError(f"space-to-depth stem needs even H, W; got {h}x{w}")
    wk = s2d_stem_kernel(conv.weight.permute(2, 3, 1, 0)).permute(3, 2, 0, 1)
    x2 = F.pad(s2d_input(x).permute(0, 3, 1, 2), (2, 1, 2, 1))
    return F.conv2d(x2, wk.to(x.dtype))


@contextlib.contextmanager
def _exact_float_convs(dtype: torch.dtype):
    """cuDNN runs float32 convolutions in TF32 by default; a float32 (or
    float64) model must run them exactly, as the JAX package does."""
    if dtype not in (torch.float32, torch.float64):
        yield
        return
    old = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = old


class ResNetFeatures(nn.Module):
    """Headless ResNet: ``(N, H, W, 3) -> (N, L)`` global-pooled features.

    ``mask`` (N,) marks valid instances; BN statistics ignore padded ones.
    ``dtype`` is the compute dtype of the convolutions; parameters stay f32.
    ``space_to_depth`` runs the stem in its exact s2d form (same weights).
    """

    def __init__(
        self,
        stage_sizes: Sequence[int],
        block_cls: type,
        dtype: torch.dtype = torch.float32,
        space_to_depth: bool = False,
    ):
        super().__init__()
        self.dtype = dtype
        self.space_to_depth = space_to_depth
        self.conv1 = _make_conv(3, 64, 7, 2, 3)
        self.bn1 = MaskedBatchStatsNorm(64)
        cin = 64
        for stage, blocks in enumerate(stage_sizes):
            layers = []
            for b in range(blocks):
                stride = 2 if stage > 0 and b == 0 else 1
                layers.append(block_cls(cin, 64 * 2**stage, stride))
                cin = 64 * 2**stage * block_cls.expansion
            setattr(self, f"layer{stage + 1}", nn.ModuleList(layers))
        self.num_stages = len(stage_sizes)
        self.num_features = cin
        _lecun_normal_init(self)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        x = x.to(self.dtype)
        with _exact_float_convs(self.dtype):
            # The stem's output is a temporary: bound to a name, it would stay
            # alive through the BN and the ReLU (9.9 GB at bucket 3072).
            x = F.relu(self.bn1(self._stem(x), mask))
            x = F.max_pool2d(x, kernel_size=3, stride=2, padding=1)
            for i in range(1, self.num_stages + 1):
                for block in getattr(self, f"layer{i}"):
                    x = block(x, mask)
        # Global average pool, accumulated in >= f32.
        return x.to(_stats_dtype(x.dtype)).mean(dim=(2, 3))


    def _stem(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC patches -> the stem conv's NCHW output."""
        if self.space_to_depth:
            return _s2d_stem(self.conv1, x)
        # NHWC storage viewed as NCHW: a channels_last tensor, no copy.
        return _conv(self.conv1, x.permute(0, 3, 1, 2))


def _lecun_normal_init(module: nn.Module) -> None:
    """flax's default conv init (truncated-normal LeCun), so a seeded port
    model has the JAX model's weight statistics."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            fan_in = m.weight.shape[1] * m.weight.shape[2] * m.weight.shape[3]
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std)


_CONFIGS: dict[str, tuple[Sequence[int], type]] = {
    "r18": ((2, 2, 2, 2), BasicBlock),
    "r34": ((3, 4, 6, 3), BasicBlock),
    "r50": ((3, 4, 6, 3), Bottleneck),
}


def make_backbone(
    name: str, dtype: torch.dtype = torch.float32, space_to_depth: bool = False
) -> ResNetFeatures:
    """Backbone factory for the reference's r18/r34/r50 switch."""
    if name not in _CONFIGS:
        raise ValueError(f"backbone must be one of {sorted(_CONFIGS)}, got {name!r}")
    sizes, block = _CONFIGS[name]
    return ResNetFeatures(sizes, block, dtype=dtype, space_to_depth=space_to_depth)


def feature_dim(name: str) -> int:
    """L for a backbone (2048 for r50, 512 otherwise)."""
    if name not in FEATURE_DIMS:
        raise ValueError(f"unknown backbone {name!r}")
    return FEATURE_DIMS[name]
