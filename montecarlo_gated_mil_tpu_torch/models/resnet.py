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

One walk through the network (:func:`_walk`, :func:`_walk_block`) serves a
whole bag and a bag split into instance shards over several devices
(:func:`sharded_features`, ``parallel/instance.py``); the two differ only in
the BN step they hand it.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Sequence

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
            count, mean, var, scale = _masked_moments(s1, s2, m, hw)
            y = xf * scale
        inv = torch.rsqrt(var + eps)
        _normalize_(y, mean, inv, weight, bias)
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


def _masked_moments(s1: torch.Tensor, s2: torch.Tensor, m: torch.Tensor, hw: int):
    """``(count, mean, var, scale)`` of a masked BN from the per-instance
    channel sums ``s1``, ``s2 (N, C)`` and the float mask ``m (N,)``."""
    n_valid = m.sum()
    count = torch.clamp(n_valid * hw, min=1.0)
    mean = (s1 * m[:, None]).sum(0) / count
    var = (s2 * m[:, None]).sum(0) / count - mean.square()
    return count, mean, var, torch.clamp(n_valid, max=1.0)


def _normalize_(y: torch.Tensor, mean, inv, weight, bias) -> None:
    """``y = (y - mean) * inv * weight + bias`` per channel, in place."""
    y.sub_(mean[None, :, None, None]).mul_(inv[None, :, None, None])
    y.mul_(weight.to(y.dtype)[None, :, None, None])
    y.add_(bias.to(y.dtype)[None, :, None, None])


def _shard_moments(xs: Sequence[torch.Tensor], masks: Sequence[torch.Tensor], eps: float):
    """The whole bag's BN moments from its shards, on the first shard's
    device: each shard's per-instance channel sums and sums of squares over
    ``(h, w)``, concatenated in shard order (``parallel/mesh.py::
    gather_shards``), then reduced as the unsharded BN reduces them
    (:func:`_masked_moments`).  Returns ``(count, mean, inv, scale)``."""
    from montecarlo_gated_mil_tpu_torch.parallel.mesh import gather_shards

    sd = _stats_dtype(xs[0].dtype)
    hw = xs[0].shape[2] * xs[0].shape[3]
    s1s, s2s = [], []
    for x in xs:
        xf = x.to(sd)
        s1s.append(xf.sum(dim=(2, 3)))
        s2s.append(xf.square().sum(dim=(2, 3)))
    dev = xs[0].device
    m = gather_shards([mask.to(sd) for mask in masks], dev)
    count, mean, var, scale = _masked_moments(gather_shards(s1s, dev), gather_shards(s2s, dev),
                                              m, hw)
    return count, mean, torch.rsqrt(var + eps), scale


class _ShardedMaskedBatchNorm(torch.autograd.Function):
    """:func:`sharded_batch_norm` under autograd: one node over every
    shard's input, weight and bias, so that the backward can take the two
    channel sums that couple the instances over the whole bag.

    ``forward(ctx, bns, masks, *xs, *weights, *biases)`` normalizes as the
    inference path does (the same operations, so the same numbers).  The backward is
    ``_MaskedBatchNorm.backward`` split over shards: each shard sends the
    per-instance sums over ``(h, w)`` of ``g`` and ``g * xhat`` to the first
    device, where they are concatenated in shard order and summed over the
    bag into ``d_bias`` and ``d_weight``; ``d_var`` and ``d_mean`` follow
    from those, go back to every shard, and each forms its own ``dx``.
    ``d_weight`` and ``d_bias`` go to the first shard's BN (the shards'
    copies share one set of weights; ``parallel/instance.py::
    sharded_embed_grad`` sums the copies' gradients).  No float atomics.
    """

    @staticmethod
    def forward(ctx, bns, masks, *tensors):
        # tensors: every shard's input, then each shard's BN weight and bias.
        k = len(bns)
        xs = tensors[:k]
        count, mean, inv, scale = _shard_moments(xs, masks, bns[0].eps)
        ctx.bns, ctx.masks, ctx.count, ctx.scale = bns, masks, count, scale
        ctx.save_for_backward(mean, inv, *xs)
        ys = []
        for x, bn in zip(xs, bns):
            y = x.to(_stats_dtype(x.dtype)) * scale.to(x.device)
            _normalize_(y, mean.to(y.device), inv.to(y.device), bn.weight, bn.bias)
            ys.append(y.to(x.dtype))
        return tuple(ys)

    @staticmethod
    def backward(ctx, *gys):
        from montecarlo_gated_mil_tpu_torch.parallel.mesh import gather_shards

        mean, inv, *xs = ctx.saved_tensors
        bns, count, scale = ctx.bns, ctx.count, ctx.scale
        sd = _stats_dtype(xs[0].dtype)
        dev = mean.device

        def ch(v, device):
            return v.to(device)[None, :, None, None]

        pb, pw = [], []
        for x, gy in zip(xs, gys):
            g = gy.to(sd)
            xhat = (x.to(sd) * scale.to(x.device) - ch(mean, x.device)) * ch(inv, x.device)
            pb.append(g.sum(dim=(2, 3)))
            pw.append((g * xhat).sum(dim=(2, 3)))
            del g, xhat
        d_bias = gather_shards(pb, dev).sum(0)
        d_weight = gather_shards(pw, dev).sum(0)
        w = bns[0].weight.to(device=dev, dtype=sd)
        # As _MaskedBatchNorm.backward, with (dxhat * xhat).sum = w * d_weight
        # and dxhat.sum = w * d_bias.
        d_var = -0.5 * (w * d_weight) * inv.square()
        d_mean = -(w * d_bias * inv) - 2.0 * mean * d_var
        dxs = []
        for x, gy, bn, mask in zip(xs, gys, bns, ctx.masks):
            xf = x.to(sd)
            wm = mask.to(device=x.device, dtype=sd)[:, None, None, None] / count.to(x.device)
            dx = gy.to(sd) * ch(bn.weight.to(sd) * inv.to(x.device) * scale.to(x.device), x.device)
            dx = dx + wm * (ch(d_mean, x.device) + 2.0 * ch(d_var, x.device) * xf)
            dxs.append(dx.to(x.dtype))
        rest = [None] * (len(bns) - 1)
        return (None, None, *dxs, d_weight.to(bns[0].weight.dtype), *rest,
                d_bias.to(bns[0].bias.dtype), *rest)


def sharded_batch_norm(
    bns: Sequence["MaskedBatchStatsNorm"], xs: list, masks: Sequence[torch.Tensor],
    relu: bool = False,
) -> list[torch.Tensor]:
    """:class:`MaskedBatchStatsNorm` over a bag whose instances are split
    into shards: ``xs[s] (n_s, C, h, w)`` with validity ``masks[s]`` and
    ``bns[s]``, the BN's copy, all on shard ``s``'s device; with ``relu``
    the ReLU that follows.

    The only coupling between shards is the statistics.  Each shard takes
    its instances' channel sums and sums of squares over ``(h, w)``, as the
    unsharded forward does, and sends them, ``(n_s, C)`` each, with its mask
    to the first shard's device.  There they are concatenated in shard
    order (``parallel/mesh.py::gather_shards``) and the masked sums over the
    bag, the valid count, mean and variance are taken exactly as the
    unsharded BN takes them (:func:`_masked_moments`); the moments go back
    to every shard, which normalizes its own instances.  So the result is
    the whole-bag BN's wherever the per-instance sums come out the same.
    The partials are ``2 * N * C`` numbers a layer, against the ``N * C *
    h * w`` of the activations.

    Where autograd records (training's instance-sharded step), the layer is
    one :class:`_ShardedMaskedBatchNorm` node, whose backward reduces its
    channel sums across shards the same way; it keeps every shard's input
    for the backward, as the unsharded BN keeps the bag's.  Otherwise (the
    evaluation paths) the entries of ``xs`` are released as their shards are
    normalized, so a layer holds about one copy of its activations, as the
    unsharded layer does.
    """
    if torch.is_grad_enabled() and any(
        t.requires_grad for t in [*xs, bns[0].weight, bns[0].bias]
    ):
        ys = _ShardedMaskedBatchNorm.apply(bns, list(masks), *xs, *(bn.weight for bn in bns),
                                           *(bn.bias for bn in bns))
        xs.clear()
        return [F.relu(y) if relu else y for y in ys]
    _, mean, inv, scale = _shard_moments(xs, masks, bns[0].eps)
    out = []
    for s, bn in enumerate(bns):
        x, xs[s] = xs[s], None
        dtype = x.dtype
        y = x.to(_stats_dtype(dtype)) * scale.to(x.device)
        del x  # freed before the normalize, which runs in place on y
        _normalize_(y, mean.to(y.device), inv.to(y.device), bn.weight, bn.bias)
        y = y.to(dtype)
        out.append(F.relu(y) if relu else y)
    return out


def _whole_norm(mask: torch.Tensor | None):
    """The ``norm`` of :func:`_walk` for a whole bag: its one entry through
    the autograd BN with ``mask``.  The entry is popped, so a conv's output
    is freed once the BN has read it."""

    def norm(bns, ys, relu):
        y = bns[0](ys.pop(), mask)
        return [F.relu(y) if relu else y]

    return norm


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


class _ResidualBlock(nn.Module):
    """A residual block: ``conv1, bn1, ..., conv{depth}, bn{depth}`` with a
    ReLU after every BN but the last, and the identity or the ``downsample``
    projection ``(conv, bn)`` as its shortcut."""

    depth: int

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
        return _walk_block([self], [x], _whole_norm(mask))[0]


def _walk_block(blocks: Sequence[_ResidualBlock], xs: list, norm) -> list:
    """One residual block over instance shards: ``blocks[s]`` is the block
    on shard ``s``'s device, ``xs[s]`` its input.  ``norm(bns, ys, relu)``
    normalizes the shards ``ys`` with the BNs ``bns`` (then the ReLU): the
    one step in which the whole bag (:func:`_whole_norm`) and its shards
    (:func:`sharded_batch_norm`) differ."""
    depth = blocks[0].depth
    ys = xs
    for k in range(1, depth + 1):
        ys = norm([getattr(b, f"bn{k}") for b in blocks],
                  [_conv(getattr(b, f"conv{k}"), y) for b, y in zip(blocks, ys)], k < depth)
    residual = xs
    if blocks[0].downsample is not None:
        residual = norm([b.downsample[1] for b in blocks],
                        [_conv(b.downsample[0], x) for b, x in zip(blocks, xs)], False)
    return [F.relu(y + r) for y, r in zip(ys, residual)]


class BasicBlock(_ResidualBlock):
    """Two 3x3 convs + identity/projection shortcut (r18/r34 block)."""

    expansion = 1
    depth = 2

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


class Bottleneck(_ResidualBlock):
    """1x1 -> 3x3 -> 1x1 (x4 expansion) block (r50)."""

    expansion = 4
    depth = 3

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


@contextlib.contextmanager
def exact_float_grads(dtype: torch.dtype):
    """Where a float32 (or float64) model's gradient is taken: neither
    cuDNN's convolutions nor the matrix products run in TF32 meanwhile, and
    both flags are restored as they were found.  Autograd runs the backward
    convolutions after :func:`_exact_float_convs` has closed, under the
    process's flags (cuDNN's TF32 is on by PyTorch's default), so every
    ``backward()`` and ``torch.autograd.grad`` of the port runs inside this.
    Other dtypes pass through."""
    if dtype not in (torch.float32, torch.float64):
        yield
        return
    old = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = old


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
        return _walk([self], [x], _whole_norm(mask))[0]

    def stages(self, mask: torch.Tensor | None = None) -> list[tuple[str, Callable]]:
        """:meth:`forward` cut at its stage boundaries, for per-stage timing:
        ``[("stem", f), ("l1", f), ...]`` (see :func:`_stages`).  Applied in
        order to the patches they compute :meth:`forward`."""
        return [(name, lambda x, run=run: run([x])[0])
                for name, run in _stages([self], _whole_norm(mask))]

    def _stem(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC patches -> the stem conv's NCHW output."""
        if self.space_to_depth:
            return _s2d_stem(self.conv1, x)
        # NHWC storage viewed as NCHW: a channels_last tensor, no copy.
        return _conv(self.conv1, x.permute(0, 3, 1, 2))


def _stages(nets: Sequence[ResNetFeatures], norm) -> list[tuple[str, Callable]]:
    """The backbone over instance shards cut at its stage boundaries:
    ``[("stem", f), ("l1", f), ...]``, each ``f`` taking the shards' inputs
    (``nets[s]`` on shard ``s``'s device) to the shards' outputs.  The stem
    is the conv, BN, ReLU and max pool; each layer its blocks, the last
    with the global pool.  ``f`` empties the list it is given, so a caller's
    name does not keep a stage's input alive through its later blocks.
    ``norm`` is as in :func:`_walk_block`."""
    net = nets[0]

    def stem(given: list) -> list:
        xs = [x.to(net.dtype) for x in given]
        given.clear()
        with _exact_float_convs(net.dtype):
            # The stem's output goes to ``norm`` in a temporary list: held by
            # a name, it would stay alive through the BN and the ReLU (9.9 GB
            # at bucket 3072).
            xs = norm([n.bn1 for n in nets], [n._stem(x) for n, x in zip(nets, xs)], True)
            return [F.max_pool2d(x, kernel_size=3, stride=2, padding=1) for x in xs]

    def layer(i: int):
        def run(given: list) -> list:
            xs = list(given)
            given.clear()
            with _exact_float_convs(net.dtype):
                for j in range(len(getattr(net, f"layer{i}"))):
                    xs = _walk_block([getattr(n, f"layer{i}")[j] for n in nets], xs, norm)
            if i < net.num_stages:
                return xs
            # Global average pool, accumulated in >= f32.
            return [x.to(_stats_dtype(x.dtype)).mean(dim=(2, 3)) for x in xs]

        return run

    return [("stem", stem)] + [(f"l{i}", layer(i)) for i in range(1, net.num_stages + 1)]


def _walk(nets: Sequence[ResNetFeatures], xs: list, norm) -> list:
    """The backbone over instance shards, ``nets[s]`` on shard ``s``'s
    device with input ``xs[s] (n_s, H, W, 3)``; returns each shard's pooled
    features ``(n_s, L)``.  ``norm`` is as in :func:`_walk_block`."""
    xs = list(xs)
    for _, run in _stages(nets, norm):
        xs = run(xs)
    return xs


def sharded_features(nets: Sequence[ResNetFeatures], xs: list, masks: list) -> list:
    """:meth:`ResNetFeatures.forward` over one bag split into instance
    shards: ``nets[s]``, the backbone's copy on shard ``s``'s device, embeds
    ``xs[s] (n_s, H, W, 3)`` with validity ``masks[s] (n_s,)``; returns each
    shard's features ``(n_s, L)`` on its device.  Convolutions run per
    shard; every BN takes the whole bag's masked statistics
    (:func:`sharded_batch_norm`), so the features equal ``forward``'s up to
    the order of the statistics' sums."""
    return _walk(nets, xs, lambda bns, ys, relu: sharded_batch_norm(bns, ys, masks, relu))


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
