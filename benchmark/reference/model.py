"""Gated-attention MIL over a ResNet, written out in plain PyTorch.

The architecture the configuration names: a torchvision ResNet (He et al.
2016) without its classifier, as ``benchmark/backbones/<backbone>.json``
describes it (``spec.Block`` says what its blocks compute), whose BatchNorm
always normalizes with the statistics of the current bag (biased variance,
eps 1e-5), embeds each 224 px tile into L features (global average pool);
a multi-head gated attention MIL head (Ilse et al. 2018) with one
tanh/sigmoid gate pair, one attention vector and one bias-free linear
classifier per class,

    Hd = feature_dropout(H);  G_c = tanh(Hd V_c + b) * sigmoid(Hd U_c + b)
    A_c = softmax_n(attention_dropout(G_c w_c + b_c));  Y_c = (A_c Hd) . k_c

runs T Monte Carlo samples over one embedding, sample t dropping out with
the Philox stream of ``philox.py`` keyed ``seed + t``.  Parameter names are
the torchvision / reference names under ``feature_extractor.`` and the
head's ``attention_V.{c}.0``, ``attention_U.{c}.0``,
``attention_weights.{c}``, ``classifiers.{c}``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmark import spec
from benchmark.reference import philox

BN_EPS = 1e-5
FE = "feature_extractor."


def schema(backbone: str, L: int, D: int, C: int) -> dict[str, tuple[int, ...]]:
    """Every parameter's name and shape, in the order of the seeded draws:
    the stem's conv and BN; per block its convs, then their BNs, then the
    downsample's conv and BN; the head."""
    s: dict[str, tuple[int, ...]] = {}

    def conv(c: spec.ConvBN):
        s[FE + c.conv + ".weight"] = (c.cout, c.cin, c.kernel, c.kernel)

    def bn(c: spec.ConvBN):
        s[FE + c.bn + ".weight"] = (c.cout,)
        s[FE + c.bn + ".bias"] = (c.cout,)

    net = spec.load_backbone(backbone)
    conv(net.stem)
    bn(net.stem)
    for blk in net.blocks:
        for c in blk.convs:
            conv(c)
        for c in blk.convs:
            bn(c)
        if blk.downsample is not None:
            conv(blk.downsample)
            bn(blk.downsample)
    for c in range(C):
        for g in ("attention_V", "attention_U"):
            s[f"{g}.{c}.0.weight"] = (D, L)
            s[f"{g}.{c}.0.bias"] = (D,)
        s[f"attention_weights.{c}.weight"] = (1, D)
        s[f"attention_weights.{c}.bias"] = (1,)
        s[f"classifiers.{c}.weight"] = (1, L)
    return s


def make_weights(backbone: str, L: int, D: int, C: int, seed: int, device) -> dict:
    """Seeded weights on ``device`` in a few large draws: convolutions from
    a truncated normal of std sqrt(1 / fan_in) / 0.8796 (LeCun, cut at two
    std), BN scales in [0.8, 1.2] and shifts in [-0.1, 0.1], linear layers
    uniform in +-1 / sqrt(fan_in) (torch's default)."""
    g = torch.Generator(device=device).manual_seed(seed)
    sch = schema(backbone, L, D, C)
    convs = [k for k, v in sch.items() if len(v) == 4]
    rest = [k for k in sch if k not in convs]
    n_conv = sum(math.prod(sch[k]) for k in convs)
    z = torch.empty(n_conv, device=device)
    torch.nn.init.trunc_normal_(z, 0.0, 1.0, -2.0, 2.0, generator=g)
    u = torch.rand(sum(math.prod(sch[k]) for k in rest), generator=g, device=device) * 2 - 1
    out, i, j = {}, 0, 0
    for k in convs:
        shape = sch[k]
        n = math.prod(shape)
        std = math.sqrt(1.0 / math.prod(shape[1:])) / 0.87962566103423978
        out[k] = (z[i:i + n] * std).view(shape)
        i += n
    for k in rest:
        shape = sch[k]
        n = math.prod(shape)
        v = u[j:j + n].view(shape)
        j += n
        if k.startswith("feature_extractor."):
            out[k] = 1.0 + 0.2 * v if k.endswith("weight") else 0.1 * v
        else:
            fan_in = shape[-1] if k.endswith("weight") else (L if ".0.bias" in k else D)
            out[k] = v / math.sqrt(fan_in)
    return out


def batch_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               chunk: int | None = None) -> torch.Tensor:
    """BatchNorm of ``(n, C, h, w)`` with the statistics of all n (every
    instance given is valid), the moments in float64, taken over chunks of
    ``chunk`` instances where given."""
    step = x.shape[0] if chunk is None else chunk
    s1 = s2 = 0.0
    for i in range(0, x.shape[0], step):
        x64 = x[i:i + step].to(torch.float64)
        s1 = s1 + x64.sum(dim=(0, 2, 3))
        s2 = s2 + x64.square().sum(dim=(0, 2, 3))
        del x64
    count = x.shape[0] * x.shape[2] * x.shape[3]
    mean = s1 / count
    var = s2 / count - mean.square()
    inv = torch.rsqrt(var + BN_EPS)
    scale = (w.to(torch.float64) * inv).to(x.dtype)
    shift = (b.to(torch.float64) - mean * w.to(torch.float64) * inv).to(x.dtype)
    return x * scale[None, :, None, None] + shift[None, :, None, None]


def _conv(x, w, stride, pad, chunk):
    """A convolution in chunks of instances (the same numbers as one call)."""
    if chunk is None or x.shape[0] <= chunk:
        return F.conv2d(x, w, stride=stride, padding=pad)
    return torch.cat([F.conv2d(x[i:i + chunk], w, stride=stride, padding=pad)
                      for i in range(0, x.shape[0], chunk)])


def _conv_bn(p: dict, c: spec.ConvBN, x: torch.Tensor, chunk: int | None) -> torch.Tensor:
    y = _conv(x, p[FE + c.conv + ".weight"].to(x.dtype), c.stride, c.pad, chunk)
    return batch_norm(y, p[FE + c.bn + ".weight"], p[FE + c.bn + ".bias"], chunk)


def stem(p: dict, net: spec.Backbone, x: torch.Tensor, chunk: int | None) -> torch.Tensor:
    """NCHW tiles -> the stem's convolution, BN, ReLU and max pool."""
    k, stride, pad = net.pool
    return F.max_pool2d(F.relu(_conv_bn(p, net.stem, x, chunk)), kernel_size=k, stride=stride,
                        padding=pad)


def block(p: dict, blk: spec.Block, x: torch.Tensor, chunk: int | None) -> torch.Tensor:
    """One residual block, as ``spec.Block`` defines it."""
    y = x
    for i, c in enumerate(blk.convs):
        y = _conv_bn(p, c, y, chunk)
        if i < len(blk.convs) - 1:
            y = F.relu(y)
    r = x if blk.downsample is None else _conv_bn(p, blk.downsample, x, chunk)
    return F.relu(y + r)


def embed(p: dict, patches: torch.Tensor, backbone: str = "r18",
          chunk: int | None = 256) -> torch.Tensor:
    """``(n, 224, 224, 3)`` valid tiles -> ``(n, L)`` features in the dtype
    of ``patches``.  Under autograd (training) pass ``chunk=None``."""
    net = spec.load_backbone(backbone)
    x = stem(p, net, patches.permute(0, 3, 1, 2), chunk)
    for blk in net.blocks:
        x = block(p, blk, x, chunk)
    return x.to(torch.float64).mean(dim=(2, 3)).to(patches.dtype)


def head_samples(p: dict, H: torch.Tensor, seed: int, T: int, feature_dropout: float,
                 attention_dropout: float, C: int):
    """T Monte Carlo head samples over ``H (n, L)``: logits ``(T, C)`` and
    attention ``(T, C, n)``.  Differentiable in ``p`` and ``H``."""
    n, L = H.shape
    dev, dt = H.device, H.dtype
    ys, atts = [], []
    for t in range(T):
        key = (seed + t) & philox.MASK32
        Hd = H
        if feature_dropout > 0:
            u = philox.uniforms(torch.tensor([key], device=dev), philox.FEATURE_DRAW, n * L)
            keep = u.view(n, L) >= torch.tensor(feature_dropout, dtype=torch.float32)
            Hd = H * (keep.to(dt) * (1.0 / (1.0 - feature_dropout)))
        logits = []
        for c in range(C):
            v = torch.tanh(Hd @ p[f"attention_V.{c}.0.weight"].to(dt).T
                           + p[f"attention_V.{c}.0.bias"].to(dt))
            g = torch.sigmoid(Hd @ p[f"attention_U.{c}.0.weight"].to(dt).T
                              + p[f"attention_U.{c}.0.bias"].to(dt))
            logits.append((v * g) @ p[f"attention_weights.{c}.weight"].to(dt)[0]
                          + p[f"attention_weights.{c}.bias"].to(dt)[0])
        lg = torch.stack(logits, 1)  # (n, C): element n * C + c of the draw
        if attention_dropout > 0:
            u = philox.uniforms(torch.tensor([key], device=dev), philox.ATTENTION_DRAW, n * C)
            keep = u.view(n, C) >= torch.tensor(attention_dropout, dtype=torch.float32)
            lg = lg * (keep.to(dt) * (1.0 / (1.0 - attention_dropout)))
        A = torch.softmax(lg.T, dim=1)  # (C, n)
        M = A @ Hd
        ys.append(torch.stack([(M[c] * p[f"classifiers.{c}.weight"].to(dt)[0]).sum()
                               for c in range(C)]))
        atts.append(A)
    return torch.stack(ys), torch.stack(atts)


def predictive_stats(Y: torch.Tensor) -> dict[str, torch.Tensor]:
    """The served summary of ``(T, C)`` logits: class probabilities by
    softmax; over T the mean of each class, and of P(class 1) the mean, the
    std (ddof 0), median, interquartile range (linear interpolation), min
    and max; the mean entropy (a 1e-10 floor in the log)."""
    probs = torch.softmax(Y.to(torch.float64), dim=-1)
    pp = probs[:, 1]
    q = torch.quantile(pp, torch.tensor([0.25, 0.5, 0.75], dtype=pp.dtype, device=pp.device))
    ent = -(probs * torch.log(probs + 1e-10)).sum(-1)
    return {
        "mean_probs": probs.mean(0), "mean": pp.mean(), "std": pp.std(correction=0),
        "median": q[1], "iqr": q[2] - q[0], "low": pp.min(), "high": pp.max(),
        "mean_entropy": ent.mean(),
    }


def attention_stats(A: torch.Tensor) -> dict[str, torch.Tensor]:
    """Mean and std (ddof 1) over T of ``(T, C, n)`` attention."""
    A = A.to(torch.float64)
    return {"mean": A.mean(0), "std": A.var(0, correction=1).sqrt()}
