"""The int8 embed that ``r18-gamil-int8`` states, written out in plain PyTorch
for any backbone of ``benchmark/backbones/``.

Post-training quantization with static scales, derived from the float
weights alone:

- the stem convolution runs in bf16 (bf16 inputs and weights, stored bf16);
- every other convolution takes int8 codes of its input and of its weights,
  accumulates exactly, and stores ``f32(acc) * s`` in bf16, where the
  weights are folded with the input's per-channel scale and quantized per
  output channel (``s = max|w| / Q``);
- a BN normalizes with the masked statistics of the stored tensor (sums in
  float64, the affine rounded once to float32); an activation after BN and
  ReLU (every conv of a block but its last) is quantized with the static
  bound ``beta + 6 |gamma|`` (a block's residual sum with the sum of its
  parts' bounds ``|beta| + 6 |gamma|``), rounded half to even and clipped
  to +-Q;
- the stem's 3x3/2 max pool runs on the normalized values before rounding,
  and the last block returns the float mean over its pixels.

``Q = 127`` is int8; ``levels=7`` gives the int4 control of the same
scheme.  Integer sums run in float64 convolutions, exact for these codes.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark import spec
from benchmark.reference.model import FE

K_SIGMA = 6.0
EPS = 1e-5


def _relu_bound(w, b):
    return torch.clamp(b + K_SIGMA * w.abs(), min=1e-3)


def _signed_bound(w, b):
    return torch.clamp(b.abs() + K_SIGMA * w.abs(), min=1e-3)


def _quant_weight(w_oihw: torch.Tensor, s_in: torch.Tensor, q: int):
    w = w_oihw.to(torch.float32) * s_in[None, :, None, None]
    s = torch.clamp(w.abs().amax(dim=(1, 2, 3)), min=1e-12) / q
    codes = torch.clamp(torch.round(w / s[:, None, None, None]), -q, q)
    return codes.to(torch.float64), s


def _int_conv(codes: torch.Tensor, wq: torch.Tensor, stride: int, pad: int, chunk: int):
    """Exact integer sums of a conv of NCHW codes (float64)."""
    out = [F.conv2d(codes[i:i + chunk].to(torch.float64), wq, stride=stride, padding=pad)
           for i in range(0, codes.shape[0], chunk)]
    return torch.cat(out)


def _affine(t: torch.Tensor, w, b, chunk: int = 128):
    """The BN's ``(scale, shift)`` from the statistics of stored ``t``
    (NCHW, every instance valid): per-instance sums in float64 rounded to
    float32, then summed over the bag in float64."""
    s1 = s2 = 0.0
    for i in range(0, t.shape[0], chunk):
        t64 = t[i:i + chunk].to(torch.float64)
        s1 = s1 + t64.sum(dim=(2, 3)).to(torch.float32).to(torch.float64).sum(0)
        s2 = s2 + t64.square().sum(dim=(2, 3)).to(torch.float32).to(torch.float64).sum(0)
        del t64
    count = t.shape[0] * t.shape[2] * t.shape[3]
    mean = s1 / count
    var = s2 / count - mean.square()
    inv = torch.rsqrt(var + EPS).to(torch.float32)
    mean = mean.to(torch.float32)
    return w * inv, b - mean * w * inv


def _ch(v):
    return v[None, :, None, None]


def _quantize(y: torch.Tensor, q: int) -> torch.Tensor:
    return torch.clamp(torch.round(y), -q, q)


def _gamma_beta(p: dict, c: spec.ConvBN):
    return p[FE + c.bn + ".weight"], p[FE + c.bn + ".bias"]


def _stored(p: dict, c: spec.ConvBN, codes: torch.Tensor, s_in: torch.Tensor, q: int,
            chunk: int) -> torch.Tensor:
    """A block's int8 convolution of ``codes`` (dequant scale ``s_in``),
    stored in bf16 as ``f32(acc) * s``."""
    wq, s = _quant_weight(p[FE + c.conv + ".weight"], s_in, q)
    acc = _int_conv(codes, wq, c.stride, c.pad, chunk)
    return (acc.to(torch.float32) * _ch(s)).to(torch.bfloat16)


def embed(p: dict, patches: torch.Tensor, levels: int = 127, backbone: str = "r18",
          chunk: int = 128) -> torch.Tensor:
    """``(n, 224, 224, 3)`` float32 valid tiles -> ``(n, L)`` float32."""
    q = levels
    net = spec.load_backbone(backbone)
    # Stem: bf16 conv, BN, ReLU, max pool, quantize to the first block's input.
    st = net.stem
    x = patches.to(torch.bfloat16).permute(0, 3, 1, 2)
    w1 = p[FE + st.conv + ".weight"].to(torch.bfloat16).to(torch.float32)
    t = torch.cat([F.conv2d(x[i:i + chunk].to(torch.float32), w1, stride=st.stride,
                            padding=st.pad).to(torch.bfloat16)
                   for i in range(0, x.shape[0], chunk)])
    del x
    g1, b1 = _gamma_beta(p, st)
    se, be = _affine(t, g1, b1)
    bound = _relu_bound(g1, b1)  # of x, as s_x = bound / q
    s_x = bound / q
    parts = []
    for i in range(0, t.shape[0], chunk):
        y = torch.clamp(t[i:i + chunk].to(torch.float32) * _ch(se / s_x) + _ch(be / s_x), min=0.0)
        parts.append(_quantize(F.max_pool2d(y, *net.pool), q).to(torch.int8))
    del t
    x = torch.cat(parts)
    for bi, blk in enumerate(net.blocks):
        last = bi == len(net.blocks) - 1
        # Every conv but the block's last: BN, ReLU, quantized at its own bound.
        h, s_h = x, s_x
        for c in blk.convs[:-1]:
            t = _stored(p, c, h, s_h, q, chunk)
            g, b = _gamma_beta(p, c)
            se, be = _affine(t, g, b)
            s_h = _relu_bound(g, b) / q
            h = _quantize(torch.clamp(t.to(torch.float32) * _ch(se / s_h) + _ch(be / s_h),
                                      min=0.0), q).to(torch.int8)
            del t
        tf = _stored(p, blk.convs[-1], h, s_h, q, chunk)
        del h
        gf, bf = _gamma_beta(p, blk.convs[-1])
        sef, bef = _affine(tf, gf, bf)
        if blk.downsample is not None:
            d = _stored(p, blk.downsample, x, s_x, q, chunk)
            gd, bd = _gamma_beta(p, blk.downsample)
            sed, bed = _affine(d, gd, bd)
            id_bound = _signed_bound(gd, bd)
        else:
            d, sed, bed, id_bound = None, None, None, bound
        out_bound = _signed_bound(gf, bf) + id_bound
        s_out = out_bound / q
        inv = 1.0 if last else 1.0 / s_out
        y = tf.to(torch.float32) * _ch(sef * inv) + _ch(bef * inv)
        if d is not None:
            y = y + (d.to(torch.float32) * _ch(sed * inv) + _ch(bed * inv))
        else:
            y = y + x.to(torch.float32) * _ch(s_x * inv)
        a = torch.clamp(y, min=0.0)
        if last:
            return a.to(torch.float64).mean(dim=(2, 3)).to(torch.float32)
        x = _quantize(a, q).to(torch.int8)
        bound, s_x = out_bound, s_out
    raise AssertionError("unreachable")
