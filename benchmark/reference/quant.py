"""The int8 embed that ``r18-gamil-int8`` states, written out in plain PyTorch.

Post-training quantization with static scales, derived from the float
weights alone:

- the stem convolution runs in bf16 (bf16 inputs and weights, stored bf16);
- every other convolution takes int8 codes of its input and of its weights,
  accumulates exactly, and stores ``f32(acc) * s`` in bf16, where the
  weights are folded with the input's per-channel scale and quantized per
  output channel (``s = max|w| / Q``);
- a BN normalizes with the masked statistics of the stored tensor (sums in
  float64, the affine rounded once to float32); an activation after BN and
  ReLU is quantized with the static bound ``beta + 6 |gamma|`` (a residual
  sum with the sum of its parts' bounds ``|beta| + 6 |gamma|``), rounded
  half to even and clipped to +-Q;
- the stem's 3x3/2 max pool runs on the normalized values before rounding,
  and the last block returns the float mean over its pixels.

``Q = 127`` is int8; ``levels=7`` gives the int4 control of the same
scheme.  Integer sums run in float64 convolutions, exact for these codes.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference.model import blocks

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


def embed(p: dict, patches: torch.Tensor, levels: int = 127, backbone: str = "r18",
          chunk: int = 128) -> torch.Tensor:
    """``(n, 224, 224, 3)`` float32 valid tiles -> ``(n, L)`` float32."""
    fe = "feature_extractor."
    q = levels
    # Stem: bf16 conv, BN, ReLU, 3x3/2 max pool, quantize to layer 1's input.
    x = patches.to(torch.bfloat16).permute(0, 3, 1, 2)
    w1 = p[fe + "conv1.weight"].to(torch.bfloat16).to(torch.float32)
    t = torch.cat([F.conv2d(x[i:i + chunk].to(torch.float32), w1, stride=2, padding=3)
                   .to(torch.bfloat16) for i in range(0, x.shape[0], chunk)])
    del x
    se, be = _affine(t, p[fe + "bn1.weight"], p[fe + "bn1.bias"])
    bound = _relu_bound(p[fe + "bn1.weight"], p[fe + "bn1.bias"])  # of x, as s_x = bound / q
    s_x = bound / q
    parts = []
    for i in range(0, t.shape[0], chunk):
        y = torch.clamp(t[i:i + chunk].to(torch.float32) * _ch(se / s_x) + _ch(be / s_x), min=0.0)
        parts.append(_quantize(F.max_pool2d(y, 3, 2, 1), q).to(torch.int8))
    del t
    x = torch.cat(parts)
    all_blocks = blocks(backbone)
    for bi, (pre, cin, cout, stride) in enumerate(all_blocks):
        k = fe + pre
        last = bi == len(all_blocks) - 1
        w1q, s1 = _quant_weight(p[k + "conv1.weight"], s_x, q)
        t1 = (_int_conv(x, w1q, stride, 1, chunk).to(torch.float32) * _ch(s1)).to(torch.bfloat16)
        g1, b1 = p[k + "bn1.weight"], p[k + "bn1.bias"]
        se1, be1 = _affine(t1, g1, b1)
        s_mid = _relu_bound(g1, b1) / q
        m1 = _quantize(torch.clamp(t1.to(torch.float32) * _ch(se1 / s_mid) + _ch(be1 / s_mid),
                                   min=0.0), q).to(torch.int8)
        del t1
        w2q, s2 = _quant_weight(p[k + "conv2.weight"], s_mid, q)
        tf = (_int_conv(m1, w2q, 1, 1, chunk).to(torch.float32) * _ch(s2)).to(torch.bfloat16)
        del m1
        g2, b2 = p[k + "bn2.weight"], p[k + "bn2.bias"]
        sef, bef = _affine(tf, g2, b2)
        if k + "downsample.0.weight" in p:
            wdq, sd = _quant_weight(p[k + "downsample.0.weight"], s_x, q)
            d = (_int_conv(x, wdq, stride, 0, chunk).to(torch.float32) * _ch(sd)).to(torch.bfloat16)
            gd, bd = p[k + "downsample.1.weight"], p[k + "downsample.1.bias"]
            sed, bed = _affine(d, gd, bd)
            id_bound = _signed_bound(gd, bd)
        else:
            d, sed, bed, id_bound = None, None, None, bound
        out_bound = _signed_bound(g2, b2) + id_bound
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
