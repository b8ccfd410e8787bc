"""int8 serving path: the post-training-quantized ResNet embedding.

Counterpart of ``montecarlo_gated_mil_tpu/ops/quantized.py``, with the same
scheme and the same numbers:

- **Weights**: per-output-channel symmetric int8, with the input tensor's
  per-channel activation scales folded in before quantization
  (``conv(a / s_in, q(w * s_in)) * s_w == conv(a, w)``), built once.
- **Activations**: static per-channel k-sigma scales.  Batch-statistics BN
  gives every normalized output exactly mean beta and std |gamma| over the
  bag's valid pixels, so ``beta + k |gamma|`` bounds the post-ReLU
  activation at build time, and quantizing is an elementwise epilogue.
  Padded patches cannot move the scales of valid ones.
- **Convolutions**: int8 x int8 -> int32, dequantized per output channel.
  The stem stays bf16 (``stem="bf16"``, a cuDNN conv on the card) unless
  ``stem="s2d_i8"`` asks for the int8 space-to-depth form.  The stem's
  max-pool runs on the normalized values before they are quantized
  (quantizing is monotone, so it commutes with max).
- **Raw conv outputs** are stored in bf16 (default), float8_e4m3fn or int8
  (``conv_store``; narrow stores only where Cout >= 128), and the BN
  statistics are taken from the tensor as stored, so the activation-scale
  guarantees hold for every store.
- BN statistics, normalization, residual adds, ReLU and the global average
  pool run in f32 with the float path's masked batch-statistics semantics.

On CUDA tensors every int8 conv is K6 and every BN epilogue K7/K8
(``ops/quant_kernels.py``); on CPU tensors their plain versions run.

The plan is a dict of tensors on the predictor's device, built once in f32
on the CPU from the port's backbone (or its state_dict) and then moved, so
the card and the CPU serve the same codes.  Conv weights are stored
``(Cout, kh, kw, Cin)`` int8, contiguous along the depth the kernel reads;
:func:`hwio` gives the JAX package's ``(kh, kw, Cin, Cout)`` view back.

Opt in with ``MCDOPredictor(..., quantized=True)`` or
``tpu.quantized_inference: true``; training and the default path stay f32.
"""

from __future__ import annotations

import math
from typing import Mapping

import torch
import torch.nn.functional as F

from montecarlo_gated_mil_tpu_torch.models.resnet import s2d_input, s2d_stem_kernel
from montecarlo_gated_mil_tpu_torch.ops.quant_kernels import (
    Residual,
    bn_relu_quant,
    bn_stats,
    qconv,
)

BN_EPS = 1e-5
# backbone -> (stage sizes, bottleneck?)
STAGES = {
    "r18": ((2, 2, 2, 2), False),
    "r34": ((3, 4, 6, 3), False),
    "r50": ((3, 4, 6, 3), True),
}
CONV_STORES = ("bf16", "f8", "i8")
STEMS = ("bf16", "s2d_i8")

# Exact per-channel bounds of ImageNet-normalized [0, 1] pixels,
# max(|(0 - mean) / std|, |(1 - mean) / std|): the s2d stem input's int8
# scale clips nothing for real pixel data.
IMAGENET_INPUT_BOUND = (2.249, 2.429, 2.640)


def quantize_kernel(w: torch.Tensor) -> dict:
    """``(kh, kw, cin, cout)`` float kernel -> int8 weights ``(cout, kh, kw,
    cin)`` and per-cout scales ``s`` (max |w| / 127, at least 1e-12 / 127)."""
    w = w.to(torch.float32)
    s = torch.clamp(w.abs().amax(dim=(0, 1, 2)), min=1e-12) / 127.0
    wi = torch.clamp(torch.round(w / s), -127, 127).to(torch.int8)
    return {"w": wi.permute(3, 0, 1, 2).contiguous(), "s": s}


def hwio(w: torch.Tensor) -> torch.Tensor:
    """The plan's ``(cout, kh, kw, cin)`` kernel as JAX's ``(kh, kw, cin,
    cout)``."""
    return w.permute(1, 2, 3, 0)


def _fold_quantize(w: torch.Tensor, s_in: torch.Tensor) -> dict:
    """Fold per-input-channel activation scales into an HWIO kernel, then
    quantize per output channel."""
    return quantize_kernel(w.to(torch.float32) * s_in[None, None, :, None])


def _relu_bound(bn: dict, k: float) -> torch.Tensor:
    """Static per-channel bound of relu(BN(x)): beta + k |gamma|."""
    return torch.clamp(bn["bias"] + k * bn["scale"].abs(), min=1e-3)


def _signed_bound(bn: dict, k: float) -> torch.Tensor:
    return torch.clamp(bn["bias"].abs() + k * bn["scale"].abs(), min=1e-3)


# Static moments of the raw conv outputs, for conv_store="i8": the BN
# guarantee gives each normalized activation its exact moments; they go
# through relu in closed form, then through a conv with the pixels taken as
# independent (``rho`` inflates the variance for their correlation).


def _relu_moments(mu: torch.Tensor, sigma: torch.Tensor):
    """E and Var of relu(X), X ~ N(mu, sigma^2), per channel."""
    sigma = torch.clamp(sigma, min=1e-12)
    a = mu / sigma
    cdf = torch.special.ndtr(a)
    pdf = torch.exp(-0.5 * a.square()) / math.sqrt(2.0 * math.pi)
    e1 = mu * cdf + sigma * pdf
    e2 = (mu.square() + sigma.square()) * cdf + mu * sigma * pdf
    return e1, torch.clamp(e2 - e1.square(), min=0.0)


def _bn_relu_moments(bn: dict):
    """Moments of relu(BN(x)), exact at build time through the BN affine."""
    return _relu_moments(bn["bias"], bn["scale"].abs())


def _conv_t_scale(w, mu_in, var_in, k: float, rho: float) -> torch.Tensor:
    """int8 storage scale of t = conv(a, w) from the input's channel moments."""
    w = w.to(torch.float32)
    mean_t = torch.einsum("hwio,i->o", w, mu_in)
    var_t = torch.einsum("hwio,i->o", w.square(), var_in)
    bound = mean_t.abs() + k * rho * var_t.sqrt()
    return torch.clamp(bound, min=1e-3) / 127.0


def _backbone_params(backbone) -> dict[str, torch.Tensor]:
    """f32 CPU copies of a ``ResNetFeatures``'s (or its state_dict's)
    tensors, under the port's names (``layer1.0.conv1.weight``...)."""
    sd = backbone.state_dict() if isinstance(backbone, torch.nn.Module) else backbone
    return {k: v.detach().to("cpu", torch.float32) for k, v in sd.items()}


def quantize_backbone_static(
    backbone: torch.nn.Module | Mapping[str, torch.Tensor],
    name: str = "r18",
    k: float = 6.0,
    *,
    conv_store: str = "bf16",
    rho: float = 2.0,
    stem: str = "bf16",
) -> dict:
    """Static-scale quantization plan of a backbone (JAX
    ``quantize_backbone_static``): folded int8 kernels, per-cout dequant
    scales ``s`` (and for ``conv_store="i8"`` the storage scales ``t`` and
    ``st = s / t``), the BN affines and every activation's int8 scale, on
    the backbone's device (a state_dict's plan stays on the CPU).
    """
    if name not in STAGES:
        raise ValueError(f"quantized path supports {sorted(STAGES)}, got {name!r}")
    if conv_store not in CONV_STORES:
        raise ValueError(f"conv_store must be bf16|f8|i8, got {conv_store!r}")
    if stem not in STEMS:
        raise ValueError(f"stem must be s2d_i8|bf16, got {stem!r}")
    is_module = isinstance(backbone, torch.nn.Module)
    device = next(iter(backbone.parameters())).device if is_module else torch.device("cpu")
    plan = _build_static_plan(_backbone_params(backbone), name, k, conv_store=conv_store,
                              rho=rho, stem=stem)
    return _to_device(plan, device)


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


def _build_static_plan(p: dict, name: str, k: float, *, conv_store: str, rho: float,
                       stem: str) -> dict:
    def conv(key):  # OIHW -> HWIO
        return p[key + ".weight"].permute(2, 3, 1, 0)

    def bn(key):
        return {"scale": p[key + ".weight"], "bias": p[key + ".bias"]}

    def qconv_plan(key, s_in, mu, var):
        q = _fold_quantize(conv(key), s_in)
        if conv_store == "i8":
            q["t"] = _conv_t_scale(conv(key), mu, var, k, rho)
            q["st"] = q["s"] / q["t"]
        return q

    stages, bottleneck = STAGES[name]
    out: dict = {
        "backbone": name,
        "conv_store": conv_store,
        "conv1": p["conv1.weight"].to(torch.bfloat16),  # OIHW, for the bf16 stem
        "bn1": bn("bn1"),
    }
    if stem == "s2d_i8":
        wk = s2d_stem_kernel(conv("conv1"))  # (4, 4, 12, 64)
        out["stem_in_scale"] = torch.tensor(IMAGENET_INPUT_BOUND, dtype=torch.float32).repeat(4) / 127.0
        out["conv1_q"] = _fold_quantize(wk, out["stem_in_scale"])
    b = _relu_bound(out["bn1"], k)  # bound of the pooled stem activation
    # Input moments for conv_store="i8": the stem output is relu(BN)-distributed;
    # the max-pool raises the mean, by about one std.
    mu_in, var_in = _bn_relu_moments(out["bn1"])
    mu_in = mu_in + var_in.sqrt()
    for stage, blocks in enumerate(stages, start=1):
        for blk_i in range(blocks):
            pre = f"layer{stage}.{blk_i}."
            q: dict = {"in_scale": b / 127.0}
            q["conv1"] = qconv_plan(pre + "conv1", q["in_scale"], mu_in, var_in)
            q["bn1"] = bn(pre + "bn1")
            q["mid_scale"] = _relu_bound(q["bn1"], k) / 127.0
            mu_mid, var_mid = _bn_relu_moments(q["bn1"])
            q["conv2"] = qconv_plan(pre + "conv2", q["mid_scale"], mu_mid, var_mid)
            q["bn2"] = bn(pre + "bn2")
            if bottleneck:  # 1x1 -> 3x3 -> 1x1
                q["mid2_scale"] = _relu_bound(q["bn2"], k) / 127.0
                mu_mid2, var_mid2 = _bn_relu_moments(q["bn2"])
                q["conv3"] = qconv_plan(pre + "conv3", q["mid2_scale"], mu_mid2, var_mid2)
                q["bn3"] = bn(pre + "bn3")
                final_bn = q["bn3"]
            else:
                final_bn = q["bn2"]
            if pre + "downsample.0.weight" in p:
                q["downsample_conv"] = qconv_plan(pre + "downsample.0", q["in_scale"], mu_in, var_in)
                q["downsample_bn"] = bn(pre + "downsample.1")
                id_bound = _signed_bound(q["downsample_bn"], k)
                mu_id = q["downsample_bn"]["bias"]
                var_id = q["downsample_bn"]["scale"].square()
            else:
                id_bound = b
                mu_id, var_id = mu_in, var_in
            # relu(norm(t_final) + identity): the bound is the sum of bounds.
            b = _signed_bound(final_bn, k) + id_bound
            q["out_scale"] = b / 127.0
            # The next block's input moments, by a Gaussian-sum approximation.
            mu_in, var_in = _relu_moments(
                final_bn["bias"] + mu_id, (final_bn["scale"].square() + var_id).sqrt()
            )
            out[f"layer{stage}_{blk_i}"] = q
    return out


def _store_for(qw: dict, store: str) -> str:
    """Narrow (1-byte) stores only where Cout >= 128, as in the JAX package."""
    return store if store != "bf16" and qw["w"].shape[0] >= 128 else "bf16"


def _qconv_stored(ai, qw: dict, stride: int, pad: int, store: str):
    """int8 conv whose raw output is stored in ``store``'s dtype.  Returns
    the stored tensor and its ``tq`` (the int8 store's read-back scale)."""
    store = _store_for(qw, store)
    scale = qw["st"] if store == "i8" else qw["s"]
    t = qconv(ai, qw["w"], scale, stride, (pad,) * 4, store)
    return t, (qw["t"] if store == "i8" else None)


def _bn_affine(t, tq, bn: dict, m: torch.Tensor):
    """Masked batch statistics of the stored ``t`` -> the effective f32
    ``(scale, shift)`` of its BN.

    The masked reduction, the variance and ``rsqrt`` run in float64 and
    round once to f32, so the card (cuBLAS, an approximate ``rsqrtf``) and
    the CPU give the same affine, and so the same codes; the affine itself
    is f32, in the JAX package's order."""
    s_p, sq_p = bn_stats(t, tq)
    m64 = m.to(torch.float64)
    n_valid = m64.sum()
    count = torch.clamp(n_valid * (t.shape[1] * t.shape[2]), min=1.0)
    mean = (m64 @ s_p.to(torch.float64)) / count
    var = (m64 @ sq_p.to(torch.float64)) / count - mean.square()
    inv = torch.rsqrt(var + BN_EPS).to(torch.float32)
    mean, one = mean.to(torch.float32), torch.clamp(n_valid, max=1.0).to(torch.float32)
    se = bn["scale"] * inv * one
    be = bn["bias"] - mean * bn["scale"] * inv * one
    return se, be


def _stem(plan: dict, patches: torch.Tensor) -> torch.Tensor:
    """The stem conv's raw output, NHWC bf16."""
    if "conv1_q" in plan and patches.shape[1] % 2 == 0 and patches.shape[2] % 2 == 0:
        # s2d int8 stem: quantize the space-to-depth input with the static
        # ImageNet bound, then the exact 4x4-s1 form of the 7x7-s2 conv.
        x2 = s2d_input(patches.to(torch.float32))
        ai = torch.clamp(torch.round(x2 / plan["stem_in_scale"]), -127, 127).to(torch.int8)
        q = plan["conv1_q"]
        return qconv(ai, q["w"], q["s"], 1, (2, 1, 2, 1), "bf16")
    x = patches.to(torch.bfloat16).permute(0, 3, 1, 2)  # NHWC storage, NCHW view
    t = F.conv2d(x, plan["conv1"], stride=2, padding=3)
    return t.permute(0, 2, 3, 1).contiguous()


def _stem_quant(plan: dict, patches: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """The stem, its BN, ReLU and 3x3/2 max-pool, quantized to layer 1's
    int8 input.  Pool first on the normalized values, then quantize; the
    requantize reciprocal folds into the affine (positive per-channel
    scaling commutes with relu and max).  The full-resolution conv output
    lives only inside this call."""
    t = _stem(plan, patches)
    se, be = _bn_affine(t, None, plan["bn1"], m)
    b1 = plan["layer1_0"]["in_scale"]
    return bn_relu_quant(t, None, se / b1, be / b1, mode="pool_i8")


def _norm_relu_quant(t, tq, bn: dict, scale, m):
    se, be = _bn_affine(t, tq, bn, m)
    return bn_relu_quant(t, tq, se / scale, be / scale)


def _block(q: dict, x_q, x_scale, m, *, stride: int, store: str, bottleneck: bool,
           last: bool) -> torch.Tensor:
    """One residual block on int8 input ``x_q`` (dequant scale ``x_scale``):
    the next block's int8 input, or for the last block the f32 mean-pooled
    features.  Its stored conv outputs live only inside this call."""
    if bottleneck:
        t1, tq1 = _qconv_stored(x_q, q["conv1"], 1, 0, store)  # 1x1
        m1 = _norm_relu_quant(t1, tq1, q["bn1"], q["mid_scale"], m)
        t2, tq2 = _qconv_stored(m1, q["conv2"], stride, 1, store)  # 3x3
        m2 = _norm_relu_quant(t2, tq2, q["bn2"], q["mid2_scale"], m)
        tf, tqf = _qconv_stored(m2, q["conv3"], 1, 0, store)  # 1x1
        sef, bef = _bn_affine(tf, tqf, q["bn3"], m)
    else:
        t1, tq1 = _qconv_stored(x_q, q["conv1"], stride, 1, store)
        m1 = _norm_relu_quant(t1, tq1, q["bn1"], q["mid_scale"], m)
        tf, tqf = _qconv_stored(m1, q["conv2"], 1, 1, store)
        sef, bef = _bn_affine(tf, tqf, q["bn2"], m)
    # The requantize reciprocal folds into every affine feeding the residual
    # sum; the last block returns unscaled features.
    inv = 1.0 if last else 1.0 / q["out_scale"]
    if "downsample_conv" in q:
        d, dtq = _qconv_stored(x_q, q["downsample_conv"], stride, 0, store)
        sed, bed = _bn_affine(d, dtq, q["downsample_bn"], m)
        residual = Residual(d, dtq, sed * inv, bed * inv)
    else:
        residual = Residual(x_q, None, x_scale * inv, None)
    return bn_relu_quant(tf, tqf, sef * inv, bef * inv, residual, mode="mean" if last else "i8")


def quantized_embed_static(
    plan: dict,
    patches: torch.Tensor,
    mask: torch.Tensor | None = None,
    *,
    backbone: str = "r18",
) -> torch.Tensor:
    """int8 embed with static activation scales: patches ``(N, h, w, 3)`` ->
    f32 features ``(N, L)``.  Per conv: the int8 activation read, the stored
    raw output written, one read of it for the statistics (K7) and one for
    the normalize + requantize epilogue (K8), the int8 activation written."""
    if mask is None:
        mask = torch.ones(patches.shape[0], dtype=torch.bool, device=patches.device)
    m = mask.to(torch.float32)
    x_q = _stem_quant(plan, patches, m)
    x_scale = plan["layer1_0"]["in_scale"]  # dequant scale of x_q
    stages, bottleneck = STAGES[backbone]
    for stage, blocks in enumerate(stages, start=1):
        for blk_i in range(blocks):
            q = plan[f"layer{stage}_{blk_i}"]
            last = stage == len(stages) and blk_i == blocks - 1
            x_q = _block(q, x_q, x_scale, m, stride=2 if stage > 1 and blk_i == 0 else 1,
                         store=plan["conv_store"], bottleneck=bottleneck, last=last)
            x_scale = q["out_scale"]
    return x_q  # the last block's f32 features
