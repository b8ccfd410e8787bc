"""Monte Carlo dropout inference: T head samples over one feature pass.

Counterpart of ``montecarlo_gated_mil_tpu/mcdo/sampling.py``.  Features are
computed once, by the float backbone or the int8 embed (``make_embed_fn``);
the T stochastic head passes run in the MC-head kernel
(``ops/gated_attention.py``) on the card, or its plain version on the CPU.
The uncertainty reductions are plain tensor ops on the device.

- ``mc_inference``: all T samples of the multi-head model in one kernel
  launch;
- ``mc_inference_serial``: the same samples one launch each (T=1, seed
  ``seed + t``), so one sample's intermediates are live at a time; on the
  CPU it equals ``mc_inference`` bit for bit;
- ``mc_inference_single_head``: the single-head ``GatedAttentionMIL``, its
  plain head one sample at a time, with the sigmoid applied inside.

With ``targets`` the multi-head paths also return the per-sample auxiliary
losses, scaled by ``aux_scale`` (a model with other than 2 class heads
raises ``ValueError``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from montecarlo_gated_mil_tpu_torch.models.gamil import auxiliary_loss
from montecarlo_gated_mil_tpu_torch.ops.gated_attention import (
    GatedAttentionParams,
    mc_gated_attention,
)


@dataclass(frozen=True)
class MCOutputs:
    """Raw Monte Carlo outputs for one bag.

    predictions: ``(T, C)`` raw logits (probabilities on the single-head
    path).
    attention: ``(T, C, N)`` post-softmax attention (zero on padded slots).
    aux_losses: ``(T,)`` scaled auxiliary losses, or None without targets.
    """

    predictions: torch.Tensor
    attention: torch.Tensor
    aux_losses: torch.Tensor | None = None


def make_embed_fn(model, quantized: bool = False):
    """Feature extractor shared by the evaluation and serving paths:
    ``embed(patches, mask) -> (N, L)`` f32 features, from the model's float
    backbone or, with ``quantized``, the int8 PTQ embed
    (``ops/quantized.py``), whose plan is built here, once, on the model's
    device."""
    if not quantized:
        return model.embed
    from montecarlo_gated_mil_tpu_torch.ops.quantized import (
        quantize_backbone_static,
        quantized_embed_static,
    )

    plan = quantize_backbone_static(model.feature_extractor, model.backbone)

    def embed(patches, mask):
        return quantized_embed_static(plan, patches, mask, backbone=model.backbone)

    embed.plan = plan
    return embed


def mc_head(
    model,
    H: torch.Tensor,
    mask: torch.Tensor | None,
    num_samples: int,
    seed: int,
    params: GatedAttentionParams | None = None,
    targets=None,
    *,
    kernel: bool = True,
) -> MCOutputs:
    """T stochastic head passes over precomputed features ``H (N, L)``;
    sample t is seeded with ``seed + t``.  ``params`` may carry the head's
    weights already in kernel layout (a predictor converts them once).
    ``kernel=False`` runs the plain head on the card as well
    (``ops/gated_attention.py::mc_gated_attention``)."""
    if mask is None:
        mask = torch.ones(H.shape[0], dtype=torch.bool, device=H.device)
    if params is None:
        params = GatedAttentionParams.from_module(model)
    Y, A = mc_gated_attention(
        H, mask, params, num_samples, seed,
        model.feature_dropout, model.attention_dropout, kernel=kernel,
    )
    return MCOutputs(predictions=Y, attention=A, aux_losses=_aux_losses(model, A, targets))


def mc_head_serial(
    model,
    H: torch.Tensor,
    mask: torch.Tensor | None,
    num_samples: int,
    seed: int,
    params: GatedAttentionParams | None = None,
    targets=None,
    *,
    kernel: bool = True,
) -> MCOutputs:
    """:func:`mc_head` one sample at a time: sample t is one head launch at
    T=1 seeded with ``seed + t``, the seed sample t of :func:`mc_head` has."""
    if params is None:
        params = GatedAttentionParams.from_module(model)
    outs = [mc_head(model, H, mask, 1, seed + t, params, kernel=kernel)
            for t in range(num_samples)]
    A = torch.cat([o.attention for o in outs])
    return MCOutputs(
        predictions=torch.cat([o.predictions for o in outs]), attention=A,
        aux_losses=_aux_losses(model, A, targets),
    )


def _aux_losses(model, A: torch.Tensor, targets) -> torch.Tensor | None:
    """Per-sample scaled auxiliary losses of ``A (T, C, N)``: the positive
    head (class 1) against the negative head (class 0).  On a model with any
    other head count that contrast means nothing, so targets raise."""
    if targets is None:
        return None
    if A.shape[-2] != 2:
        raise ValueError(
            "aux loss (targets=...) requires exactly 2 class heads "
            f"(pos/neg attention contrast); model produced {A.shape[-2]}"
        )
    targets = torch.as_tensor(targets, device=A.device)
    return model.aux_scale * auxiliary_loss(
        A[:, 1, :], A[:, 0, :], targets == 1,
        loss_type=model.aux_loss_type, margin=model.aux_margin,
    )


def _on_device(model, patches, mask, device):
    """``patches`` and ``mask`` as tensors on ``device``, where ``model``
    must already live."""
    device = torch.device(device)
    model_device = next(model.parameters()).device
    if model_device.type != device.type:
        raise ValueError(f"model is on {model_device}, inference asked for {device}")
    patches = torch.as_tensor(patches, device=device)
    return patches, None if mask is None else torch.as_tensor(mask, device=device)


def mc_inference(
    model,
    patches,
    mask,
    num_samples: int,
    seed: int,
    targets=None,
    *,
    quantized: bool = False,
    device: str | torch.device = "cuda",
) -> MCOutputs:
    """Features once (the int8 embed with ``quantized``), then T head
    samples.  ``patches``: one bag ``(N, h, w, 3)``; ``model`` must already
    live on ``device``."""
    patches, mask = _on_device(model, patches, mask, device)
    embed = make_embed_fn(model, quantized)
    with torch.inference_mode():
        H = embed(patches, mask)
        return mc_head(model, H, mask, num_samples, seed, targets=targets)


def mc_inference_serial(
    model,
    patches,
    mask,
    num_samples: int,
    seed: int,
    targets=None,
    *,
    device: str | torch.device = "cuda",
) -> MCOutputs:
    """:func:`mc_inference` with the T samples one after another
    (:func:`mc_head_serial`): features once, then T launches of the head
    kernel at T=1, so only one sample's intermediates are live at a time
    (JAX's ``lax.scan`` form; the reference's Python loop)."""
    patches, mask = _on_device(model, patches, mask, device)
    with torch.inference_mode():
        H = model.embed(patches, mask)
        return mc_head_serial(model, H, mask, num_samples, seed, targets=targets)


def mc_inference_single_head(
    model,
    patches,
    mask,
    num_samples: int,
    seed: int,
    *,
    device: str | torch.device = "cuda",
) -> MCOutputs:
    """Single-head ``GatedAttentionMIL`` MC inference with the reference's
    contract: features once, then T stochastic passes of the head, one
    sample's intermediates at a time, with the **sigmoid applied inside**,
    so ``predictions (T, num_classes)`` are probabilities; ``attention`` is
    ``(T, K, N)``.  Sample t draws its masks from seed ``seed + t``.  There
    is no auxiliary loss on this model: ``aux_losses`` is None."""
    patches, mask = _on_device(model, patches, mask, device)
    with torch.inference_mode():
        H = model.embed(patches, mask)
        ys, attns = [], []
        for t in range(num_samples):
            y, a = model.head(H, mask, mc_dropout=True, seed=seed + t)
            ys.append(torch.sigmoid(y))
            attns.append(a)
        return MCOutputs(predictions=torch.stack(ys), attention=torch.stack(attns))


@dataclass(frozen=True)
class PredictiveStats:
    """Per-bag predictive-uncertainty summary over T MC samples (std is
    ddof=0, entropy has a 1e-10 floor, prediction = argmax of the MC-mean
    probabilities)."""

    mean_probs: torch.Tensor  # (C,)
    prediction: torch.Tensor  # ()
    mean: torch.Tensor  # () mean P(positive)
    std: torch.Tensor  # () std (ddof=0) of P(positive)
    median: torch.Tensor  # ()
    iqr: torch.Tensor  # () 75th - 25th percentile
    low: torch.Tensor  # () min
    high: torch.Tensor  # () max
    mean_entropy: torch.Tensor  # () mean over T of -sum_c p_c log p_c


def predictive_stats(predictions: torch.Tensor, positive_class: int = 1) -> PredictiveStats:
    """Reduce ``(T, C)`` MC logits to uncertainty stats.

    ``torch.quantile`` interpolates linearly like ``jnp.percentile`` and,
    at q=0.5, averages the two middle values at even T like ``jnp.median``
    (``torch.median`` would return the lower one).
    """
    probs = torch.softmax(predictions, dim=-1)
    p = probs[..., positive_class]
    q = torch.quantile(p, torch.tensor([0.25, 0.5, 0.75], dtype=p.dtype, device=p.device))
    entropy = -(probs * torch.log(probs + 1e-10)).sum(-1)
    mean_probs = probs.mean(0)
    return PredictiveStats(
        mean_probs=mean_probs,
        prediction=torch.argmax(mean_probs, dim=-1),
        mean=p.mean(),
        std=p.std(correction=0),
        median=q[1],
        iqr=q[2] - q[0],
        low=p.min(),
        high=p.max(),
        mean_entropy=entropy.mean(),
    )


def interpret_entropy(mean_entropy: float) -> str:
    """Verbal uncertainty bucket (reference ``infer.py:58-66``)."""
    h = float(mean_entropy)
    if h < 0.2:
        return "very low"
    if h < 0.4:
        return "low"
    if h < 0.6:
        return "moderate"
    return "high"


@dataclass(frozen=True)
class AttentionStats:
    """Mean and spread of attention over T samples (``std`` is ddof=1)."""

    mean: torch.Tensor  # (C, N)
    std: torch.Tensor  # (C, N)
    var: torch.Tensor  # (C, N)


def attention_stats(attention: torch.Tensor, mask: torch.Tensor | None = None) -> AttentionStats:
    """Reduce ``(T, C, N)`` attention over the sample axis; padded slots
    are re-zeroed through ``mask``."""
    mean = attention.mean(0)
    var = attention.var(0, correction=1) if attention.shape[0] > 1 else torch.zeros_like(mean)
    if mask is not None:
        zero = torch.zeros((), dtype=mean.dtype, device=mean.device)
        mean = torch.where(mask, mean, zero)
        var = torch.where(mask, var, zero)
    return AttentionStats(mean=mean, std=var.sqrt(), var=var)
