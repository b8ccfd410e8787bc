"""Masked reductions: the primitives that make padded buckets exact.

Counterpart of ``montecarlo_gated_mil_tpu/ops/masked.py``.  Padded slots get
exactly-zero attention and contribute nothing to means or variances, so
results on the valid prefix match the ragged math.
"""

from __future__ import annotations

import torch

# Large-negative fill for masked logits: exp(x - max) == 0.0 in float32 for
# any realistic valid logit while staying finite (a true -inf gives NaN when
# an all-masked row is normalized).
MASK_FILL = -1e30


def masked_softmax(logits: torch.Tensor, mask: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Numerically stable softmax that assigns exactly 0 to masked slots.

    ``mask`` broadcasts against ``logits``; True = valid.  An all-masked row
    returns zeros rather than NaN.
    """
    mask = torch.broadcast_to(mask.bool(), logits.shape)
    filled = torch.where(mask, logits, torch.full_like(logits, MASK_FILL))
    m = filled.amax(dim=dim, keepdim=True)
    m = torch.where(m <= MASK_FILL, torch.zeros_like(m), m)
    e = torch.where(mask, torch.exp(filled - m), torch.zeros_like(filled))
    denom = e.sum(dim=dim, keepdim=True)
    safe = torch.where(denom > 0, denom, torch.ones_like(denom))
    return torch.where(denom > 0, e / safe, torch.zeros_like(e))


def _sum(x: torch.Tensor, dim, keepdim: bool) -> torch.Tensor:
    return x.sum() if dim is None and not keepdim else x.sum(
        dim=tuple(range(x.ndim)) if dim is None else dim, keepdim=keepdim
    )


def masked_mean(x: torch.Tensor, mask: torch.Tensor, dim=None, keepdim: bool = False):
    """Mean over valid slots only."""
    m = torch.broadcast_to(mask, x.shape).to(x.dtype)
    total = _sum(x * m, dim, keepdim)
    count = _sum(m, dim, keepdim)
    return total / torch.clamp(count, min=1.0)


def masked_var(x: torch.Tensor, mask: torch.Tensor, dim=None, keepdim: bool = False):
    """Biased (1/n) variance over valid slots, matching torch BN semantics."""
    m = torch.broadcast_to(mask, x.shape).to(x.dtype)
    mean = masked_mean(x, mask, dim=dim, keepdim=True)
    sq = (x - mean) ** 2 * m
    count = _sum(m, dim, keepdim)
    return _sum(sq, dim, keepdim) / torch.clamp(count, min=1.0)
