"""Loss criteria: cross-entropy and BCE with reference semantics.

Counterpart of ``montecarlo_gated_mil_tpu/train/criteria.py``
(reference ``main.py:65-70``): 'ce' is ``CrossEntropyLoss`` on raw
(bs, C) logits against integer targets; 'bce' is ``BCELoss`` on sigmoid
outputs.
"""

from __future__ import annotations

import torch


def cross_entropy(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Softmax CE over the last axis, mean over any batch axes; ``target``
    holds integer class indices."""
    logp = torch.log_softmax(logits, dim=-1)
    picked = torch.gather(logp, -1, target[..., None].to(torch.int64))
    return -torch.mean(picked)


def bce_on_probs(probs: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """BCE on already-sigmoided probabilities, the log clamped as the JAX
    package clamps it (probabilities in ``[1e-12, 1 - 1e-12]``)."""
    p = torch.clamp(probs, 1e-12, 1.0 - 1e-12)
    t = target.to(p.dtype)
    return -torch.mean(t * torch.log(p) + (1.0 - t) * torch.log(1.0 - p))


def make_criterion(name: str):
    name = name.lower()
    if name == "ce":
        return cross_entropy
    if name == "bce":
        return lambda logits, target: bce_on_probs(torch.sigmoid(logits), target)
    raise ValueError(f"criterion must be 'ce' or 'bce', got {name!r}")
