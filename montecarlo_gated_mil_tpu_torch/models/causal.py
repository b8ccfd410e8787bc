"""Causal counterfactual dropout (experimental model variant).

Counterpart of ``montecarlo_gated_mil_tpu/models/causal.py`` (reference
``model_dev.py:24-204``): at eval time, take the gradient of the summed
class logits with respect to the post-softmax attention, turn it into a
per-instance "importance" ``sigmoid(dY/dA)``, then draw T Bernoulli masks
that *drop* instances with probability equal to their importance, re-pool
and re-classify each counterfactual bag, and report the realized drop rates
per class head.

The logits are linear in the attention (``Y_c = sum_n A[c, n] (H w_c)_n``),
so the gradient is the closed form ``dY/dA[c, n] = (H w_c)_n``, computed
once and exactly: the JAX package takes it with ``jax.grad`` of the same
linear function.  The deterministic head runs through the MC head kernel
(K1, or K2 for a shared gate) at T=1 with dropout 0 on the card.  Keep-mask
t is ``u >= importance`` with ``u`` the port's Philox uniforms of key
``seed + t`` and draw ``COUNTERFACTUAL_DRAW``, so one seed gives the same
masks on the CPU and on the card.  Not wired into any entry point, as in
the JAX package and the reference.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from montecarlo_gated_mil_tpu_torch.mcdo.sampling import _on_device
from montecarlo_gated_mil_tpu_torch.ops.gated_attention import dropout_uniform

# The Philox draw index of the keep-masks, apart from the MC head's draws
# (0-2) under the same key.
COUNTERFACTUAL_DRAW = 3


@dataclass(frozen=True)
class CounterfactualOutputs:
    """counterfactual_predictions: (T, C); counterfactual_attention:
    (T, C, N); importance: (C, N); drop_rates: (C,) mean realized drop
    fraction per class head."""

    counterfactual_predictions: torch.Tensor
    counterfactual_attention: torch.Tensor
    importance: torch.Tensor
    drop_rates: torch.Tensor


def causal_counterfactual_dropout(
    model,
    patches,
    mask,
    num_samples: int,
    seed: int,
    *,
    device: str | torch.device = "cuda",
) -> CounterfactualOutputs:
    """Run the counterfactual-dropout eval forward of a
    ``MultiHeadGatedAttentionMIL`` on one bag: the deterministic forward
    gives H and A, then the counterfactuals perturb only the pooling stage.

    ``drop_rates`` divides each sample's dropped valid instances by the
    bucket size ``N``, not by the valid count, as the JAX package does, so
    on a padded bag the rate is the valid share times the drop fraction.
    """
    patches, mask = _on_device(model, patches, mask, device)
    with torch.inference_mode():
        H = model.embed(patches, mask)
        _, A = model.head(H, mask)  # (C, N) post-softmax, dropout off
        H32 = H.to(torch.promote_types(H.dtype, torch.float32))
        w_cls = torch.cat([c.weight for c in model.classifiers]).to(H32.dtype)  # (C, L)
        importance = torch.sigmoid((H32 @ w_cls.T).T)  # dY/dA, (C, N)
        valid = (torch.ones(A.shape[-1], device=A.device) if mask is None
                 else mask.to(A.dtype))
        C, N = A.shape
        ys, attns, rates = [], [], []
        for t in range(num_samples):
            u = dropout_uniform(seed + t, COUNTERFACTUAL_DRAW, C * N, A.device).view(C, N)
            keep = (u >= importance).to(A.dtype)  # drop with probability importance
            a_cf = A * keep
            ys.append(((a_cf @ H32) * w_cls).sum(-1))
            attns.append(a_cf)
            rates.append(((1 - keep) * valid).sum(-1) / N)
        return CounterfactualOutputs(
            counterfactual_predictions=torch.stack(ys),
            counterfactual_attention=torch.stack(attns),
            importance=importance,
            drop_rates=torch.stack(rates).mean(0),
        )
