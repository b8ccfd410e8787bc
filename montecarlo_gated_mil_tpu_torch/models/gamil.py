"""Multi-head gated-attention MIL, the flagship model.

Counterpart of ``montecarlo_gated_mil_tpu/models/gamil.py``: one gated
attention head and one bias-free linear classifier per class, shared or
per-class V/U gates, attention dropout on the pre-softmax logits.  The
module names follow the reference's state_dict schema
(``attention_V.{i}.0``, ``attention_weights.{i}``, ``classifiers.{i}``), so
``models/port.py::port_multihead_gamil`` of the JAX package reads the port's
state_dict unchanged.

``embed`` (the ResNet, expensive) and ``head`` (gate, masked softmax,
pooling, classifiers) are separate so Monte Carlo dropout runs T head
samples over one feature pass (``mcdo/sampling.py``).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from montecarlo_gated_mil_tpu_torch.models.resnet import feature_dim, make_backbone


class MultiHeadGatedAttentionMIL(nn.Module):
    """Per-class gated-attention MIL with MC-dropout support.

    Linear layers keep torch's default init, uniform in
    ``±1/sqrt(fan_in)`` for weights and biases, which is the init the JAX
    package reproduces (``gamil.py::_torch_linear_init``).
    """

    def __init__(
        self,
        num_classes: int = 2,
        backbone: str = "r18",
        D: int = 128,
        feature_dropout: float = 0.1,
        attention_dropout: float = 0.1,
        shared_attention: bool = True,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.num_classes = num_classes
        self.backbone = backbone
        self.D = D
        self.feature_dropout = feature_dropout
        self.attention_dropout = attention_dropout
        self.shared_attention = shared_attention
        self.dtype = dtype
        L = feature_dim(backbone)
        self.L = L
        self.feature_extractor = make_backbone(backbone, dtype=dtype)

        def gate(act):
            return nn.Sequential(nn.Linear(L, D), act())

        if shared_attention:
            self.attention_V = gate(nn.Tanh)
            self.attention_U = gate(nn.Sigmoid)
        else:
            self.attention_V = nn.ModuleList([gate(nn.Tanh) for _ in range(num_classes)])
            self.attention_U = nn.ModuleList([gate(nn.Sigmoid) for _ in range(num_classes)])
        self.attention_weights = nn.ModuleList([nn.Linear(D, 1) for _ in range(num_classes)])
        self.classifiers = nn.ModuleList(
            [nn.Linear(L, 1, bias=False) for _ in range(num_classes)]
        )

    def embed(self, patches: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        """Patch bag ``(N, h, w, 3)`` -> features ``(N, L)``."""
        return self.feature_extractor(patches, mask)

    def head(
        self, H: torch.Tensor, mask: torch.Tensor | None = None
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Deterministic head: features ``(N, L)`` -> logits ``(C,)`` and
        attention ``(C, N)``.  Monte Carlo samples go through
        ``mcdo/sampling.py::mc_head``."""
        from montecarlo_gated_mil_tpu_torch.ops.gated_attention import (
            GatedAttentionParams,
            mc_head_reference,
        )

        if mask is None:
            mask = torch.ones(H.shape[0], dtype=torch.bool, device=H.device)
        y, a = mc_head_reference(H, mask, GatedAttentionParams.from_module(self), 1, 0, 0.0, 0.0)
        return y[0], a[0]

    def forward(
        self, patches: torch.Tensor, mask: torch.Tensor | None = None
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Deterministic forward of one bag: ``(Y (C,), A (C, N))``."""
        return self.head(self.embed(patches, mask), mask)
