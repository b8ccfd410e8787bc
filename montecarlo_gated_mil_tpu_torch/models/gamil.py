"""Gated-attention MIL models: the multi-head flagship and the single-head model.

Counterpart of ``montecarlo_gated_mil_tpu/models/gamil.py``.

- ``MultiHeadGatedAttentionMIL``: one gated attention head and one
  bias-free linear classifier per class, shared or per-class V/U gates,
  attention dropout on the pre-softmax logits.  Module names
  ``attention_V.{i}.0``, ``attention_weights.{i}``, ``classifiers.{i}``, as
  ``models/port.py::port_multihead_gamil`` of the JAX package reads them.
- ``GatedAttentionMIL``: K attention heads over one gate, the pooled
  embeddings concatenated into one classifier, attention dropout inside the
  V/U branches.  Module names ``attention_V.0``, ``attention_U.0``,
  ``attention_weights``, ``classifier.0``, as ``port_singlehead_gamil``
  reads them.

``embed`` (the ResNet, expensive) and ``head`` (gate, masked softmax,
pooling, classifiers) are separate so Monte Carlo dropout runs T head
samples over one feature pass (``mcdo/sampling.py``).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from montecarlo_gated_mil_tpu_torch.models.resnet import feature_dim, make_backbone
from montecarlo_gated_mil_tpu_torch.ops.gated_attention import (
    FEATURE_DRAW,
    apply_dropout,
    dropout_uniforms,
)
from montecarlo_gated_mil_tpu_torch.ops.masked import masked_softmax

# Philox draw indices of the single-head model's attention dropouts; its
# feature dropout takes ``FEATURE_DRAW``, as the MC head kernels do.
V_DRAW, U_DRAW = 1, 2


def pairwise_distance(x: torch.Tensor, y: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Euclidean distance over the last axis with ``F.pairwise_distance``'s
    epsilon (added to the difference before the norm), written out as the
    JAX package's ``gamil.pairwise_distance``."""
    return torch.sqrt(torch.sum(torch.square(x - y + eps), dim=-1))


def cosine_similarity(x: torch.Tensor, y: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Cosine similarity over the last axis, each norm clamped at ``eps``."""
    nx = torch.clamp(torch.linalg.vector_norm(x, dim=-1), min=eps)
    ny = torch.clamp(torch.linalg.vector_norm(y, dim=-1), min=eps)
    return torch.sum(x * y, dim=-1) / (nx * ny)


def auxiliary_loss(
    pos_attention: torch.Tensor,
    neg_attention: torch.Tensor,
    is_positive: torch.Tensor,
    *,
    loss_type: str = "pairwise",
    margin: float = 1.0,
) -> torch.Tensor:
    """Attention-separation loss (JAX ``gamil.auxiliary_loss``).

    Pushes the positive and negative heads' attention ``(..., N)`` apart on
    positive bags and together on negative bags; ``is_positive (...)`` bool.
    Returns the unscaled per-bag loss; the caller applies ``aux_scale``.
    """
    if loss_type == "pairwise":
        d = pairwise_distance(pos_attention, neg_attention)
        pos_branch = torch.clamp(margin - d, min=0.0)
        neg_branch = d
    elif loss_type == "cosine":
        c = cosine_similarity(pos_attention, neg_attention)
        pos_branch = c
        neg_branch = 1.0 - c
    else:
        raise ValueError(f"Unknown auxiliary loss type: {loss_type!r}")
    return torch.where(is_positive, pos_branch, neg_branch)


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
        aux_loss_type: str = "pairwise",
        aux_margin: float = 1.0,
        aux_scale: float = 0.5,
        space_to_depth: bool = False,
    ):
        super().__init__()
        self.num_classes = num_classes
        self.backbone = backbone
        self.D = D
        self.feature_dropout = feature_dropout
        self.attention_dropout = attention_dropout
        self.shared_attention = shared_attention
        self.dtype = dtype
        self.aux_loss_type = aux_loss_type
        self.aux_margin = aux_margin
        self.aux_scale = aux_scale
        L = feature_dim(backbone)
        self.L = L
        self.space_to_depth = space_to_depth  # exact s2d stem (same weights)
        self.feature_extractor = make_backbone(
            backbone, dtype=dtype, space_to_depth=space_to_depth
        )

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
        self,
        H: torch.Tensor,
        mask: torch.Tensor | None = None,
        *,
        train: bool = False,
        mc_dropout: bool = False,
        seed: int = 0,
        kernel: bool = True,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Features ``(N, L)`` -> logits ``(C,)`` and attention ``(C, N)``.

        One sample of the MC head (``ops/gated_attention.py``): the kernel
        on a CUDA tensor, its plain version on the CPU or with
        ``kernel=False``.  ``train`` or ``mc_dropout`` turns dropout on,
        drawn from ``seed``; gradients flow to ``H`` and the head weights
        whenever autograd records.
        """
        from montecarlo_gated_mil_tpu_torch.ops.gated_attention import (
            GatedAttentionParams,
            mc_gated_attention,
        )

        if mask is None:
            mask = torch.ones(H.shape[0], dtype=torch.bool, device=H.device)
        stochastic = train or mc_dropout
        y, a = mc_gated_attention(
            H, mask, GatedAttentionParams.from_module(self, detach=False), 1, seed,
            self.feature_dropout if stochastic else 0.0,
            self.attention_dropout if stochastic else 0.0,
            kernel=kernel,
        )
        return y[0], a[0]

    def forward(
        self,
        patches: torch.Tensor,
        mask: torch.Tensor | None = None,
        targets: torch.Tensor | None = None,
        *,
        train: bool = False,
        seed: int = 0,
        kernel: bool = True,
    ):
        """Full forward of one bag.

        Returns ``(Y (C,), A (C, N))``, and with ``targets`` the auxiliary
        loss as a third element, already scaled by ``aux_scale`` as the JAX
        model's ``__call__`` returns it.  ``kernel`` as in :meth:`head`.
        """
        Y, A = self.head(self.embed(patches, mask), mask, train=train, seed=seed, kernel=kernel)
        if targets is None:
            return Y, A
        aux = self.aux_scale * auxiliary_loss(
            A[1], A[0], targets == 1, loss_type=self.aux_loss_type, margin=self.aux_margin
        )
        return Y, A, aux


class GatedAttentionMIL(nn.Module):
    """Single-head GA-MIL (JAX ``gamil.py::GatedAttentionMIL``).

    K attention heads over one tanh/sigmoid gate; the K pooled embeddings
    are concatenated into one linear classifier with bias.  Attention
    dropout acts *inside* the gate branches, after the tanh and after the
    sigmoid, unlike the multi-head model's pre-softmax logit dropout.  The
    head is plain PyTorch on every device (the JAX package computes it
    outside any Pallas kernel); its three dropout masks come from the port's
    Philox stream keyed on ``seed``, draws ``FEATURE_DRAW``, ``V_DRAW`` and
    ``U_DRAW``, in one call (``ops/gated_attention.py::dropout_uniforms``),
    so one seed draws the same masks on the CPU and on the card.  Linear
    layers keep torch's default init.
    """

    def __init__(
        self,
        num_classes: int = 1,
        backbone: str = "r18",
        D: int = 128,
        K: int = 1,
        feature_dropout: float = 0.1,
        attention_dropout: float = 0.1,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.num_classes = num_classes
        self.backbone = backbone
        self.D = D
        self.K = K
        self.feature_dropout = feature_dropout
        self.attention_dropout = attention_dropout
        self.dtype = dtype
        L = feature_dim(backbone)
        self.L = L
        self.feature_extractor = make_backbone(backbone, dtype=dtype)
        self.attention_V = nn.Sequential(nn.Linear(L, D), nn.Tanh())
        self.attention_U = nn.Sequential(nn.Linear(L, D), nn.Sigmoid())
        self.attention_weights = nn.Linear(D, K)
        self.classifier = nn.Sequential(nn.Linear(L * K, num_classes))

    def embed(self, patches: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        """Patch bag ``(N, h, w, 3)`` -> features ``(N, L)``."""
        return self.feature_extractor(patches, mask)

    def head(
        self,
        H: torch.Tensor,
        mask: torch.Tensor | None = None,
        *,
        train: bool = False,
        mc_dropout: bool = False,
        seed: int = 0,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Features ``(N, L)`` -> logits ``(num_classes,)`` and attention
        ``(K, N)``.  ``train`` or ``mc_dropout`` turns dropout on, drawn
        from ``seed``.  ``Hd`` is promoted to at least f32 (a bf16 embed is
        promoted, an f64 run stays f64)."""
        stochastic = train or mc_dropout
        p_f = self.feature_dropout if stochastic else 0.0
        p_a = self.attention_dropout if stochastic else 0.0
        N = H.shape[0]
        draws = [(FEATURE_DRAW, H.numel())] if p_f > 0 else []
        draws += [(V_DRAW, N * self.D), (U_DRAW, N * self.D)] if p_a > 0 else []
        u = dict(zip((d for d, _ in draws), dropout_uniforms(seed, draws, H.device)))
        Hd = apply_dropout(H, u[FEATURE_DRAW], p_f) if p_f > 0 else H
        Hd = Hd.to(torch.promote_types(Hd.dtype, torch.float32))
        V, U = self.attention_V(Hd), self.attention_U(Hd)
        if p_a > 0:
            V, U = apply_dropout(V, u[V_DRAW], p_a), apply_dropout(U, u[U_DRAW], p_a)
        logits = self.attention_weights(V * U).T  # (K, N)
        if mask is None:
            mask = torch.ones(N, dtype=torch.bool, device=H.device)
        A = masked_softmax(logits, mask[None, :])
        M = A @ Hd  # (K, L)
        return self.classifier(M.reshape(-1)), A

    def forward(
        self,
        patches: torch.Tensor,
        mask: torch.Tensor | None = None,
        *,
        train: bool = False,
        seed: int = 0,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Full forward of one bag: ``(Y (num_classes,), A (K, N))``."""
        return self.head(self.embed(patches, mask), mask, train=train, seed=seed)
