"""Config -> model (counterpart of ``montecarlo_gated_mil_tpu/experiment.py``;
only ``build_model`` is ported so far)."""

from __future__ import annotations

import torch

from montecarlo_gated_mil_tpu_torch.core.config import Config
from montecarlo_gated_mil_tpu_torch.data.pipeline import torch_dtype
from montecarlo_gated_mil_tpu_torch.models.gamil import MultiHeadGatedAttentionMIL


def build_model(
    cfg: Config, num_classes: int = 2, *, seed: int | None = None
) -> MultiHeadGatedAttentionMIL:
    """Flagship MH-GA-MIL from config (reference ``main.py:56-61``).

    ``seed`` makes the random init reproducible without touching the
    caller's global RNG state.
    """

    def build():
        return MultiHeadGatedAttentionMIL(
            num_classes=num_classes,
            backbone=cfg.model,
            feature_dropout=cfg.feature_dropout,
            attention_dropout=cfg.attention_dropout,
            shared_attention=cfg.shared_att,
            dtype=torch_dtype(cfg.tpu.compute_dtype),
        )

    if seed is None:
        return build()
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return build()
