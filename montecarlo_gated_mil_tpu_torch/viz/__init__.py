"""Attention-map reconstruction (counterpart of ``montecarlo_gated_mil_tpu/viz``;
the figure and inference modules are not ported yet, ROADMAP.md)."""

from montecarlo_gated_mil_tpu_torch.viz.attention import (
    attention_map_stats,
    membership_matrices,
    reconstruct_attention_maps,
    reconstruct_image_from_patches,
)

__all__ = [
    "attention_map_stats",
    "membership_matrices",
    "reconstruct_attention_maps",
    "reconstruct_image_from_patches",
]
