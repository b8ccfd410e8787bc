"""Attention maps, the uncertainty figure and figure inference (counterpart
of ``montecarlo_gated_mil_tpu/viz``; ``viz.infer`` is imported on its own)."""

from montecarlo_gated_mil_tpu_torch.viz.attention import (
    attention_map_stats,
    membership_matrices,
    reconstruct_attention_maps,
    reconstruct_image_from_patches,
)
from montecarlo_gated_mil_tpu_torch.viz.figures import plot_attention_and_density

__all__ = [
    "attention_map_stats",
    "membership_matrices",
    "plot_attention_and_density",
    "reconstruct_attention_maps",
    "reconstruct_image_from_patches",
]
