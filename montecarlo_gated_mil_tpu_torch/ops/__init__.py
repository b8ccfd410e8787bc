"""Port of ``montecarlo_gated_mil_tpu.ops``."""

from montecarlo_gated_mil_tpu_torch.ops.masked import (  # noqa: F401
    masked_mean,
    masked_softmax,
    masked_var,
)
from montecarlo_gated_mil_tpu_torch.ops.patching import (  # noqa: F401
    TileGrid,
    compute_tile_grid,
    extract_bag_on_device,
    gather_selected,
    gather_tiles,
    select_tiles,
    tile_fill_scores,
    tile_fill_scores_sat,
)
