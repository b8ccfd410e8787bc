"""Port of ``montecarlo_gated_mil_tpu.utils``."""

from montecarlo_gated_mil_tpu_torch.utils.profiling import (  # noqa: F401
    PhaseTimer,
    annotate,
    slope_time,
    trace,
)
