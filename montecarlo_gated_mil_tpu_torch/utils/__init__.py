"""Port of ``montecarlo_gated_mil_tpu.utils``."""
