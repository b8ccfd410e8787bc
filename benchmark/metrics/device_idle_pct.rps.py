"""device_idle_pct: the share of the traced window with no device
operation running, in %."""

from benchmark.readers import idle_pct as read  # noqa: F401
