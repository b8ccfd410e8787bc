"""train_mfu_pct: the least time of the window's training steps over the
window."""

from benchmark.readers import train_mfu_pct as read  # noqa: F401
