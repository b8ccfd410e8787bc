"""serve_mfu_pct: the least time of the window's model work over the window."""

from benchmark.readers import serve_mfu_pct as read  # noqa: F401
