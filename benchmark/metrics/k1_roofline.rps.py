"""k1_roofline: K1's share of its roofline over the window's requests, in %."""

from benchmark.readers import k1_roofline as read  # noqa: F401
