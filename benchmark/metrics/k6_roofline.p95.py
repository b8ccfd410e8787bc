"""k6_roofline: K6's share of its roofline over the window's int8
convolutions, in %."""

from benchmark.readers import k6_roofline as read  # noqa: F401
