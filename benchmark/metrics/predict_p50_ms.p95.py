"""predict_p50_ms: the median wall time of a request from its own call."""

from benchmark.readers import predict_p50_ms as read  # noqa: F401
