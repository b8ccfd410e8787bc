"""library_device_ms.rps: device ms per request outside the port's kernels."""

from benchmark.readers import library_device_ms


def read(ctx):
    return library_device_ms(ctx, sum(1 for r in ctx.requests if r.ok))
