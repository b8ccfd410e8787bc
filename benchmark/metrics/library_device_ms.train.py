"""library_device_ms.train: device ms per training step outside the port's
kernels."""

from benchmark.readers import library_device_ms


def read(ctx):
    return library_device_ms(ctx, len(ctx.steps))
