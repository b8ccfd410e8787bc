"""host_prep_ms.rps: mean ms a request of host prep (``serve.prep``: pixels,
the bucket's estimate, the route)."""

from benchmark.program_spans import request_ms


def read(ctx):
    return request_ms(ctx, "serve.prep")
