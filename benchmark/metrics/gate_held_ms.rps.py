"""gate_held_ms.rps: mean ms a request holds the execute gate
(``serve.execute``)."""

from benchmark.program_spans import request_ms


def read(ctx):
    return request_ms(ctx, "serve.execute")
