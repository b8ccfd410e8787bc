"""upload_ms.rps: mean ms a request of the image's upload (``serve.upload``)."""

from benchmark.program_spans import request_ms


def read(ctx):
    return request_ms(ctx, "serve.upload")
