"""bucket_roundup_pct.rps: the share of requests whose estimate's band took
the larger bucket (``serve.bucket_rounded_up``), in %."""

from benchmark.program_spans import request_count_pct


def read(ctx):
    return request_count_pct(ctx, "serve.bucket_rounded_up", "serve.prep")
