"""launch_ms.rps: mean ms a request of the host's issue of bag, embed and
head inside the gate (``serve.bag``, ``serve.embed``, ``serve.head``).
``serve.stats`` is left out: the statistics begin with a blocking copy of
``torch.quantile``'s quantiles, so that span holds the host's wait on the
request's device work, not its launches."""

from benchmark.program_spans import request_ms


def read(ctx):
    return request_ms(ctx, "serve.bag", "serve.embed", "serve.head")
