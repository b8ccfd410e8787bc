"""loader_wait_ms.train: mean ms the training loop waits for its next bag
(``loader.wait``)."""

from benchmark.program_spans import bag_ms


def read(ctx):
    return bag_ms(ctx, "loader.wait")
