"""loader_build_ms.train: mean ms the producer builds and uploads a bag
(``loader.build``)."""

from benchmark.program_spans import bag_ms


def read(ctx):
    return bag_ms(ctx, "loader.build")
