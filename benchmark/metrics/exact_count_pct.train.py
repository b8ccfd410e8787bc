"""exact_count_pct.train: the share of bags whose bucket the device's exact
count decided (``loader.exact_count``), in %."""

from benchmark.program_spans import bag_count_pct


def read(ctx):
    return bag_count_pct(ctx, "loader.exact_count", "loader.build")
