"""loader_read_ms.train: mean ms a bag's producer waits on its DICOM reads
(``loader.read``)."""

from benchmark.program_spans import bag_ms


def read(ctx):
    return bag_ms(ctx, "loader.read")
