"""Device ms a frame of the program's span `tiles.row_trim`
(`ops/tiles._row_trim_counts`)."""
from benchmark.program_spans import per_unit


def read(ctx):
    return per_unit(ctx, "render", "tiles.row_trim", "device_ms")
