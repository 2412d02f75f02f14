"""Device ms a step of the program's span `render.project` (the EWA
projection in `ops/render.render`)."""
from benchmark.program_spans import per_unit


def read(ctx):
    return per_unit(ctx, "train", "render.project", "device_ms")
