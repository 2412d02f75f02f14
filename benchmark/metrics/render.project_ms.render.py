"""Device ms a frame of the program's span `render.project` (the EWA
projection in `ops/render.render`, three renders a frame)."""
from benchmark.program_spans import per_unit


def read(ctx):
    return per_unit(ctx, "render", "render.project", "device_ms")
