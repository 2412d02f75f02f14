"""Device ms a step of the program's span `render.project_bwd` (the
backward of `core/projection.project` on the card, kernel L's backward
launch, on autograd's thread)."""
from benchmark.program_spans import per_unit


def read(ctx):
    return per_unit(ctx, "train", "render.project_bwd", "device_ms")
