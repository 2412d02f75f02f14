"""Device ms a step of the program's span `pvg.temporal_bwd`: the
closed-form backward of PVG's temporal transform, on autograd's
thread."""
from benchmark.program_spans import per_unit


def read(ctx):
    return per_unit(ctx, "train", "pvg.temporal_bwd", "device_ms")
