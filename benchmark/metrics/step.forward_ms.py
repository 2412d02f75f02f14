"""Device ms a step of the program's span `step.forward`: the step's
forward (compose, SH, sky, render) and its losses."""
from benchmark.program_spans import per_unit


def read(ctx):
    return per_unit(ctx, "train", "step.forward", "device_ms")
