"""Device ms a step of the program's span `pvg.temporal`: the forward of
PVG's temporal transform (models/pvg.temporal: mu(t) and o(t) of every
slot at the step's time)."""
from benchmark.program_spans import per_unit


def read(ctx):
    return per_unit(ctx, "train", "pvg.temporal", "device_ms")
