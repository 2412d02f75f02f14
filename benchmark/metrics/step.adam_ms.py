"""Device ms a step of the program's span `step.adam`: every
`adam_update` of the step."""
from benchmark.program_spans import per_unit


def read(ctx):
    return per_unit(ctx, "train", "step.adam", "device_ms")
