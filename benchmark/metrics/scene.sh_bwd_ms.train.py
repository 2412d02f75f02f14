"""Device ms a step of the program's span `scene.sh_bwd` (the backward of
`models/splatfacto.sh_colors`, kernel J's backward launch, on autograd's
thread)."""
from benchmark.program_spans import per_unit


def read(ctx):
    return per_unit(ctx, "train", "scene.sh_bwd", "device_ms")
