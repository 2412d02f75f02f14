"""Device ms a frame of the program's span `scene.sh`
(`models/splatfacto.sh_colors`)."""
from benchmark.program_spans import per_unit


def read(ctx):
    return per_unit(ctx, "render", "scene.sh", "device_ms")
