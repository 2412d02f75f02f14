"""Device ms a frame of the program's span `scene.sky`
(`models/splatfacto.sky_color`)."""
from benchmark.program_spans import per_unit


def read(ctx):
    return per_unit(ctx, "render", "scene.sky", "device_ms")
