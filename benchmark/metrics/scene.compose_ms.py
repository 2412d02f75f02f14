"""Device ms a frame of the program's span `scene.compose`
(`models/scene_graph.compose`)."""
from benchmark.program_spans import per_unit


def read(ctx):
    return per_unit(ctx, "render", "scene.compose", "device_ms")
