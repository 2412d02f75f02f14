"""Device ms a step of the program's span `scene.pose` inside `compose`:
the boxes at the camera's time with the bbox deltas, the objects posed
into the world and their Fourier DC colour."""
from benchmark.program_spans import per_unit


def read(ctx):
    return per_unit(ctx, "train", "scene.pose", "device_ms")
