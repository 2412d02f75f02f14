"""Host ms a step in the trainer's draw of the next frame and camera
(`dm.next_train`, the program's span `trainer.draw`)."""
from benchmark.program_spans import per_unit


def read(ctx):
    return per_unit(ctx, "train", "trainer.draw", "host_ms")
