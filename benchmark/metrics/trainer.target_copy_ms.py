"""Device ms a step of the program's span `trainer.target_copy`: the
target images copied to the card from pageable memory."""
from benchmark.program_spans import per_unit


def read(ctx):
    return per_unit(ctx, "train", "trainer.target_copy", "device_ms")
