"""Host syncs a step: the program's spans that mark where the host
waits on the card (`sync=True`), counted."""
from benchmark.program_spans import syncs_per_unit


def read(ctx):
    return syncs_per_unit(ctx, "train", "syncs")
