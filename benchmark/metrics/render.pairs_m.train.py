"""Millions of (gaussian, tile) pairs a step: the program's counter
`render.pairs`, the pair count each render already reads to the host,
summed over a traced step's renders."""
from benchmark.program_spans import per_unit


def read(ctx):
    pairs = per_unit(ctx, "train", "render.pairs", "total")
    return None if pairs is None else pairs / 1e6
