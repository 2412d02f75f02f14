"""Millions of plane samples a step that 4DGS's encoder takes (slots x 6
planes x scales): the program's counter `deform4d.samples`."""
from benchmark.program_spans import per_unit


def read(ctx):
    n = per_unit(ctx, "train", "deform4d.samples", "total")
    return None if n is None else n / 1e6
