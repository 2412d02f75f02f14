"""Device ms a step of the program's span `deform4d.decode`: the forward
of 4DGS's decoder and its three heads over every slot (models/deform4d.
decode)."""
from benchmark.program_spans import per_unit


def read(ctx):
    return per_unit(ctx, "train", "deform4d.decode", "device_ms")
