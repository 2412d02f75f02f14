"""Device ms a step of the program's span `deform4d.field`: the forward
of 4DGS's HexPlane encoder (models/deform4d.encode: the six planes of
every scale sampled at each slot's normalised centre and the step's time,
and their products)."""
from benchmark.program_spans import per_unit


def read(ctx):
    return per_unit(ctx, "train", "deform4d.field", "device_ms")
