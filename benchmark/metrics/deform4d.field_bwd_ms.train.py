"""Device ms a step of the program's span `deform4d.field_bwd`: the
backward of 4DGS's encoder and decoder (the planes' scattered gradient,
the coordinates' gradient into the centres, the decoder's GEMMs), on
autograd's thread."""
from benchmark.program_spans import per_unit


def read(ctx):
    return per_unit(ctx, "train", "deform4d.field_bwd", "device_ms")
