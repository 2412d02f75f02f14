"""Millions of active slots a step that PVG's temporal transform left
faded at the step's time (o(t) < 1/255: no pixel's alpha passes the
compositor's threshold): the program's counter `pvg.faded`, read beside
`render.pairs_m.train`."""
from benchmark.program_spans import per_unit


def read(ctx):
    faded = per_unit(ctx, "train", "pvg.faded", "total")
    return None if faded is None else faded / 1e6
