"""Device ms a step of the program's span `parallel.grad_reduce`: the
sharded step's sums of the gradients over the mesh axes a leaf is
replicated on (parallel/sharded), on a (4, 1) mesh the all-reduce of every
gradient over the four data rows. Rank 0's span: every rank makes the
same calls."""
from benchmark.program_spans import per_unit


def read(ctx):
    return per_unit(ctx, "train", "parallel.grad_reduce", "device_ms")
