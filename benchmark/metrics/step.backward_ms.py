"""Device ms a step of the program's span `step.backward`: the
`torch.autograd.grad` call, kernels E and F and autograd's own kernels."""
from benchmark.program_spans import per_unit


def read(ctx):
    return per_unit(ctx, "train", "step.backward", "device_ms")
