"""Device ms a step of the kernels launched inside
`ops/tiles.bin_and_pack` (row trim, expansions A and B, the pair sort),
from the traced stretch: a span around the call, the kernels whose launch
lies in it."""


def read(ctx):
    if ctx["kind"] != "train":
        return None
    s = ctx["trace"]["span_device_s"].get("bench::bin_and_pack", 0.0)
    return 1e3 * s / ctx["units"] if s > 0 else None
