"""The hand-written kernels' share of their roofline in the traced
stretch: the sum of their bounds (benchmark/bounds/<kernel>.json, from the
work the reference's walk counts) over the sum of their device time. A
kernel with no bound file is left out of both sums and named."""


def read(ctx):
    if ctx["kind"] != "render":
        return None
    ks = ctx["trace"]["kernel_s"]
    bound = measured = 0.0
    used = set()
    for name, spec in ctx["bounds"].items():
        t = sum(v for k, v in ks.items() if spec["match"] in k)
        if t <= 0:
            continue
        used.add(spec["match"])
        measured += t
        bound += ctx["peaks"].bound_seconds(spec, ctx["work"]) * ctx["units"]
    hand = ("lookback_scan", "expand_kernel", "pack_kernel", "ranksum_kernel",
            "segsum_kernel", "rows_lookback_scan")
    left = sorted({h for h in hand for k in ks if h in k} - used)
    if left:
        ctx["log"](f"kernels without a bound file: {left}")
    return 100.0 * bound / measured if measured > 0 else None
