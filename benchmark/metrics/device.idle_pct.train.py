"""1 - the union of the device's activity intervals over the traced
stretch's wall time (torch.profiler), in percent."""


def read(ctx):
    if ctx["kind"] != "train":
        return None
    t = ctx["trace"]
    if t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
