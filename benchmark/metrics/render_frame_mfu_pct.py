"""The whole eval frame's share of the card's float32 peak: the
operations of the window's frames (benchmark/peaks.py, counted from the
reference's walk of the traced frames) over the window's seconds times
67 TFLOP/s."""


def read(ctx):
    if ctx["kind"] != "render":
        return None
    p, w = ctx["peaks"], ctx["window"]
    ops = p.render_frame_ops(ctx["work"], ctx["config"]) * w["units"]
    return 100.0 * ops / (w["seconds"] * p.FP32_OPS_PER_S)
