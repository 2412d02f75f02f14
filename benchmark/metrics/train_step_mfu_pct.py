"""The whole training step's share of the card's float32 peak: the
operations of the window's steps (benchmark/peaks.py, counted from the
reference's walk of the traced steps) over the window's seconds times
67 TFLOP/s."""


def read(ctx):
    if ctx["kind"] != "train":
        return None
    p, w = ctx["peaks"], ctx["window"]
    ops = p.train_step_ops(ctx["work"], ctx["config"]) * w["units"]
    return 100.0 * ops / (w["seconds"] * p.FP32_OPS_PER_S)
