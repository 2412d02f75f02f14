"""Host ms a window step spends in the trainer's loop outside
`scene_train_step` (the data draw, the target's copy, the refine pass, the
capacity checks): the benchmark's span around the step call."""


def read(ctx):
    if ctx["kind"] != "train" or "trainer" not in ctx.get("modules", ()):
        return None
    return ctx["spans"].get("outside_step_ms")
