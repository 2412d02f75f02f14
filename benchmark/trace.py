"""Spans the benchmark puts around the program's calls, the traced
stretch under torch.profiler, and its reduction from the Chrome trace:
the device's busy time (the union of its activity intervals), the device
time of the kernels launched inside a span, time by kernel, the longest
idle gaps by what the host was doing, and the work a traced unit needs
(counted by the plain reference's walk of the same frames)."""
from __future__ import annotations

import json
import time
from pathlib import Path

import torch

from . import scene
from .reference import gs

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPANS = ("bench::unit", "bench::bin_and_pack")


class OutsideStep:
    """Host seconds of each window step inside the program's step call
    (`scene_train_step` as the trainer calls it, or `train_step`), and of
    the whole iteration: the loop's share outside the step."""

    def __init__(self, drv):
        self.drv = drv
        self.inside = 0.0
        self.patched = None

    def start(self):
        mods = self.drv.program_modules()
        owner, name = ((mods["trainer"], "scene_train_step")
                       if "trainer" in mods else
                       (mods["train_step"], "train_step")
                       if "train_step" in mods else (None, None))
        if owner is None:
            return
        orig = getattr(owner, name)

        def timed(*a, **kw):
            t = time.perf_counter()
            out = orig(*a, **kw)
            self.inside += time.perf_counter() - t
            self.calls += 1
            return out
        self.calls = 0
        setattr(owner, name, timed)
        self.patched = (owner, name, orig)
        self.t0 = time.perf_counter()

    def stop(self):
        if self.patched:
            owner, name, orig = self.patched
            setattr(owner, name, orig)
            self.total = time.perf_counter() - self.t0

    def result(self) -> dict:
        if not self.patched or not self.calls:
            return {}
        return {"outside_step_ms": 1e3 * (self.total - self.inside)
                / self.calls}


def traced_stretch(drv, k: int, workdir: Path, device: str) -> dict:
    """k units under torch.profiler (CPU and CUDA activity), each inside a
    "bench::unit" span and every bin_and_pack call inside a
    "bench::bin_and_pack" span; returns the reduced trace."""
    from street_gaussians_ns_tpu_torch.ops import composite

    orig = composite.bin_and_pack

    def spanned(*a, **kw):
        with torch.profiler.record_function("bench::bin_and_pack"):
            return orig(*a, **kw)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    composite.bin_and_pack = spanned
    try:
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(k):
                with torch.profiler.record_function("bench::unit"):
                    drv.run_unit()
            if device == "cuda":
                torch.cuda.synchronize()
    finally:
        composite.bin_and_pack = orig
    path = workdir / "trace.json"
    prof.export_chrome_trace(str(path))
    del prof
    return reduce_trace(json.loads(path.read_text()))


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce_trace(doc: dict, top: int = 10) -> dict:
    """The numbers the per-layer readers take from a Chrome trace (times
    in microseconds inside, seconds out)."""
    ev = [e for e in doc.get("traceEvents", []) if e.get("ph") == "X"]
    dev = [e for e in ev if e.get("cat") in DEVICE_CATS]
    units = sorted((e["ts"], e["ts"] + e["dur"]) for e in ev
                   if e.get("name") == "bench::unit"
                   and e.get("cat") == "user_annotation")
    if units:
        w0, w1 = units[0][0], units[-1][1]
    else:
        w0 = min((e["ts"] for e in dev), default=0.0)
        w1 = max((e["ts"] + e["dur"] for e in dev), default=0.0)
    busy_iv = _merge((max(e["ts"], w0), min(e["ts"] + e["dur"], w1))
                     for e in dev if e["ts"] + e["dur"] > w0 and e["ts"] < w1)
    busy = sum(e - s for s, e in busy_iv)
    by_name = {}
    for e in dev:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"]
    # Kernels launched inside a span: their runtime call lies in it.
    launch = {e["args"]["correlation"]: e for e in ev
              if e.get("cat") in ("cuda_runtime", "cuda_driver")
              and "correlation" in e.get("args", {})}
    span_dev = {}
    for name in SPANS:
        iv = sorted((e["ts"], e["ts"] + e["dur"], e.get("tid")) for e in ev
                    if e.get("name") == name
                    and e.get("cat") == "user_annotation")
        tot = 0.0
        for d in dev:
            r = launch.get(d.get("args", {}).get("correlation"))
            if r is None:
                continue
            t = r["ts"]
            if any(s <= t <= e_ and r.get("tid") == tid
                   for s, e_, tid in iv):
                tot += d["dur"]
        span_dev[name] = tot
    # The longest idle gaps, each named by the innermost host op running
    # at its start on the thread that ran the units.
    host = [e for e in ev if e.get("cat") in ("cpu_op", "user_annotation")]
    main_tid = next((e.get("tid") for e in ev
                     if e.get("name") == "bench::unit"), None)
    host = [e for e in host if e.get("tid") == main_tid]
    gaps = []
    prev = w0
    for s, e in busy_iv + [[w1, w1]]:
        if s > prev:
            gaps.append((s - prev, prev))
        prev = max(prev, e)
    gaps.sort(reverse=True)
    named = []
    for dur, at in gaps[:top]:
        cover = [h for h in host if h["ts"] <= at <= h["ts"] + h["dur"]]
        inner = min(cover, key=lambda h: h["dur"])["name"] if cover \
            else "host"
        named.append([inner, dur * 1e-6])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {"busy_s": busy * 1e-6, "window_s": max(w1 - w0, 0.0) * 1e-6,
            "kernel_s": {k: v * 1e-6 for k, v in by_name.items()},
            "span_device_s": {k: v * 1e-6 for k, v in span_dev.items()},
            "breakdown": {"device_ops": [[_short(k), v * 1e-6]
                                         for k, v in ops],
                          "idle_gaps": named}}


def _short(name: str, width: int = 160) -> str:
    """A kernel's name as the breakdown shows it: C++ signatures cut."""
    return name if len(name) <= width else name[:width - 3] + "..."


def work_of(drv, cfg: dict, traffic: dict, state, cams: list,
            device: str) -> dict:
    """The work the traced units need, counted by the reference's walk
    of the same frames: per unit on average, the gaussians rendered
    (summed over renders), the pairs, the (pixel, pair) evaluations up to
    saturation and the contributing ones, the pixels and the active
    parameters. A train unit is one render of the state at the stretch's
    start; a render unit is the frame's three renders."""
    store = state if state is not None else drv.reference_store()
    tracks = getattr(drv, "tracks", None)
    if isinstance(tracks, dict) or tracks is None:
        tr_ref = tracks
    else:
        tr_ref = {f: getattr(tracks, f) for f in (
            "times", "centers", "quats", "valid", "sizes", "obj_first",
            "obj_last")}
    counts = {}
    train = traffic["kind"] == "train"
    with torch.no_grad():
        for cam in cams:
            gs.forward(store, tr_ref, cam, cfg["sh_degree"], training=train,
                       extras=not train, counts=counts,
                       jitter=torch.full((2, cam["height"], cam["width"]),
                                         0.5, device=device))
    n = max(len(cams), 1)
    out = {k: v / n for k, v in counts.items()}
    out["pixels"] = cams[0]["width"] * cams[0]["height"] if cams else 0
    out["renders"] = 1 if train else 3
    act = 0
    params = 0
    for part in ("bg", "obj"):
        if f"{part}/active" in store:
            a = int(store[f"{part}/active"].sum())
            act += a
            params += a * sum(_width(store, part, g)
                              for g in scene.PARAMS)
    out["active"] = act
    out["active_objects"] = (int(store["obj/active"].sum())
                             if "obj/active" in store else 0)
    out["pixel_renders"] = out["pixels"] * out["renders"]
    if train:
        out.update(evals_bwd=out.get("evals", 0),
                   contrib_bwd=out.get("contrib", 0),
                   pairs_bwd=out.get("pairs", 0), pixels_bwd=out["pixels"])
    out["params"] = params + (store["env_map"].numel()
                              if store.get("env_map") is not None else 0)
    out["sh_degree"] = cfg["sh_degree"]
    return out


def _width(store, part, g) -> int:
    """Floats of one gaussian's leaf g."""
    x = store[f"{part}/{g}"]
    lead = 2 if part == "obj" else 1
    n = 1
    for s in x.shape[lead:]:
        n *= s
    return n
