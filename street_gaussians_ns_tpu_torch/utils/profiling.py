"""Profiling helpers (counterpart of
street_gaussians_ns_tpu/utils/profiling.py): nerfstudio's
@profiler.time_function decorator and a trace capture.

`time_function` times each call on the host's clock, waiting for the card
first where the call returned CUDA tensors, and accumulates per-name
stats (`stats`, `reset`); `trace` records a torch.profiler trace of the
CPU and the card and writes it to a directory as a Chrome trace.
"""
from __future__ import annotations

import contextlib
import functools
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict

import torch

_STATS: Dict[str, list] = defaultdict(list)


def _cuda_devices(tree, out: set) -> set:
    """The CUDA devices of the tensors in a (nested) result."""
    if isinstance(tree, torch.Tensor):
        if tree.is_cuda:
            out.add(tree.device)
    elif isinstance(tree, dict):
        for v in tree.values():
            _cuda_devices(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _cuda_devices(v, out)
    return out


def time_function(fn=None, *, name: str = None):
    """Decorator: time each call, the card's work for the tensors it
    returns included (torch.cuda.synchronize of their devices; nothing to
    wait for on the CPU); the times go to stats()."""
    def wrap(f):
        label = name or f.__qualname__

        @functools.wraps(f)
        def inner(*args, **kwargs):
            t0 = time.perf_counter()
            out = f(*args, **kwargs)
            for dev in _cuda_devices(out, set()):
                torch.cuda.synchronize(dev)
            _STATS[label].append(time.perf_counter() - t0)
            return out

        return inner

    return wrap(fn) if fn is not None else wrap


def stats() -> Dict[str, Dict[str, float]]:
    out = {}
    for k, v in _STATS.items():
        out[k] = {"count": len(v), "total_s": sum(v),
                  "mean_ms": 1e3 * sum(v) / max(len(v), 1),
                  "last_ms": 1e3 * v[-1]}
    return out


def reset():
    _STATS.clear()


@contextlib.contextmanager
def trace(log_dir):
    """`with trace(dir): step()` records the CPU's and (when there is
    one) the card's activity under torch.profiler and writes
    <dir>/trace.json, a Chrome trace. Yields the profiler, whose
    key_averages() and events() stay readable after the block."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(log_dir / "trace.json"))
