"""The port's spans and host-sync counts, and a trace capture (counterpart
of street_gaussians_ns_tpu/utils/profiling.py).

`span(name)` marks a layer of the program:

    with profiling.span("render.project"):
        proj = project(...)

and `spanned(name)` marks a whole function the same way. Tracing is on
while `enable(True)` holds or a torch.profiler session records. Off, a
span is one check and a shared no-op: no `record_function`, no CUDA
event, no allocation, no synchronisation. On, a span opens
`record_function("sgnt::" + name)`, so it lands in the profiler's Chrome
trace on the device's clock, takes the host's clock and, where CUDA is in
use, records a CUDA event on the current stream at entry and at exit (the
events are read in `snapshot()`, never on the hot path). Its parent is
the innermost span open on the same thread (autograd's backward runs on a
thread of its own on the card). `sync=True` marks a place where the host
blocks on the card; such a span also counts as a host sync and its host
time as time waited. `count(name, value)` adds a host number the program
already holds to a counter, under the same switch (off: one check);
`recording()` reads the switch, for a counter whose value costs work.

`snapshot()` synchronises and returns, by span name, `count`, `host_ms`,
`device_ms` (the elapsed device time between the span's two stream
markers, busy and idle alike, so spans that partition a unit sum to its
device timeline; None without CUDA), `parent` and, for sync spans,
`syncs` and `wait_ms`; for a counter, `count` (calls), `total` (the sum of
its values) and `parent`. The registry records only while tracing is on;
`reset()` clears it. `trace(dir)` resets it, records the CPU's and the
card's activity under torch.profiler and writes <dir>/trace.json (Chrome
trace) and <dir>/spans.json (the snapshot).
"""
from __future__ import annotations

import contextlib
import functools
import json
import threading
import time
from pathlib import Path

import torch

PREFIX = "sgnt::"
_FOLD_AT = 4096        # pending event pairs before completed ones are read

_profiler_enabled = torch.autograd._profiler_enabled


class _Stat:
    __slots__ = ("count", "host_s", "device_ms", "parent", "sync")

    def __init__(self, parent, sync):
        self.count = 0
        self.host_s = 0.0
        self.device_ms = None
        self.parent = parent
        self.sync = sync


class _Registry:
    """Each span name's totals, the CUDA event pairs not yet read, the
    events free for reuse, and each thread's stack of open spans."""

    def __init__(self):
        self.on = False
        self.lock = threading.Lock()
        self.stats = {}
        self.counters = {}       # name -> [calls, total, parent]
        self.pending = []        # (stat, start event, end event)
        self.pool = []
        self.local = threading.local()

    def stack(self) -> list:
        st = getattr(self.local, "stack", None)
        if st is None:
            st = self.local.stack = []
        return st

    def event(self) -> torch.cuda.Event:
        with self.lock:
            if self.pool:
                return self.pool.pop()
        return torch.cuda.Event(enable_timing=True)

    def add(self, name, parent, sync, host_s, events):
        with self.lock:
            st = self.stats.get(name)
            if st is None:
                st = self.stats[name] = _Stat(parent, sync)
            st.count += 1
            st.host_s += host_s
            if events is not None:
                self.pending.append((st,) + events)
                if len(self.pending) >= _FOLD_AT:
                    self._fold(wait=False)

    def add_count(self, name, value):
        st = self.stack()
        parent = st[-1].name if st else None
        with self.lock:
            row = self.counters.get(name)
            if row is None:
                row = self.counters[name] = [0, 0, parent]
            row[0] += 1
            row[1] += value

    def _fold(self, wait: bool):
        """Read the pending event pairs, oldest first: all of them (the
        caller has synchronised) or those the card has passed."""
        done = 0
        for st, e0, e1 in self.pending:
            if not wait and not e1.query():
                break
            st.device_ms = (st.device_ms or 0.0) + e0.elapsed_time(e1)
            self.pool += (e0, e1)
            done += 1
        del self.pending[:done]


_REG = _Registry()


class _NoSpan:
    """What span() returns while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("name", "sync", "parent", "rf", "e0", "t0")

    def __init__(self, name: str, sync: bool):
        self.name = name
        self.sync = sync

    def __enter__(self):
        st = _REG.stack()
        self.parent = st[-1].name if st else None
        st.append(self)
        self.rf = torch.profiler.record_function(PREFIX + self.name)
        self.rf.__enter__()
        self.e0 = None
        if torch.cuda.is_initialized():
            self.e0 = _REG.event()
            self.e0.record()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        events = None
        if self.e0 is not None:
            e1 = _REG.event()
            e1.record()
            events = (self.e0, e1)
        host_s = time.perf_counter() - self.t0
        self.rf.__exit__(*exc)
        st = _REG.stack()
        if st and st[-1] is self:
            st.pop()
        _REG.add(self.name, self.parent, self.sync, host_s, events)
        return False


def enable(on: bool = True) -> None:
    """Record spans without a profiler session (or stop: False)."""
    _REG.on = bool(on)


def recording() -> bool:
    """Whether spans and counters record now: work done only to feed a
    counter is skipped when this is False."""
    return bool(_REG.on or _profiler_enabled())


def span(name: str, sync: bool = False):
    """Context manager: the span `name` (see the module docstring);
    sync=True where the host blocks on the card inside it."""
    if not (_REG.on or _profiler_enabled()):
        return _NO_SPAN
    return _Span(name, sync)


def spanned(name: str, sync: bool = False):
    """Decorator: every call of the function is the span `name`."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if not (_REG.on or _profiler_enabled()):
                return fn(*args, **kwargs)
            with _Span(name, sync):
                return fn(*args, **kwargs)
        return inner
    return wrap


def count(name: str, value) -> None:
    """Add `value`, a host number, to the counter `name` while tracing is
    on; its parent is the innermost span open on this thread. Off, one
    check and nothing else."""
    if not (_REG.on or _profiler_enabled()):
        return
    _REG.add_count(name, value)


def snapshot() -> dict:
    """{name: {"count", "host_ms", "device_ms", "parent"[, "syncs",
    "wait_ms"]}} of every span and {name: {"count", "total", "parent"}}
    of every counter recorded since reset(); waits for the card first
    when spans recorded CUDA events."""
    with _REG.lock:
        if _REG.pending:
            torch.cuda.synchronize()
            _REG._fold(wait=True)
        out = {}
        for name, st in _REG.stats.items():
            row = {"count": st.count, "host_ms": 1e3 * st.host_s,
                   "device_ms": st.device_ms, "parent": st.parent}
            if st.sync:
                row.update(syncs=st.count, wait_ms=1e3 * st.host_s)
            out[name] = row
        for name, (calls, total, parent) in _REG.counters.items():
            out[name] = {"count": calls, "total": total, "parent": parent}
        return out


def reset() -> None:
    """Clear the registry (pending events are dropped unread)."""
    with _REG.lock:
        _REG.stats.clear()
        _REG.counters.clear()
        _REG.pool += [e for _, e0, e1 in _REG.pending for e in (e0, e1)]
        _REG.pending.clear()


@contextlib.contextmanager
def trace(log_dir):
    """`with trace(dir): step()` records the CPU's and (when there is
    one) the card's activity under torch.profiler, the program's spans
    among it, and writes <dir>/trace.json, a Chrome trace, and
    <dir>/spans.json, the spans' snapshot(). Yields the profiler, whose
    key_averages() and events() stay readable after the block."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    reset()
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(log_dir / "trace.json"))
    (log_dir / "spans.json").write_text(json.dumps(snapshot(), indent=1))
