"""What the readers of the program's own spans share. The program's
recorder (street_gaussians_ns_tpu_torch.utils.profiling) records only
while a profiler session is on, which in a run is the traced stretch, so
its snapshot holds that stretch's spans; a reader divides by the units
traced. A program without the recorder's snapshot gives nothing, and every
reader then returns None."""
from __future__ import annotations


def _snapshot() -> dict:
    from street_gaussians_ns_tpu_torch.utils import profiling
    snap = getattr(profiling, "snapshot", None)
    return snap() if snap is not None else {}


def per_unit(ctx: dict, kind: str, name: str, field: str):
    """The span `name`'s `field` ("device_ms", "host_ms") over the traced
    units of a `kind` cell; None where the span or the field is absent
    (device_ms is None off the card)."""
    if ctx["kind"] != kind:
        return None
    row = _snapshot().get(name)
    if row is None or row.get(field) is None:
        return None
    return row[field] / ctx["units"]


def syncs_per_unit(ctx: dict, kind: str, field: str):
    """The sum of `field` ("syncs", "wait_ms") over the spans where the
    host waits on the card, per traced unit of a `kind` cell; None where
    nothing was recorded."""
    if ctx["kind"] != kind:
        return None
    snap = _snapshot()
    if not snap:
        return None
    return sum(r.get(field, 0) for r in snap.values()) / ctx["units"]
