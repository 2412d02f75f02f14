"""The readers of the program's own spans (benchmark/program_spans.py and
the metrics that use it), on the CPU: a tiny traced sg_render_480 run
counts the frame's three host syncs (one count read a render) and reports
no device time, which only the card has; a program without the recorder's
snapshot gives every reader nothing."""
from __future__ import annotations

import pytest

from benchmark import run as R
from benchmark.tests import tiny

SPEC = R.load_spec()
SPAN_METRICS = [m["name"] for m in SPEC["per_layer"]
                if "program_spans" in (R.HERE / "metrics" /
                                       f"{m['name']}.py").read_text()]
DEVICE_MS = ("scene.compose_ms", "scene.sh_ms", "scene.sky_ms",
             "render.project_ms.render", "tiles.row_trim_ms.render")


def test_traced_render_run_counts_host_syncs():
    out = tiny.run_in_subprocess("sg_render_480", True)
    m = out["result"]["metrics"]
    assert out["result"]["correct"] is True
    assert m["program.host_syncs.render"] == {"value": 3.0,
                                              "unit": "syncs"}
    assert m["program.host_wait_ms.render"]["value"] >= 0.0
    assert not set(DEVICE_MS) & set(m)          # no card, no device time


@pytest.mark.parametrize("kind", ["train", "render"])
def test_readers_find_nothing_without_the_recorder(kind, monkeypatch):
    """The parent of this change has no profiling.snapshot: each reader
    returns None there instead of raising."""
    from street_gaussians_ns_tpu_torch.utils import profiling
    monkeypatch.delattr(profiling, "snapshot")
    ctx = {"kind": kind, "units": 2}
    assert len(SPAN_METRICS) == 16
    for name in SPAN_METRICS:
        assert R.load_reader(name)(ctx) is None, name
