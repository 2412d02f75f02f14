"""The harness on the CPU: every cell, configuration, traffic mix, metric
reader and kernel bound is found by its name; a cell, a configuration and
a metric added as files only runs; the last line's keys; no JAX."""
from __future__ import annotations

import json
import shutil
import subprocess
import sys

import pytest

from benchmark import run as R
from benchmark.tests import tiny

SPEC = R.load_spec()
CELLS = [w["name"] for w in SPEC["workloads"]]
LAYER = [m["name"] for m in SPEC["per_layer"]]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_is_found_by_name(cell):
    f = R.find_cell(SPEC, cell)
    cfg, traffic = f["config"], f["traffic"]
    conf = {c["name"]: c for c in SPEC["configs"]}[f["cell"]["config"]]
    assert cfg["name"] == conf["name"]
    assert sorted(cfg["reduced"]) == sorted(conf["reduced"])
    assert (R.HERE / "drivers" / f"{traffic['driver']}.py").exists()
    assert traffic["kind"] in ("train", "render")
    e2e, layer = R.cell_metrics(SPEC, cell)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2
    assert layer, "every cell reports a per-layer metric"
    assert set(traffic["limits"]) >= {"rgb_mean_gap"} or set(
        traffic["limits"]) >= {"loss_gap", "grad_gap", "change_gap"}


@pytest.mark.parametrize("metric", LAYER)
def test_metric_reader_is_found_by_name(metric):
    read = R.load_reader(metric)
    ctx = {"kind": "none", "setup_seconds": {}, "spans": {}}
    assert read(ctx) is None or metric == "trainer.build_stores_s"


def test_every_name_in_the_spec_resolves():
    cells = {w["name"] for w in SPEC["workloads"]}
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert set(m.get("workloads", [])) <= cells
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
    for c in SPEC["configs"]:
        assert (R.ROOT / c["file"]).exists()
    bounds = R.load_bounds()
    assert {"composite_fwd", "composite_bwd"} <= set(bounds)


def test_a_cell_added_as_files_runs(tmp_path):
    """A new configuration file, traffic file and metric reader, and the
    entries that name them, make a cell that runs: no file edited."""
    shutil.copytree(R.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((R.ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((R.HERE / "configs" / "scene_graph_1m.json").read_text())
    cfg["name"] = "scene_graph_small"
    tr = json.loads((R.HERE / "traffic" / "drive_480.json").read_text())
    tiny.shrink(cfg, tr)
    (tmp_path / "benchmark" / "configs" / "scene_graph_small.json"
     ).write_text(json.dumps(cfg))
    (tmp_path / "benchmark" / "traffic" / "drive_small.json"
     ).write_text(json.dumps(tr))
    (tmp_path / "benchmark" / "metrics" / "frames_counted.py").write_text(
        "def read(ctx):\n    return float(ctx['window']['units'])\n")
    spec["configs"].append({"name": "scene_graph_small", "source": "test",
                            "file": "benchmark/configs/scene_graph_small.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "small.render", "config":
                              "scene_graph_small", "traffic": "drive_small",
                              "chips": 1, "why": "test"})
    for m in spec["end_to_end"]:
        if m["name"] in ("render_fps", "render_p95_ms"):
            m["workloads"].append("small.render")
    spec["per_layer"].append({"name": "frames_counted", "unit": "frames",
                              "better": "higher", "source": "host_clock",
                              "layer": "test", "moves": "render_fps",
                              "workloads": ["small.render"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    r0 = R.run("small.render", 7, 0.5, False, device="cpu", root=tmp_path,
               log=lambda *a: None)
    assert r0["correct"] and set(r0["metrics"]) == {
        "render_fps", "render_p95_ms", "peak_mem_gib", "setup_s"}
    r1 = R.run("small.render", 8, 0.5, True, device="cpu", root=tmp_path,
               trace_units=2, log=lambda *a: None)
    assert r1["correct"] and r1["metrics"]["frames_counted"]["value"] >= 1


@pytest.mark.parametrize("trace", [False, True])
def test_last_line_keys_and_no_jax(trace):
    out = tiny.run_in_subprocess("sg_render_480", trace)
    assert out["forbidden"] == []
    keys = out["keys"]
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert keys[-1] == "checks"
    r = out["result"]
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 1
    for k, v in r["checks"].items():
        assert set(v) == {"value", "limit"}
    dev = r["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    if trace:
        assert {"busy_s", "window_s"} <= set(dev)
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert {m: v["unit"] for m, v in r["metrics"].items()} == {
            "render_fps": "frames/s", "render_p95_ms": "ms",
            "peak_mem_gib": "GiB", "setup_s": "s"}


def _cli(cwd, *extra):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "sg_render_480",
         "--seed", "1", "--seconds", "1", "--trace", "0", *extra],
        capture_output=True, text=True, cwd=cwd, timeout=300)


def test_no_card_no_result():
    """Without a card the run exits non-zero and prints no result."""
    p = _cli(R.ROOT)
    assert p.returncode != 0
    assert not any(line.startswith("{") for line in p.stdout.splitlines())


def test_benchmark_files_alone_do_not_run(tmp_path):
    """A directory with BENCHMARK.json and the files under paths alone
    (no program) exits non-zero and prints no result."""
    shutil.copy(R.ROOT / "BENCHMARK.json", tmp_path)
    for p in SPEC["paths"]:
        shutil.copytree(R.ROOT / p, tmp_path / p,
                        ignore=shutil.ignore_patterns("__pycache__"))
    p = _cli(tmp_path)
    assert p.returncode != 0
    assert not any(line.startswith("{") for line in p.stdout.splitlines())
