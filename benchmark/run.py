#!/usr/bin/env python3
"""The benchmark of the PyTorch/CUDA port (street_gaussians_ns_tpu_torch).

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

runs one cell of BENCHMARK.json once on the card and prints one JSON line
last on standard output: {"correct", "attempted", "failed", "metrics",
"device"[, "breakdown"], "checks"}. With --trace 0 the metrics are the
cell's end-to-end metrics, with --trace 1 its per-layer metrics.

Everything a cell is made of is found by name: the cell in
BENCHMARK.json, its configuration file (`configs[].file`), its traffic mix
benchmark/traffic/<traffic>.json, whose "driver" names the module of
benchmark/drivers/ that drives the program, each per-layer metric's reader
benchmark/metrics/<metric>.py and each kernel's bound
benchmark/bounds/<kernel>.json.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "street_gaussians_ns_tpu")


class BenchError(RuntimeError):
    """The cell cannot run here: no result is printed."""


def load_spec(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _json(path: Path) -> dict:
    return json.loads(path.read_text())


def find_cell(spec: dict, workload: str, root: Path = ROOT) -> dict:
    """The cell, its configuration and its traffic mix, by name."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise BenchError(f"unknown workload {workload!r}; cells: "
                         f"{sorted(cells)}")
    cell = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    config = _json(root / configs[cell["config"]]["file"])
    traffic = _json(root / "benchmark" / "traffic" / f"{cell['traffic']}.json")
    return {"cell": cell, "config": config, "traffic": traffic}


def cell_metrics(spec: dict, workload: str) -> tuple:
    """(end-to-end metrics, per-layer metrics) the cell reports."""
    def applies(m):
        return "workloads" not in m or workload in m["workloads"]
    e2e = [m for m in spec["end_to_end"] if applies(m)]
    names = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"] if applies(m)
             and m["moves"] in names]
    return e2e, layer


def load_reader(name: str, root: Path = ROOT):
    """The per-layer metric's reader: benchmark/metrics/<name>.py, whose
    read(ctx) returns the value or None where it finds nothing."""
    path = root / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def load_bounds(root: Path = ROOT) -> dict:
    """Each kernel's bound: benchmark/bounds/<kernel>.json."""
    return {p.stem: _json(p) for p in sorted(
        (root / "benchmark" / "bounds").glob("*.json"))}


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def set_cache_dirs(root: Path = ROOT) -> None:
    """Every build and kernel cache inside the checkout, at fixed paths
    (the port's own kernels build into build/torch_kernels/)."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "build" /
                                             "bench_torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "bench_triton")
    os.environ["USE_FLAX"] = "0"


def block_optional_imports() -> None:
    """The trainer mirrors its metrics to TensorBoard when the package
    imports; where TensorFlow is installed that import loads JAX. The
    benchmark runs without the mirror: the import raises ImportError,
    which the program's writer takes as the package being absent."""
    for name in ("torch.utils.tensorboard", "tensorboard", "tensorflow"):
        if name not in sys.modules:
            sys.modules[name] = None


def card_limit() -> str | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout else None
    except (OSError, subprocess.SubprocessError):
        return None


def p95(values: list) -> float:
    """The 95th percentile of all values (statistics.quantiles, inclusive
    of the ends)."""
    if len(values) < 2:
        return float(values[0])
    return statistics.quantiles(values, n=20, method="inclusive")[-1]


def _sync(device: str) -> None:
    if device == "cuda":
        import torch
        torch.cuda.synchronize()


def run(workload: str, seed: int, seconds: float, trace: bool, *,
        control: str | None = None, device: str = "cuda",
        spec: dict | None = None, found: dict | None = None,
        trace_units: int | None = None, log=print,
        root: Path = ROOT, fault: str | None = None) -> dict:
    """One run of one cell. Returns the result dict (the last line).
    `root` is the checkout whose BENCHMARK.json and data files name the
    cell; device="cpu" runs the program's plain versions (the tests).
    `fault` plants one of faults.FAULTS under the timed path."""
    from . import faults
    with faults.planted(fault):
        return _run(workload, seed, seconds, trace, control, device, spec,
                    found, trace_units, log, root)


def _run(workload, seed, seconds, trace, control, device, spec, found,
         trace_units, log, root) -> dict:
    import torch

    from . import peaks, trace as tr
    spec = spec or load_spec(root)
    found = found or find_cell(spec, workload, root)
    cell, config, traffic = found["cell"], found["config"], found["traffic"]
    if device == "cuda":
        if not torch.cuda.is_available():
            raise BenchError("torch.cuda.is_available() is False")
        if torch.cuda.device_count() < cell["chips"]:
            raise BenchError(f"{torch.cuda.device_count()} cards, the cell "
                             f"asks for {cell['chips']}")
    e2e, layer = cell_metrics(spec, workload)
    block_optional_imports()
    drv_mod = importlib.import_module(
        f"benchmark.drivers.{traffic['driver']}")
    with tempfile.TemporaryDirectory(prefix="sgnt-bench-") as wd:
        drv = drv_mod.Driver(config, traffic, seed, device, Path(wd),
                             control=control)
        drv.setup()
        _sync(device)
        setup_s = time.perf_counter() - T0
        spans = tr.OutsideStep(drv) if trace else None
        if spans:
            spans.start()
        units = 0
        t0 = time.perf_counter()
        while True:
            drv.run_unit()
            units += 1
            if time.perf_counter() - t0 >= seconds:
                break
        _sync(device)
        window_s = time.perf_counter() - t0
        if spans:
            spans.stop()
        peak = (torch.cuda.max_memory_allocated() if device == "cuda"
                else None)
        found_mods = forbidden_modules()
        if found_mods:
            raise BenchError(f"modules loaded: {found_mods}")
        metrics, breakdown, dev_extra = {}, None, {}
        if trace:
            k = trace_units or traffic["trace_units"]
            state = drv.traced_state()
            cams = drv.traced_cameras(k)
            traced = tr.traced_stretch(drv, k, Path(wd), device)
            work = tr.work_of(drv, config, traffic, state, cams, device)
            del state
            ctx = {"kind": traffic["kind"], "trace": traced, "units": k, "work": work,
                   "window": {"units": units, "seconds": window_s},
                   "spans": spans.result() if spans else {},
                   "setup_seconds": getattr(drv, "setup_seconds", {}),
                   "bounds": load_bounds(root), "peaks": peaks, "log": log,
                   "config": config, "modules": drv.program_modules()}
            for m in layer:
                v = load_reader(m["name"], root)(ctx)
                if v is not None:
                    metrics[m["name"]] = {"value": float(v),
                                          "unit": m["unit"]}
            breakdown = traced["breakdown"]
            dev_extra = {"busy_s": traced["busy_s"],
                         "window_s": traced["window_s"]}
        else:
            values = {"setup_s": setup_s,
                      "peak_mem_gib": (peak or 0) / 2 ** 30}
            if drv.unit == "step":
                values["train_steps_per_s"] = units / window_s
            else:
                values["render_fps"] = units / window_s
                values["render_p95_ms"] = 1e3 * p95(drv.latencies)
            for m in e2e:
                metrics[m["name"]] = {"value": float(values[m["name"]]),
                                      "unit": m["unit"]}
        drv.free()
        check = drv.reference_numbers()
        found_mods = forbidden_modules()
        if found_mods:
            raise BenchError(f"modules loaded: {found_mods}")
    limits = traffic["limits"]
    numbers = check["numbers"]
    checks = {k: {"value": float(numbers[k]), "limit": float(limits[k])}
              for k in numbers}
    failed = sum(1 for v in checks.values() if not v["value"] <= v["limit"])
    device_info = {"platform": "gpu" if device == "cuda" else device,
                   "kind": (torch.cuda.get_device_name(0) if device == "cuda"
                            else "cpu"),
                   "count": cell["chips"], "memory_peak_bytes": peak or 0}
    device_info.update(dev_extra)
    result = {"correct": failed == 0, "attempted": units,
              "failed": failed, "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["detail"] = check.get("detail", {})
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    from .faults import FAULTS
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", default=None,
                    help="run the program's lower-precision path (bf16): "
                    "the check must come out not correct")
    ap.add_argument("--fault", default=None, choices=FAULTS,
                    help="plant a fault under the timed path (the check's "
                    "own readings): the check must come out not correct")
    args = ap.parse_args(argv)
    set_cache_dirs()
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    limit = card_limit()
    if limit:
        print(f"card: {limit}", file=sys.stderr, flush=True)
    try:
        result = run(args.workload, args.seed, args.seconds,
                     bool(args.trace), control=args.control,
                     fault=args.fault,
                     log=lambda *a: print(*a, file=sys.stderr, flush=True))
    except BenchError as e:
        print(f"benchmark: {e}", file=sys.stderr, flush=True)
        return 2
    gc.collect()
    print(json.dumps({"detail": result["detail"]}), file=sys.stderr)
    for k, v in result["checks"].items():
        print(f"check {k} = {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    __package__ = "benchmark"
    importlib.import_module("benchmark")
    sys.exit(main())
