"""Tiny sizes of the cells for the CPU tests: the same drivers, the same
program and reference, a scene of 2,048 background slots and two vehicles
of 256, 64x48 cameras."""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

from benchmark import run as R

ROOT = R.ROOT
SEED = 12345678901          # above 2**32: the run takes large seeds


def shrink(config: dict, traffic: dict) -> None:
    config.update(background_capacity=2048,
                  object_capacity=256 if config["objects"] else 0,
                  objects=min(config["objects"], 2), env_map_res=16,
                  track_frames=4, seed_points=1500,
                  lidar_points_per_object=10001)
    traffic.update(width=64, height=48, focal=48.0)
    if "image_block" in traffic:
        traffic["image_block"] = 8
    if "poses" in traffic:
        traffic.update(poses=6, sample_from=1, check_frames=1)
    if "cameras" in traffic:
        traffic["cameras"] = 3


def found(workload: str, root: Path = ROOT) -> tuple:
    spec = R.load_spec(root)
    f = R.find_cell(spec, workload, root)
    shrink(f["config"], f["traffic"])
    return spec, f


def run(workload: str, trace: bool = False, seed: int = SEED,
        root: Path = ROOT, **kw) -> dict:
    spec, f = found(workload, root)
    return R.run(workload, seed, 1.0, trace, device="cpu", spec=spec,
                 found=f, trace_units=2, root=root, log=lambda *a: None,
                 **kw)


def run_in_subprocess(workload: str, trace: bool = False) -> dict:
    """A tiny CPU run in a fresh interpreter: its result and the forbidden
    top-level modules loaded once it is done."""
    code = (
        "import json, sys; sys.path.insert(0, %r)\n"
        "from benchmark.tests import tiny\n"
        "from benchmark import run as R\n"
        "r = tiny.run(%r, %r)\n"
        "print(json.dumps({'keys': list(r), 'result': r,"
        " 'forbidden': R.forbidden_modules()}))\n") % (
            str(ROOT), workload, trace)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=ROOT, timeout=600)
    assert p.returncode == 0, p.stderr[-4000:]
    return json.loads(p.stdout.strip().splitlines()[-1])
