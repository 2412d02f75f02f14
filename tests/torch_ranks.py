"""Run the port's sharded step in one process per rank on this machine:
the harness the multi-device tests (tests/test_torch_parallel*.py) and
chip_smoke.py use to hold a mesh's step against the single-device one.
It is not part of the package: a user's run goes through
parallel.trainer.ShardedTrainer (the train CLI's mesh flags).

`run_ranks(job, world, workdir)` pickles `job` into `workdir`, starts
`world` processes of `python tests/torch_ranks.py <workdir> <rank> <world>
<host:port>` (a free local port), waits for them, and returns what each
rank wrote. A rank joins the process group with the job's backend and does the job's runs in turn, each from the
job's state: it builds the run's mesh, places its shard and takes the
run's steps (each followed by a refine pass when the run has `refine`)
with the job's cameras, batches and jitters; it writes its metrics of
every step, the gathered state's arrays under the JAX checkpoint keys
and its kernels' launches.

job keys: "state" (a train state's arrays under the JAX checkpoint
keys), "tracks" (arrays), "config" (SceneGraphConfig), "backend" ("gloo"
| "nccl"), "device" ("cpu" | "cuda": every rank on cuda:<rank mod
cards>), "cam_b" / "batch_b" (numpy arrays as stack_cameras /
stack_batches lay them out, a row per data row of the largest mesh),
"jitters" ((steps, rows, 2, H, W) or None: drawn from the state's
generator), "width", "height", "step" (the step counter to start from),
"subset_accs", "seed", "runs" (a list of {"data", "model",
"render_config", "steps", "refine": num_train_data or None, "frames":
keep the merged frames}); optionally "build" = (module, function,
kwargs), which makes the state and inputs on every rank instead of the
pickle (the full-width scene is too large to pickle), and "state_keys",
the prefixes of the state's keys to write (all when absent).
"""
from __future__ import annotations

import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from street_gaussians_ns_tpu_torch.parallel.mesh import free_port  # noqa: E402


def run_ranks(job: dict, world: int, workdir: Path,
              timeout: float = 900.0) -> list:
    """Run `job` in `world` processes; returns each rank's result dict
    (rank order). Raises with the failing rank's stderr."""
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    with open(workdir / "job.pkl", "wb") as f:
        pickle.dump(job, f)
    coordinator = f"127.0.0.1:{free_port()}"
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), str(workdir), str(r),
         str(world), coordinator],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    deadline = time.time() + timeout
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(deadline - time.time(),
                                                  1.0)))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, (_, err)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"rank {r} exited {p.returncode}:\n"
                               f"{err[-4000:]}")
    results = []
    for r in range(world):
        with open(workdir / f"rank{r}.pkl", "rb") as f:
            results.append(pickle.load(f))
    return results


def _host(v):
    """A metric on the host: 0-d -> float, else a numpy array."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        return float(v) if v.dim() == 0 else v.numpy()
    return float(v)


def _run_one(job: dict, run: dict, rank: int):
    """One run of a job on this rank: (result dict, the gathered state's
    arrays)."""
    import dataclasses

    from street_gaussians_ns_tpu_torch.engine import checkpoints
    from street_gaussians_ns_tpu_torch.parallel.mesh import make_mesh
    from street_gaussians_ns_tpu_torch.parallel.sharded import (
        make_sharded_train_step)
    from street_gaussians_ns_tpu_torch.parallel.trainer import (
        gather_state, make_sharded_refine_step, mesh_device, place_state)

    dev = mesh_device(job["device"], rank)
    mesh = make_mesh(run["data"], run["model"], device=dev)
    cfg, rcfg = job["config"], run["render_config"]
    state = checkpoints.train_state_from_numpy(job["state"], cfg, device=dev,
                                               seed=job["seed"])
    state = dataclasses.replace(state, step=int(job["step"]))
    cap_bg = state.store.background.capacity
    tracks = checkpoints.tracks_from_numpy(job["tracks"], device=dev)
    state = place_state(state, mesh)
    fn = make_sharded_train_step(mesh, cfg, rcfg, job["width"],
                                 job["height"], cap_bg,
                                 subset_accs=job["subset_accs"])
    refine = (make_sharded_refine_step(mesh, cfg, run["refine"])
              if run.get("refine") is not None else None)
    rows = slice(0, run["data"])
    cam_b = {k: torch.from_numpy(np.asarray(v)[rows]).to(dev)
             for k, v in job["cam_b"].items()}
    batch_b = {k: torch.from_numpy(np.asarray(v)[rows]).to(dev)
               for k, v in job["batch_b"].items()}
    metrics, seconds = [], []
    for s in range(run["steps"]):
        jit = None
        if job.get("jitters") is not None:
            jit = torch.from_numpy(np.asarray(job["jitters"][s])[rows]).to(
                dev)
        t0 = time.perf_counter()
        state, m = fn(state, tracks, cam_b, batch_b, jitters=jit)
        if refine is not None:
            state, _ = refine(state, max(job["width"], job["height"]))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        seconds.append(time.perf_counter() - t0)
        keep = run.get("frames", False)
        metrics.append({k: _host(v) for k, v in m.items()
                        if keep or not k.startswith("frame_")})
    full = checkpoints.state_to_numpy(gather_state(state, mesh))
    return {"row": mesh.row, "col": mesh.col, "metrics": metrics,
            "seconds": seconds}, full


def rank_main(workdir: Path, rank: int, world: int, coordinator: str):
    """One rank of run_ranks: join, do the job's runs, write
    rank<r>.pkl."""
    import importlib

    import torch.distributed as dist

    from street_gaussians_ns_tpu_torch.ops import _cuda
    from street_gaussians_ns_tpu_torch.parallel.mesh import multihost_init
    from street_gaussians_ns_tpu_torch.parallel.trainer import mesh_device

    torch.set_num_threads(1)
    with open(Path(workdir) / "job.pkl", "rb") as f:
        job = pickle.load(f)
    if "build" in job:
        module, name, kwargs = job["build"]
        job = {**job, **getattr(importlib.import_module(module), name)(
            **kwargs)}
    multihost_init(coordinator, world, rank, job["backend"])
    dev = mesh_device(job["device"], rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    for k in _cuda.KERNELS:
        k.reset_launches()
    keys = tuple(job.get("state_keys") or ("",))
    results = []
    for run in job["runs"]:
        res, full = _run_one(job, run, rank)
        res["state"] = {k: v for k, v in full.items() if k.startswith(keys)}
        results.append(res)
    out = {"rank": rank, "runs": results,
           "launches": {k.name: k.launches for k in _cuda.KERNELS}}
    with open(Path(workdir) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    rank_main(Path(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
              sys.argv[4])
