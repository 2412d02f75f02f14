"""Run the port's sharded step in one process per rank on this machine:
the harness the multi-device tests (tests/test_torch_parallel*.py) and
chip_smoke.py use to hold a mesh's step against the single-device one.
It is not part of the package: a user's run goes through
parallel.trainer.ShardedTrainer (the train CLI's mesh flags).

`run_ranks(job, world, workdir)` pickles `job` into `workdir`, starts
`world` processes of `python tests/torch_ranks.py <workdir> <rank> <world>
<host:port>` (a free local port), waits for them, and returns what each
rank wrote (and, under "stdout", what it printed). A job with a "viewer"
key instead runs ShardedTrainer with its live viewer on a clip
(`viewer_rank`, below); `run_viewer_ranks` runs such a job with a client
on a thread of the calling process. A rank joins the process group with the job's backend and does the job's runs in turn, each from the
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

`run_bench_cell` runs a benchmark cell whose driver starts its own ranks
(sg_train_mesh4's) at tiny sizes on the CPU.
"""
from __future__ import annotations

import json
import os
import pickle
import subprocess
import sys
import time
import warnings
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
            results.append({**pickle.load(f), "stdout": outs[r][0]})
    return results


def run_bench_cell(workload: str, seed: int, seconds: float = 1.0,
                   trace: bool = False, fault=None, control=None,
                   timeout: float = 600.0) -> dict:
    """One run of a benchmark cell whose driver starts its own ranks
    (benchmark/drivers/train_mesh4: rank 0 is the run's process, the others
    its children), at the CPU tests' tiny sizes (benchmark/tests/tiny.py),
    in a fresh interpreter: the run's result and the forbidden top-level
    modules loaded once it is done. Raises with the run's stderr."""
    code = (
        "import json, sys; sys.path.insert(0, %r)\n"
        "from benchmark import run as R\n"
        "from benchmark.tests import tiny\n"
        "spec, f = tiny.found(%r)\n"
        "r = R.run(%r, %d, %r, %r, device='cpu', spec=spec, found=f,"
        " trace_units=2, log=lambda *a: None, fault=%r, control=%r)\n"
        "print(json.dumps({'result': r,"
        " 'forbidden': R.forbidden_modules()}))\n") % (
            str(ROOT), workload, workload, seed, seconds, trace, fault,
            control)
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=ROOT, env=env, timeout=timeout)
    if p.returncode != 0:
        raise RuntimeError(f"{workload} exited {p.returncode}:\n"
                           f"{p.stderr[-4000:]}")
    return json.loads(p.stdout.strip().splitlines()[-1])


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


# ---------------------------------------------------------------------------
# The live viewer of a multi-process run.
# ---------------------------------------------------------------------------

PACE_S = 300.0          # how long rank 0 waits for the client's next move


def _wait_for(cond, what: str, timeout: float = PACE_S) -> None:
    deadline = time.time() + timeout
    while not cond():
        if time.time() > deadline:
            raise TimeoutError(f"waited {timeout} s for {what}")
        time.sleep(0.005)


def _write_atomic(path: Path, text: str) -> None:
    tmp = path.with_suffix(".tmp")
    tmp.write_text(text)
    os.replace(tmp, path)


def _launch_counts() -> dict:
    from street_gaussians_ns_tpu_torch.ops import _cuda

    return {k.name: k.launches for k in _cuda.KERNELS}


def _add_counts(into: dict, before: dict) -> None:
    for k, v in _launch_counts().items():
        into[k] = into.get(k, 0) + v - before.get(k, 0)


def viewer_rank(job: dict, rank: int, world: int, coordinator: str,
                workdir: Path) -> dict:
    """One rank of a viewer job: ShardedTrainer(viewer_port=0) on a clip,
    with the harness's pacing and records around its hand-off.

    job["viewer"] keys: "configs" (the four configs of the train CLI, the
    trainer's with viewer_port and output_dir set), "mesh" ((data,
    model)), "steps" (train(steps) while a client asks; 0: no steps, only
    "handoffs" hand-offs), "final_request" (rank 0 waits at the start of
    the last step until a request is parked: one that arrives during the
    final step), "fail_time" (a request at this time raises in rank 0's
    render), "reference" (after each answered request every rank gathers
    the whole train state, gather_state, and rank 0 renders it with the
    single-device Trainer._viewer_render), "swap" (optional: "state" /
    "tracks" arrays under the JAX keys, "config", "render_config", "seed":
    the trainer renders this state instead of its own), "timing"
    (optional: after the client's run, further runs of that many steps
    with no client, the viewer on, then off), "no_save" (skip the
    checkpoints).

    The client (run_viewer_ranks) and rank 0 meet through files in
    workdir: rank 0 writes "viewer_port"; until the client writes
    "client_done", rank 0 waits before each hand-off for a parked request,
    so each request is answered at its own step; rank 0 writes
    "final_step" at the start of the last step."""
    from street_gaussians_ns_tpu_torch.engine import checkpoints
    from street_gaussians_ns_tpu_torch.engine.trainer import Trainer
    from street_gaussians_ns_tpu_torch.parallel import trainer as ptrainer
    from street_gaussians_ns_tpu_torch.utils import viewer as uviewer

    spec = job["viewer"]
    workdir = Path(workdir)
    data, model, tcfg, dm = spec["configs"]
    servers = []
    init = uviewer.ViewerServer.__init__

    def counting_init(self, *a, **kw):
        servers.append(rank)
        init(self, *a, **kw)

    uviewer.ViewerServer.__init__ = counting_init
    gather_ms, gather_bytes = [], []
    gather_store = ptrainer.gather_store

    def timed_gather(store, mesh):
        t = time.perf_counter()
        out = gather_store(store, mesh)
        bg = out.background
        _sync(bg.active.device)
        gather_ms.append(1e3 * (time.perf_counter() - t))
        gather_bytes.append(sum(
            v.numel() * v.element_size()
            for v in [bg.active, *bg.params.as_dict().values()]))
        return out

    ptrainer.gather_store = timed_gather

    rec = {"frames": [], "handoffs": [], "step_s": [], "render_ms": [],
           "step_launches": {}, "frame_launches": {}}
    total = spec["steps"]

    class ViewerRank(ptrainer.ShardedTrainer):
        def _run_step(self, step):
            if (self.viewer is not None and spec.get("final_request")
                    and step == total - 1 and rec.get("phase") == "client"):
                _write_atomic(workdir / "final_step", str(step))
                _wait_for(self.viewer._req_evt.is_set,
                          "a request in the final step")
            before = _launch_counts()
            t = time.perf_counter()
            metrics = super()._run_step(step)
            _sync(self.device)
            rec["step_s"].append((rec.get("phase"),
                                  time.perf_counter() - t))
            _add_counts(rec["step_launches"], before)
            return metrics

        def _service_viewer(self):
            if (self.viewer is not None and rec.get("phase") == "client"
                    and not (workdir / "client_done").exists()):
                _wait_for(lambda: self.viewer._req_evt.is_set()
                          or (workdir / "client_done").exists(),
                          "the client's next request")
            t = time.perf_counter()
            served = super()._service_viewer()
            _sync(self.device)
            rec["handoffs"].append((rec.get("phase"), served,
                                    time.perf_counter() - t))
            if served and spec.get("reference"):
                # Every rank joins the whole state's gather; rank 0 renders
                # it with the single-device Trainer's _viewer_render.
                full = ptrainer.gather_state(self.state, self.mesh)
                frame = rec["frames"][-1] if rec["frames"] else None
                if frame is not None and "reference" not in frame:
                    self.full_state = lambda: full
                    try:
                        frame["reference"] = Trainer._viewer_render(
                            self, frame["c2w"], frame["time"],
                            frame["width"], frame["height"])
                    finally:
                        del self.full_state
            return served

        def _viewer_frame(self, store, c2w, t, width, height):
            if t == spec.get("fail_time"):
                raise RuntimeError("a render that raises (the harness's)")
            floats = []
            viewer_rgb = self.viewer_rgb

            def keep(*a):
                floats.append(viewer_rgb(*a))
                return floats[-1]

            self.viewer_rgb = keep
            before = _launch_counts()
            t0 = time.perf_counter()
            try:
                rgb = super()._viewer_frame(store, c2w, t, width, height)
            finally:
                del self.viewer_rgb
            rec["render_ms"].append(1e3 * (time.perf_counter() - t0))
            _add_counts(rec["frame_launches"], before)
            rec["frames"].append({
                "c2w": np.asarray(c2w), "time": t, "width": width,
                "height": height, "rgb8": rgb, "rgb": floats[0].cpu().numpy(),
                "step": int(self.state.step)})
            return rgb

        def save(self, step):
            if spec.get("no_save"):
                return None
            return super().save(step)

    trainer = ViewerRank(data, model, tcfg, dm, mesh_data=spec["mesh"][0],
                         mesh_model=spec["mesh"][1], coordinator=coordinator,
                         num_processes=world, process_id=rank,
                         backend=job["backend"], device=job["device"])
    dev = trainer.device
    if spec.get("swap"):
        sw = spec["swap"]
        trainer.config = sw["config"]
        trainer.render_config = sw["render_config"]
        trainer.state = ptrainer.place_state(
            checkpoints.train_state_from_numpy(sw["state"], sw["config"],
                                               device=dev, seed=sw["seed"]),
            trainer.mesh)
        trainer.tracks = checkpoints.tracks_from_numpy(sw["tracks"],
                                                       device=dev)
    if trainer.viewer is not None:
        _write_atomic(workdir / "viewer_port", str(trainer.viewer.port))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = _viewer_runs(trainer, spec, rec, total)
    rec["overflow"] = [str(w.message) for w in caught
                       if "capacity overflow" in str(w.message)]
    out.update(servers=servers, gather_ms=gather_ms,
               gather_bytes=gather_bytes, launches=_launch_counts())
    if trainer.device.type == "cuda":
        out["peak_memory"] = torch.cuda.max_memory_allocated(trainer.device)
    rec.pop("phase", None)
    return {**out, **rec}


def _viewer_runs(trainer, spec: dict, rec: dict, total: int) -> dict:
    """The runs of a viewer job on one rank: the client's (train(total),
    or spec["handoffs"] hand-offs), a request parked too late (rank 0),
    then spec["timing"] steps with the viewer on and as many with it off,
    no client."""
    import dataclasses

    rec["phase"] = "client"
    t = time.perf_counter()
    if total:
        trainer.train(total)
    else:
        for _ in range(spec["handoffs"]):
            trainer._service_viewer()
    _sync(trainer.device)
    rec["client_run_s"] = time.perf_counter() - t
    out = {"port": trainer.viewer.port if trainer.viewer else None,
           "step": int(trainer.state.step)}
    if trainer.viewer is not None:
        # A request parked after the last hand-off is never taken: its
        # client's wait runs out (1 s here; the HTTP client's is 60 s).
        t = time.perf_counter()
        out["late_request"] = trainer.viewer._request_frame(
            np.eye(3, 4, dtype=np.float32), 0.0, "low", timeout=1.0)
        out["late_request_s"] = time.perf_counter() - t
    if spec.get("timing"):
        n = int(spec["timing"])
        for phase, port in (("on", trainer.tc.viewer_port), ("off", None)):
            if port is None and trainer.viewer is not None:
                trainer.viewer.close()
                trainer.viewer = None
            trainer.tc = dataclasses.replace(trainer.tc, viewer_port=port)
            rec["phase"] = phase
            trainer.start_step = int(trainer.state.step)
            trainer.train(trainer.start_step + n)
    if trainer.viewer is not None:
        trainer.viewer.close()
    return out


def _sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def _http_frame(port: int, c2w, t: float, res: str, timeout: float = 300):
    """GET /frame -> (status, body, seconds on this clock)."""
    import urllib.error
    import urllib.parse
    import urllib.request

    q = urllib.parse.urlencode({
        "c2w": ",".join(repr(float(v)) for v in np.asarray(c2w).reshape(-1)),
        "time": repr(float(t)), "res": res})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/frame?{q}",
                                    timeout=timeout) as r:
            code, body = r.status, r.read()
    except urllib.error.HTTPError as e:
        code, body = e.code, e.read()
    return code, body, time.perf_counter() - t0


def _http_json(port: int, path: str):
    import json
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=60) as r:
        return json.loads(r.read())


def viewer_client(workdir: Path, requests, final=None, got=None) -> dict:
    """The client of a viewer job: once rank 0 has written its port, each
    of `requests` ((c2w, time, res)) in turn, then /state; "client_done";
    then, once rank 0 is in its final step, the `final` request. Fills
    and returns `got`: "port", "answers" [(status, body, seconds, /state
    after it)], "final" (status, body, seconds)."""
    workdir = Path(workdir)
    got = {} if got is None else got
    _wait_for((workdir / "viewer_port").exists, "rank 0's port", 600)
    port = int((workdir / "viewer_port").read_text())
    got["port"] = port
    got["answers"] = []
    for c2w, t, res in requests:
        code, body, s = _http_frame(port, c2w, t, res)
        got["answers"].append((code, body, s, _http_json(port, "/state")))
    _write_atomic(workdir / "client_done", "1")
    if final is not None:
        _wait_for((workdir / "final_step").exists, "the final step", 600)
        got["final"] = _http_frame(port, *final)
    return got


def run_viewer_ranks(job: dict, world: int, workdir: Path, requests,
                     final=None, timeout: float = 900.0):
    """run_ranks of a viewer job while viewer_client runs on a thread of
    this process; returns (ranks' results, the client's record). A rank
    that hangs past `timeout` is killed and raises here."""
    import threading

    got = {}
    err = []

    def client():
        try:
            viewer_client(workdir, requests, final, got)
        except BaseException as e:       # reported after the ranks end
            err.append(e)

    th = threading.Thread(target=client, daemon=True)
    th.start()
    ranks = run_ranks(job, world, workdir, timeout=timeout)
    th.join(timeout=60)
    if err:
        raise err[0]
    if th.is_alive():
        raise RuntimeError("the viewer client did not finish")
    return ranks, got


def rank_main(workdir: Path, rank: int, world: int, coordinator: str):
    """One rank of run_ranks: join, do the job's runs (or its viewer run),
    write rank<r>.pkl."""
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
    if "viewer" in job:
        out = {"rank": rank, **viewer_rank(job, rank, world, coordinator,
                                           workdir)}
    else:
        keys = tuple(job.get("state_keys") or ("",))
        results = []
        for run in job["runs"]:
            res, full = _run_one(job, run, rank)
            res["state"] = {k: v for k, v in full.items()
                            if k.startswith(keys)}
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
