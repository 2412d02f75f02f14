"""Scene-graph training on a (rows, 1) mesh, one rank a card, through
`parallel.trainer.ShardedTrainer`: the data axis's gradient collectives.

Rank 0 is the harness's process. Its set-up writes sg_train_s3600's clip
and step-3601 checkpoint (drivers.train_scene_graph: the store made from
the seed, zero Adam moments, the generator and the sampler), then starts
ranks 1 to rows - 1 as processes of this module,

    python -m benchmark.drivers.train_mesh4 <workdir>/ranks.json <rank>

and every rank builds ShardedTrainer(mesh_data=rows, mesh_model=1) on
cuda:<rank> over NCCL (gloo and the CPU in the tests), each resuming the
same checkpoint. A step takes `rows` images from the datamanager, one a
rank, every rank drawing the same ones; the loss is the mean over the
rows and the gradients are all-reduced over them. Every rank makes the
same set-up calls: the `check_steps` iterations the reference follows,
a refine pass (its result dropped) and the capacity check. Then ranks 1
to rows - 1 follow rank 0 step for step: before each of its steps rank 0
broadcasts a 4-byte order (step or stop) over the default group, the one
collective the cell adds to the step's own.

At the end (`free`) rank 0 orders the stop and gathers every rank's peak
of allocated memory: it logs them and raises if one is more than
`peak_tolerance` above its own. Every rank holds the same replica and does
the same work, so rank 0's own peak, which run.py reads, is the cell's.
A rank that exits before the stop ends rank 0 at once, its log's tail on
standard error; a rank whose parent dies is killed with it. Each rank
checks the modules it loaded, as run.py does.

A fault that run.py plants (--fault) in the single-device step is planted
in the sharded step of every rank: the sharded step calls neither
`engine.trainer.scene_train_step` nor `engine.scene_train_step.
scene_loss_dict`, where faults.planted puts it.

The reference (reference/train_rows.py) follows the same steps: each
step's loss the mean over the same images, the sky jitter drawn from the
same generator in row order.
"""
from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

from .. import scene
from ..reference import train_rows
from . import train_scene_graph
from .common import Snapshot, first_grad_norms

ROOT = Path(__file__).resolve().parents[2]
STEP, STOP = 1, 0
JOIN_S = 120.0            # how long rank 0 waits for a rank to exit


def planted_faults() -> list:
    """The faults faults.planted put in the single-device step."""
    from street_gaussians_ns_tpu_torch.engine import scene_train_step as sts
    from street_gaussians_ns_tpu_torch.engine import trainer as tm
    from street_gaussians_ns_tpu_torch.models import scene_graph as sgm
    out = []
    if tm.scene_train_step is not sts.scene_train_step:
        out.append("unchanged")
    if sts.scene_loss_dict is not sgm.scene_loss_dict:
        out.append("half_batch")
    return out


def plant(names: list) -> None:
    """The same faults in the sharded step of this rank."""
    from street_gaussians_ns_tpu_torch.parallel import sharded
    from street_gaussians_ns_tpu_torch.parallel import trainer as ptr

    from .. import faults
    if "half_batch" in names:
        sharded.scene_loss_dict = faults._half_rows(sharded.scene_loss_dict)
    if "unchanged" in names:
        make = ptr.make_sharded_train_step

        def unchanged(*a, **kw):
            return faults._unchanged(make(*a, **kw))
        ptr.make_sharded_train_step = unchanged


def build_trainer(spec: dict, rank: int):
    """This rank's ShardedTrainer on the clip and checkpoint in the
    work directory."""
    from street_gaussians_ns_tpu_torch.data.datamanager import \
        DataManagerConfig
    from street_gaussians_ns_tpu_torch.data.dataparser import \
        DataParserConfig
    from street_gaussians_ns_tpu_torch.engine.trainer import TrainerConfig
    from street_gaussians_ns_tpu_torch.models.scene_graph import \
        SceneGraphConfig
    from street_gaussians_ns_tpu_torch.models.splatfacto import \
        SplatfactoConfig
    from street_gaussians_ns_tpu_torch.parallel.trainer import ShardedTrainer

    cfg, wd = spec["cfg"], Path(spec["workdir"])
    sg = SceneGraphConfig(base=SplatfactoConfig(
        use_sky_sphere=True, sh_degree=cfg["sh_degree"],
        env_map_res=cfg["env_map_res"]))
    return ShardedTrainer(
        DataParserConfig(data=wd / "clip", orientation_method="none",
                         center_method="none", auto_scale_poses=False),
        sg,
        TrainerConfig(output_dir=wd / "run", resume=True,
                      seed=spec["seed"] % (2 ** 31),
                      background_capacity=cfg["background_capacity"],
                      object_capacity=cfg["object_capacity"],
                      render_precision=spec["control"] or "auto"),
        DataManagerConfig(cache_workers=4), device=spec["device"],
        mesh_data=spec["rows"], mesh_model=1,
        coordinator=spec["coordinator"], num_processes=spec["rows"],
        process_id=rank, backend=spec["backend"])


def prepare(t, check_steps: int, record=None) -> int:
    """The set-up calls every rank makes in one order: the steps the
    reference follows (record(i, metrics) after each), a refine pass whose
    result is dropped and the capacity check. Returns the next step."""
    step = t.start_step
    for i in range(check_steps):
        m = t._iteration(step)
        step += 1
        if record is not None:
            record(i, m)
    t._refine(max(*t._last_hw))
    t._maybe_grow_pairs({})
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)
    return step


def order_tensor(t) -> torch.Tensor:
    """The 4-byte order rank 0 broadcasts: on the card for NCCL, on the
    host for gloo."""
    import torch.distributed as dist
    dev = t.mesh.device if dist.get_backend() == "nccl" else "cpu"
    return torch.zeros((1,), dtype=torch.int32, device=dev)


def gather_peaks(t) -> list:
    """Every rank's peak of allocated memory, in bytes, in rank order (0
    off the card); every rank must call it."""
    import torch.distributed as dist
    peak = (torch.cuda.max_memory_allocated(t.device)
            if t.device.type == "cuda" else 0)
    x = order_tensor(t).new_tensor([peak], dtype=torch.float64)
    out = [torch.zeros_like(x) for _ in range(dist.get_world_size())]
    dist.all_gather(out, x)
    return [int(v.item()) for v in out]


class Driver(train_scene_graph.Driver):
    unit = "step"

    def setup(self):
        from street_gaussians_ns_tpu_torch.engine import trainer as tm
        from street_gaussians_ns_tpu_torch.parallel.collectives import \
            broadcast
        from street_gaussians_ns_tpu_torch.parallel.mesh import free_port

        self.tm, self.broadcast = tm, broadcast
        cfg, tr = self.cfg, self.traffic
        self.rows = tr["rows"]
        self.procs, self.stopping, self.trainer = [], False, None
        if self.device == "cuda":
            from street_gaussians_ns_tpu_torch.ops import _cuda
            _cuda.build_all()       # once, before the ranks start
        self._write_inputs()
        faults = planted_faults()
        spec = {"cfg": cfg, "seed": self.seed, "device": self.device,
                "control": self.control, "rows": self.rows,
                "backend": tr.get("backend") if self.device == "cuda"
                else "gloo",
                "coordinator": f"127.0.0.1:{free_port()}",
                "workdir": str(self.workdir), "faults": faults,
                "check_steps": tr["check_steps"], "parent": os.getpid()}
        path = self.workdir / "ranks.json"
        path.write_text(json.dumps(spec))
        self._start_ranks(path)
        plant(faults)
        self.trainer = t = build_trainer(spec, 0)
        if list(t.scene.train_indices) != list(self.train_frames):
            raise RuntimeError(f"train split {list(t.scene.train_indices)}")
        self.check_draws = self._next_frames(tr["check_steps"] * self.rows)
        snap = Snapshot()

        def record(i, m):
            snap.losses.append(m["loss"])
            if i == 0:
                snap.first_grad = first_grad_norms(
                    train_scene_graph._moments(t.state))
        self.step = prepare(t, tr["check_steps"], record)
        p3 = train_scene_graph._params(t.state)
        snap.change = {k: torch.linalg.vector_norm(p3[k] - self.p0[k])
                       for k in snap.first_grad}
        self.snap = snap.to_host()
        del self.p0, p3
        self.order = order_tensor(t)
        self.setup_seconds = dict(t.setup_seconds)

    def _start_ranks(self, spec_path: Path):
        env = {**os.environ,
               "PYTHONPATH": os.pathsep.join(
                   [str(ROOT)] + [p for p in os.environ.get(
                       "PYTHONPATH", "").split(os.pathsep) if p])}
        for r in range(1, self.rows):
            log = open(self.workdir / f"rank{r}.log", "w")
            self.procs.append((r, log, subprocess.Popen(
                [sys.executable, "-m", "benchmark.drivers.train_mesh4",
                 str(spec_path), str(r)], cwd=ROOT, env=env,
                stdout=log, stderr=subprocess.STDOUT)))
        threading.Thread(target=self._watch, daemon=True).start()

    def _log_tail(self, r: int) -> str:
        text = (self.workdir / f"rank{r}.log").read_text(errors="replace")
        return text[-4000:]

    def _watch(self):
        """End this process at once when a rank exits before the stop: a
        collective with a dead rank would otherwise wait for its time
        limit."""
        while not self.stopping:
            for r, _, p in self.procs:
                if p.poll() is not None and not self.stopping:
                    sys.stderr.write(f"rank {r} exited {p.returncode} before "
                                     f"the stop:\n{self._log_tail(r)}\n")
                    sys.stderr.flush()
                    os._exit(1)
            time.sleep(0.5)

    def _next_frames(self, n: int) -> list:
        """The next n frames the datamanager draws, read without drawing
        from it (its epoch order, reshuffled by its RandomState when it
        runs out)."""
        dm = self.trainer.dm
        order = list(dm._train_order)
        rng = np.random.RandomState()
        rng.set_state(dm.rng.get_state())
        out = []
        for _ in range(n):
            if not order:
                order = list(dm.scene.train_indices)
                rng.shuffle(order)
            out.append(int(order.pop()))
        return out

    def run_unit(self):
        self.order.fill_(STEP)
        self.broadcast(self.order)
        self.trainer._iteration(self.step)
        self.step += 1

    def traced_cameras(self, n: int):
        """Rank 0's cameras of the next n steps (one of each step's rows)."""
        frames = self._next_frames(n * self.rows)
        return [self._cam(f) for f in frames[::self.rows]]

    def free(self):
        """Order the stop, gather the ranks' peaks, let the ranks exit."""
        import torch.distributed as dist
        t = self.trainer
        if t is not None and not self.stopping:
            self.order.fill_(STOP)
            self.broadcast(self.order)
            peaks = gather_peaks(t)
            self.stopping = True
            dist.barrier()
            dist.destroy_process_group()
            self._join()
            self.peaks = peaks
            sys.stderr.write("rank peaks (GiB): " + ", ".join(
                f"{p / 2 ** 30:.5f}" for p in peaks) + "\n")
            tol = self.traffic["peak_tolerance"]
            over = [r for r, p in enumerate(peaks) if p > peaks[0] * (1 + tol)]
            if over:
                raise RuntimeError(
                    f"ranks {over} peaked more than {tol:.0%} above rank 0: "
                    f"{peaks}")
        super().free()

    def _join(self):
        bad = []
        for r, log, p in self.procs:
            try:
                p.wait(timeout=JOIN_S)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
            log.close()
            if p.returncode != 0:
                bad.append(f"rank {r} exited {p.returncode}:\n"
                           f"{self._log_tail(r)}")
        if bad:
            raise RuntimeError("\n".join(bad))

    def reference_numbers(self):
        """The reference's steps over the same images, each step's loss the
        mean over its rows."""
        tr, dev, R = self.traffic, self.device, self.rows
        sc = scene.make_scene(self.seed, self.cfg, dev)
        imgs = scene.target_images(self.seed, self.cfg["track_frames"],
                                   tr["width"], tr["height"],
                                   tr["image_block"], dev)
        sem = scene.semantic_map(tr["width"], tr["height"], dev)
        gen = scene.generator(self.seed ^ 0x7A11, dev)
        steps = []
        for i in range(tr["check_steps"]):
            rows = []
            for f in self.check_draws[i * R:(i + 1) * R]:
                jitter = torch.rand((2, tr["height"], tr["width"]),
                                    generator=gen, device=dev)
                rows.append((self._cam(f), imgs[f], sem, jitter))
            steps.append((tr["start_step"] + i, rows))
        ref = train_rows.reference_steps(sc, self.tracks, steps,
                                         self.cfg["sh_degree"])
        out = train_rows.compare(self.snap, ref)
        out["detail"]["frames"] = self.check_draws
        out["detail"]["peaks_gib"] = [round(p / 2 ** 30, 5)
                                      for p in self.peaks]
        return out


def rank_main(spec_path: str, rank: int) -> int:
    """Ranks 1 to rows - 1: build, make the set-up calls, follow rank 0's
    orders, give the peak, check the modules."""
    import ctypes

    import torch.distributed as dist

    from benchmark import run as R
    from street_gaussians_ns_tpu_torch.parallel.collectives import broadcast

    spec = json.loads(Path(spec_path).read_text())
    # Die with rank 0 (PR_SET_PDEATHSIG), and not outlive it if it is
    # already gone.
    ctypes.CDLL(None, use_errno=True).prctl(1, signal.SIGKILL)
    if os.getppid() != spec["parent"]:
        return 1
    R.block_optional_imports()
    plant(spec["faults"])
    t = build_trainer(spec, rank)
    step = prepare(t, spec["check_steps"])
    order = order_tensor(t)
    while True:
        broadcast(order)
        if int(order.item()) == STOP:
            break
        t._iteration(step)
        step += 1
    gather_peaks(t)
    dist.barrier()
    dist.destroy_process_group()
    found = R.forbidden_modules()
    if found:
        print(f"modules loaded: {found}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(rank_main(sys.argv[1], int(sys.argv[2])))
