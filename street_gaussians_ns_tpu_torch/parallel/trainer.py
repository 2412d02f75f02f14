"""The multi-device trainer (counterpart of
street_gaussians_ns_tpu/parallel/trainer.py: `place_state`,
`make_sharded_refine_step`, `ShardedTrainer`).

`ShardedTrainer` is `engine.trainer.Trainer` with its step replaced by the
sharded step (parallel.sharded) on this rank's place in the (data, model)
mesh; the host loop (refine cadence, pair-capacity growth, evaluation,
checkpoints) is Trainer.train, so the two cannot drift. Every rank builds
the same full state from the same seed, then keeps its shard
(`place_state`). A step takes `data` cameras from the datamanager, every
rank the same draws in the same order, and each rank trains on its row's.
The pair-capacity growth reads the count maxed over every rank, so every
rank grows at the same step.

Refinement gathers the shards, runs `scene_refine_step` on every rank
alike (the generators are equal, so the split noise is), and keeps the
local rows again: the single-device refine, which is what the JAX
package's GSPMD-partitioned refine computes. Checkpoints hold the
gathered state under the JAX keys, written by rank 0, so the JAX package,
the single-device port and a sharded run of any mesh can each restore
them; a restore gives every rank its shard. Evaluation renders the
gathered state on every rank. Ranks other than 0 log into
`<output_dir>/rank<r>/`.

The live viewer (`viewer_port`) is served by rank 0 alone: only rank 0
binds the port and logs its URL. After every step each rank runs the same
hand-off (`_service_viewer`): rank 0 takes the parked request, or none,
and broadcasts it as 16 float64 numbers over the default group; on a
request the ranks of row 0 gather the store a frame reads (`gather_store`:
the background's parameters and active mask, not its statistics or Adam
moments) and rank 0 renders it as the single-device `Trainer` does and
answers. Each step with the viewer on therefore pays one small broadcast;
with it off the hand-off makes no call. A request parked during the last
step is answered in that step's hand-off; one parked after it is never
taken, and its client gets the viewer's 503 when its 60 s wait runs out.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..data.datamanager import DataManagerConfig
from ..data.dataparser import DataParserConfig
from ..engine.scene_train_step import SceneTrainState, scene_refine_step
from ..engine.trainer import Trainer, TrainerConfig, viewer_uint8
from ..models.gaussians import GaussianStore
from ..models.scene_graph import SceneGraphConfig, SceneGraphStore
from .collectives import broadcast, gather_tiled
from .mesh import Mesh, make_mesh, multihost_init
from .sharded import make_sharded_train_step, stack_batches, stack_cameras


def _map_background(state: SceneTrainState, fn) -> SceneTrainState:
    """fn applied to every leaf whose leading axis is the background
    capacity: the background store's parameters, mask and statistics and
    the "bg" entries of the Gaussian groups' Adam moments."""
    bg = state.store.background
    new_bg = GaussianStore(
        params=dataclasses.replace(bg.params, **{
            k: fn(v) for k, v in bg.params.as_dict().items()}),
        active=fn(bg.active), xys_grad_norm=fn(bg.xys_grad_norm),
        vis_counts=fn(bg.vis_counts), max_2dsize=fn(bg.max_2dsize))
    opt = {}
    for name, s in state.opt.items():
        if isinstance(s.mu, dict) and "bg" in s.mu:
            s = dataclasses.replace(
                s, mu={**s.mu, "bg": fn(s.mu["bg"])},
                nu={**s.nu, "bg": fn(s.nu["bg"])},
                acc=(None if s.acc is None
                     else {**s.acc, "bg": fn(s.acc["bg"])}))
        opt[name] = s
    return dataclasses.replace(
        state, store=dataclasses.replace(state.store, background=new_bg),
        opt=opt)


def place_state(state: SceneTrainState, mesh: Mesh) -> SceneTrainState:
    """This rank's shard of a full state: its model column's rows of every
    background-capacity leaf; everything else stays whole (replicated)."""
    cap = state.store.background.capacity
    if cap % mesh.model:
        raise ValueError(f"background capacity {cap} must divide the model "
                         f"axis {mesh.model}")
    n = cap // mesh.model
    lo = mesh.col * n
    return _map_background(state, lambda x: x[lo:lo + n].contiguous())


def gather_state(state: SceneTrainState, mesh: Mesh) -> SceneTrainState:
    """The full state from the shards of a model group (every rank of the
    group must call it)."""
    return _map_background(state, lambda x: gather_tiled(x, mesh.model_group))


def gather_store(store: SceneGraphStore, mesh: Mesh) -> SceneGraphStore:
    """The store a render reads, from the shards of a model group (every
    rank of the group must call it): the background's parameters and
    active mask gathered. Its statistics are None: no render reads them,
    and neither they nor the Adam moments cross the wire."""
    bg = store.background
    gathered = GaussianStore(
        params=dataclasses.replace(bg.params, **{
            k: gather_tiled(v, mesh.model_group)
            for k, v in bg.params.as_dict().items()}),
        active=gather_tiled(bg.active, mesh.model_group),
        xys_grad_norm=None, vis_counts=None, max_2dsize=None)
    return dataclasses.replace(store, background=gathered)


VIEWER_MESSAGE = 16     # [has_request, c2w (12), t, width, height]


def viewer_message(req: Optional[dict]) -> torch.Tensor:
    """A taken viewer request (utils.viewer.ViewerServer.take) or None as
    the (16,) float64 tensor rank 0 broadcasts: float64 carries the
    float32 pose, the time and the ladder size exactly."""
    msg = np.zeros(VIEWER_MESSAGE, np.float64)
    if req is not None:
        msg[0] = 1.0
        msg[1:13] = np.asarray(req["c2w"], np.float64).reshape(-1)
        msg[13:16] = (req["time"], req["width"], req["height"])
    return torch.from_numpy(msg)


def make_sharded_refine_step(mesh: Mesh, config, num_train_data: int):
    """refine(state, max_hw) -> (state, info) over the shards: gather,
    scene_refine_step on the full state (the same on every rank), keep the
    local rows."""
    def refine(state: SceneTrainState, max_hw: int):
        full, info = scene_refine_step(gather_state(state, mesh), config,
                                       num_train_data, max_hw)
        return place_state(full, mesh), info

    return refine


def mesh_device(device, rank: int):
    """The CUDA device of a rank: "cuda" means cuda:<rank mod cards>
    (ranks beyond the cards share them); another device is used as given."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and torch.cuda.is_available():
        return torch.device("cuda", rank % torch.cuda.device_count())
    return dev


class ShardedTrainer(Trainer):
    """Trainer whose inner step is the sharded step of this rank. Only the
    step, the refine, evaluation's state, the checkpoint writer and the
    viewer's hand-off are replaced."""

    def __init__(self, data_config: DataParserConfig,
                 scene_config: SceneGraphConfig = SceneGraphConfig(),
                 trainer_config: TrainerConfig = TrainerConfig(),
                 dm_config: DataManagerConfig = DataManagerConfig(),
                 device="cuda", *, mesh_data: Optional[int] = None,
                 mesh_model: Optional[int] = None,
                 coordinator: Optional[str] = None,
                 num_processes: Optional[int] = None,
                 process_id: Optional[int] = None,
                 backend: Optional[str] = None):
        if backend is None:
            backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
        multihost_init(coordinator, num_processes, process_id, backend)
        rank = dist.get_rank()
        device = mesh_device(device, rank)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        self.mesh = make_mesh(data=mesh_data, model=mesh_model, device=device)
        self.primary = rank == 0
        self.log_dir_name = f"rank{rank}"
        super().__init__(data_config, scene_config, trainer_config, dm_config,
                         device=device)
        self.cap_bg = self.state.store.background.capacity
        self.state = place_state(self.state, self.mesh)
        self._refine_fn = make_sharded_refine_step(self.mesh, self.config,
                                                   self.dm.num_train)
        self._sstep = {}

    def _sharded_step_fn(self, width: int, height: int, step: int):
        subset_accs = (self.config.object_acc_entropy_loss_mult > 0
                       and step > self.config.background.stop_split_at)
        key = (width, height, subset_accs, self.render_config)
        if key not in self._sstep:
            self._sstep[key] = make_sharded_train_step(
                self.mesh, self.config, self.render_config, width, height,
                cap_bg=self.cap_bg, subset_accs=subset_accs)
        return self._sstep[key]

    def _run_step(self, step: int):
        cams, batches = [], []
        for _ in range(self.mesh.data):
            camera, batch = self.dm.next_train(step)
            cams.append(camera)
            batches.append(self._device_batch(batch))
        h, w = cams[0].height, cams[0].width
        fn = self._sharded_step_fn(w, h, step)
        self.state, metrics = fn(self.state, self.tracks,
                                 stack_cameras(cams),
                                 stack_batches(batches, h, w))
        self._last_hw = (h, w)
        return metrics

    def _refine(self, max_hw: int):
        return self._refine_fn(self.state, max_hw)

    def _service_viewer(self) -> bool:
        """The viewer hand-off after every step, on every rank (module
        docstring). Rank 0 renders after the gather, so a render that
        raises there (answered 503, named in /state) leaves no rank inside
        a collective. Returns whether a request was answered."""
        if self.tc.viewer_port is None:
            return False
        req = self.viewer.take() if self.viewer is not None else None
        msg = viewer_message(req)
        if dist.get_backend() != "gloo":
            msg = msg.to(self.mesh.device)
        if float(broadcast(msg)[0]) == 0.0:
            return False
        store = (gather_store(self.state.store, self.mesh)
                 if self.mesh.row == 0 else None)
        if self.viewer is not None:
            self.viewer.answer(req, functools.partial(self._viewer_frame,
                                                      store))
        return True

    def _viewer_frame(self, store, c2w, t: float, width: int,
                      height: int) -> np.ndarray:
        """Rank 0's frame of the gathered store: the single-device
        Trainer's render (viewer_rgb) as uint8."""
        return viewer_uint8(self.viewer_rgb(store, self.state.step, c2w, t,
                                            width, height))

    def full_state(self) -> SceneTrainState:
        return gather_state(self.state, self.mesh)

    def save(self, step: int):
        """Rank 0 writes the gathered state (every rank gathers)."""
        full = self.full_state()
        path = self.ckpt_dir / f"step-{step:09d}.ckpt.npz"
        if self.primary:
            path = self._save_state(full, step)
        dist.barrier()
        return path
