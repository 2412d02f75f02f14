"""Scene-graph training of a three-camera Waymo segment through the
trainer's loop, the tracked boxes' deltas trained with the scene.

Set-up writes the clip (waymo3.write_clip: three front cameras over F
frames, the vehicles over their stretches) and a checkpoint of the train
state at `start_step` (the store made from the seed, zero Adam moments,
the bbox deltas and theirs among them, a torch.Generator state and the
datamanager's sampler), and builds `engine.trainer.Trainer` as
`sgnt-train` does: the data parser keeps the three cameras
(`filter_camera_id`, `frame_select` over the whole clip) and splits 0.9
of their images for training; the trainer resumes from the checkpoint
and pre-sizes its pair capacity by its probe. The first `check_steps`
iterations run through `Trainer._iteration`, on frames of three
different cameras with vehicles in view; the reference
(reference/gs_posed.py) follows them over every leaf, the deltas
included. It runs on the card while the host threads encode the images
and write the checkpoint, before the trainer exists, so that a run of the
cell fits its time; its memory is released and the peak reset before the
trainer is built. The window then calls `_iteration(step)` step after
step.
"""
from __future__ import annotations

import concurrent.futures

import numpy as np
import torch

from .. import scene, waymo3
from ..reference import gs_posed, train_check
from . import train_scene_graph as base
from .common import Snapshot, first_grad_norms


class Driver(base.Driver):
    unit = "step"

    def _write_inputs(self, pool=None):
        """The clip and the checkpoint. With a thread pool the images are
        encoded, and the checkpoint written, in the background: returns
        (the scene's leaves on the device, what to wait for)."""
        cfg, tr, dev = self.cfg, self.traffic, self.device
        own = pool is None
        pool = pool or concurrent.futures.ThreadPoolExecutor(8)
        self.tracks, stamps = waymo3.make_tracks(cfg, dev)
        pending = waymo3.write_clip(self.workdir / "clip", self.seed, cfg, tr,
                                    stamps, self.tracks, dev, pool)
        sc = waymo3.make_scene(self.seed, cfg, dev)
        host = {}
        for part, name in (("bg", "background"), ("obj", "objects")):
            for k in scene.PARAMS:
                host[f"store/{name}/params/{k}"] = sc[f"{part}/{k}"]
                for mom in ("mu", "nu"):
                    host[f"opt/{k}/{mom}/{part}"] = np.zeros(
                        sc[f"{part}/{k}"].shape, np.float32)
            host[f"store/{name}/active"] = sc[f"{part}/active"]
            for st in ("xys_grad_norm", "vis_counts", "max_2dsize"):
                host[f"store/{name}/{st}"] = np.zeros(
                    sc[f"{part}/active"].shape, np.float32)
        for k in scene.PARAMS:
            host[f"opt/{k}/count"] = np.int32(0)
        for k in ("env_map", "delta_center", "delta_yaw", "delta_rot"):
            host[f"store/{k}"] = sc[k]
        for mom in ("mu", "nu"):
            host[f"opt/sky_sphere/{mom}"] = np.zeros(sc["env_map"].shape,
                                                     np.float32)
            for k in ("delta_center", "delta_yaw", "delta_rot"):
                host[f"opt/bbox_opt/{mom}/{k}"] = np.zeros(sc[k].shape,
                                                           np.float32)
        host["opt/sky_sphere/count"] = np.int32(0)
        host["opt/bbox_opt/count"] = np.int32(0)
        host["step"] = np.int32(tr["start_step"])
        gen = scene.generator(self.seed ^ 0x7A11, dev)
        host["torch/generator_state"] = gen.get_state().numpy()
        # The sampler: an epoch's order is a permutation of the train
        # images from the seed; the trainer pops from its end. The first
        # three it pops, the steps the reference follows, are moved there:
        # from the end, the first image of each camera not yet taken with
        # `check_vehicles` vehicles in full view, so that the first step's
        # gradient reaches every vehicle leaf and both deltas.
        rng = np.random.RandomState(self.seed % (2 ** 32))
        order = list(rng.permutation(self.train_frames))
        F, firsts, seen = waymo3.frames(cfg), [], set()
        for g in reversed(order):
            if g // F not in seen and waymo3.vehicles_in_view(
                    cfg, tr, self.tracks, int(g)) >= tr["check_vehicles"]:
                seen.add(g // F)
                firsts.append(g)
            if len(firsts) == tr["check_steps"]:
                break
        if len(firsts) < tr["check_steps"]:
            raise RuntimeError("no check frame with vehicles in view")
        order = [g for g in order if g not in firsts] + firsts[::-1]
        _, keys, pos, has_g, g = rng.get_state()
        host.update({"dm/rng_keys": np.asarray(keys, np.uint32),
                     "dm/rng_pos": np.asarray(pos, np.int64),
                     "dm/rng_has_gauss": np.asarray(has_g, np.int64),
                     "dm/rng_gauss": np.asarray(g, np.float64),
                     "dm/train_order": np.asarray(order, np.int64)})
        self.check_frames = [int(i) for i in firsts]
        ckpt = self.workdir / "run" / "checkpoints"
        ckpt.mkdir(parents=True)
        host = {k: (v.cpu().numpy() if isinstance(v, torch.Tensor) else v)
                for k, v in host.items()}
        # A thread of its own, so that it starts before the queued images.
        saver = concurrent.futures.ThreadPoolExecutor(1)
        pending.append(saver.submit(
            np.savez, ckpt / f"step-{tr['start_step']:09d}.ckpt.npz", **host))
        saver.shutdown(wait=False)
        self.p0 = {k: sc[k] for k in gs_posed.leaf_names(sc)}
        if own:
            _wait(pending)
            pool.shutdown()
        return sc, pending

    @property
    def train_frames(self):
        """The data parser's 0.9 linspace split of all the clip's images."""
        n = waymo3.image_count(self.cfg)
        k = int(np.ceil(n * 0.9))
        return np.linspace(0, n - 1, k).astype(np.int64)

    def data_config(self):
        from street_gaussians_ns_tpu_torch.data.dataparser import \
            DataParserConfig
        ids = [c[0] for c in waymo3.cameras(self.cfg)]
        return DataParserConfig(
            data=self.workdir / "clip", orientation_method="none",
            center_method="none", auto_scale_poses=False,
            filter_camera_id=ids, frame_select=[0, waymo3.frames(self.cfg)])

    def setup(self):
        from street_gaussians_ns_tpu_torch.data.datamanager import \
            DataManagerConfig
        from street_gaussians_ns_tpu_torch.engine import trainer as tm
        from street_gaussians_ns_tpu_torch.models.scene_graph import \
            SceneGraphConfig
        from street_gaussians_ns_tpu_torch.models.splatfacto import \
            SplatfactoConfig

        self.tm = tm
        with concurrent.futures.ThreadPoolExecutor(8) as pool:
            sc, pending = self._write_inputs(pool)
            self.ref = self._reference(sc)
            del sc
            _wait(pending)
        if self.device == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        cfg, tr = self.cfg, self.traffic
        sg = SceneGraphConfig(
            base=SplatfactoConfig(use_sky_sphere=True,
                                  sh_degree=cfg["sh_degree"],
                                  env_map_res=cfg["env_map_res"]),
            bbox_mode=cfg["bbox_mode"],
            bbox_differentiable=cfg["bbox_differentiable"])
        self.trainer = tm.Trainer(
            self.data_config(), sg,
            tm.TrainerConfig(output_dir=self.workdir / "run", resume=True,
                             seed=self.seed % (2 ** 31),
                             background_capacity=cfg["background_capacity"],
                             object_capacity=cfg["object_capacity"],
                             render_precision=self.control or "auto"),
            DataManagerConfig(cache_workers=8), device=self.device)
        t = self.trainer
        if list(t.scene.train_indices) != list(self.train_frames):
            raise RuntimeError(f"train split {list(t.scene.train_indices)}")
        n_obj = t.scene.annotations.num_objects
        if n_obj != cfg["objects"]:
            raise RuntimeError(f"{n_obj} tracked vehicles parsed")
        self.step = t.start_step
        self.live_start = int(t.state.store.background.active.sum())
        snap = Snapshot()
        for i in range(tr["check_steps"]):
            m = t._iteration(self.step)
            self.step += 1
            snap.losses.append(m["loss"])
            if i == 0:
                snap.first_grad = first_grad_norms(_moments(t.state))
        p3 = base._params(t.state)
        snap.change = {k: torch.linalg.vector_norm(p3[k] - self.p0[k])
                       for k in snap.first_grad}
        self.snap = snap.to_host()
        del self.p0, p3
        # Warm-up of what the window reaches: a refine pass (its result is
        # dropped) and the capacity check.
        t._refine(max(*t._last_hw))
        t._maybe_grow_pairs({})
        if self.device == "cuda":
            torch.cuda.synchronize()
        self.setup_seconds = dict(t.setup_seconds)

    def _cam(self, i: int):
        return waymo3.camera(self.cfg, self.traffic, self.tracks, i,
                             self.device)

    def free(self):
        """Reads the live background at the window's end first."""
        self.live_end = int(self.trainer.state.store.background.active.sum())
        super().free()

    def _reference(self, sc: dict) -> dict:
        """The reference's three steps from the scene's leaves `sc` and the
        check frames' targets, TF32 off inside them only."""
        tr, dev = self.traffic, self.device
        sem = scene.semantic_map(tr["width"], tr["height"], dev)
        gen = scene.generator(self.seed ^ 0x7A11, dev)
        steps = []
        for i, g in enumerate(self.check_frames):
            jitter = torch.rand((2, tr["height"], tr["width"]),
                                generator=gen, device=dev)
            img = waymo3.target_image(self.seed, g, tr["width"], tr["height"],
                                      tr["image_block"], dev)
            steps.append((tr["start_step"] + i, self._cam(g), img, sem,
                          jitter))
        flags = (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32)
        try:
            return gs_posed.reference_steps(sc, self.tracks, steps,
                                            self.cfg["sh_degree"])
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = flags

    def reference_numbers(self):
        """The program's three steps against the reference's (computed in
        set-up), every leaf compared."""
        ref = self.ref
        out = train_check.compare(self.snap, ref)
        out["detail"]["frames"] = self.check_frames
        out["detail"]["bg_live"] = [self.live_start, self.live_end]
        out["detail"]["first_grad"] = {
            k: [float(f"{self.snap.first_grad[k]:.6g}"), float(f"{v:.6g}")]
            for k, v in ref["first_grad"].items()}
        return out


def _moments(state):
    out = base._moments(state)
    for k in gs_posed.DELTAS:
        out[k] = state.opt["bbox_opt"].mu[k]
    return out


def _wait(pending: list) -> None:
    for p in pending:
        p.result()
