"""Scene-graph training through the trainer's loop.

Set-up writes the clip (scene.write_clip) and a checkpoint of the train
state at `start_step` (the store made from the seed, one slot in 16
inactive, zero Adam moments, a torch.Generator state and the
datamanager's sampler) and builds `engine.trainer.Trainer`, which parses
the clip, builds its stores and resumes from that checkpoint. The first
`check_steps` iterations run through `Trainer._iteration`, the window's
own call, on distinct frames; the reference follows them. The window then
calls `_iteration(step)` step after step.
"""
from __future__ import annotations

import gc
from pathlib import Path

import numpy as np
import torch

from .. import scene
from ..reference import train_check
from .common import Snapshot, first_grad_norms, flat_leaves


class Driver:
    unit = "step"

    def __init__(self, cfg: dict, traffic: dict, seed: int, device: str,
                 workdir: Path, control: str | None = None):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device, self.workdir, self.control = device, workdir, control

    # ------------------------------------------------------------------
    def _write_inputs(self):
        cfg, tr, dev = self.cfg, self.traffic, self.device
        F = cfg["track_frames"]
        w, h = tr["width"], tr["height"]
        self.tracks, stamps = scene.make_tracks(cfg, dev)
        imgs = scene.target_images(self.seed, F, w, h, tr["image_block"], dev)
        imgs = (imgs * 255.0).round().to(torch.uint8).cpu().numpy()
        scene.write_clip(self.workdir / "clip", self.seed, cfg, tr, imgs,
                         stamps, self.tracks)
        sc = scene.make_scene(self.seed, cfg, dev)
        arrays = {}
        for part, name in (("bg", "background"), ("obj", "objects")):
            for k in scene.PARAMS:
                arrays[f"store/{name}/params/{k}"] = sc[f"{part}/{k}"]
            arrays[f"store/{name}/active"] = sc[f"{part}/active"]
            for st in ("xys_grad_norm", "vis_counts", "max_2dsize"):
                arrays[f"store/{name}/{st}"] = torch.zeros(
                    sc[f"{part}/active"].shape, device=dev)
        for k in ("env_map", "delta_center", "delta_yaw", "delta_rot"):
            arrays[f"store/{k}"] = sc[k]
        for group in scene.PARAMS:
            for mom in ("mu", "nu"):
                for part, name in (("bg", "background"), ("obj", "objects")):
                    arrays[f"opt/{group}/{mom}/{part}"] = torch.zeros_like(
                        sc[f"{part}/{group}"])
            arrays[f"opt/{group}/count"] = np.int32(0)
        for mom in ("mu", "nu"):
            arrays[f"opt/sky_sphere/{mom}"] = torch.zeros_like(sc["env_map"])
            for k in ("delta_center", "delta_yaw", "delta_rot"):
                arrays[f"opt/bbox_opt/{mom}/{k}"] = torch.zeros_like(sc[k])
        arrays["opt/sky_sphere/count"] = np.int32(0)
        arrays["opt/bbox_opt/count"] = np.int32(0)
        arrays["step"] = np.int32(tr["start_step"])
        gen = scene.generator(self.seed ^ 0x7A11, dev)
        arrays["torch/generator_state"] = gen.get_state().numpy()
        # The sampler: the epoch's order is a permutation of the train
        # frames from the seed; the trainer pops from its end.
        rng = np.random.RandomState(self.seed % (2 ** 32))
        order = rng.permutation(self.train_frames).astype(np.int64)
        _, keys, pos, has_g, g = rng.get_state()
        arrays.update({"dm/rng_keys": np.asarray(keys, np.uint32),
                       "dm/rng_pos": np.asarray(pos, np.int64),
                       "dm/rng_has_gauss": np.asarray(has_g, np.int64),
                       "dm/rng_gauss": np.asarray(g, np.float64),
                       "dm/train_order": order})
        self.check_frames = [int(i) for i in order[::-1][:tr["check_steps"]]]
        ckpt = self.workdir / "run" / "checkpoints"
        ckpt.mkdir(parents=True)
        np.savez(ckpt / f"step-{tr['start_step']:09d}.ckpt.npz", **{
            k: (v.cpu().numpy() if isinstance(v, torch.Tensor) else v)
            for k, v in arrays.items()})
        self.p0 = {k: sc[k] for k in flat_leaves(sc)}
        del arrays, sc

    @property
    def train_frames(self):
        F = self.cfg["track_frames"]
        n = int(np.ceil(F * 0.9))
        return np.linspace(0, F - 1, n).astype(np.int64) if n < F else \
            np.arange(F)

    def setup(self):
        from street_gaussians_ns_tpu_torch.data.datamanager import \
            DataManagerConfig
        from street_gaussians_ns_tpu_torch.data.dataparser import \
            DataParserConfig
        from street_gaussians_ns_tpu_torch.engine import trainer as tm
        from street_gaussians_ns_tpu_torch.models.scene_graph import \
            SceneGraphConfig
        from street_gaussians_ns_tpu_torch.models.splatfacto import \
            SplatfactoConfig

        self.tm = tm
        self._write_inputs()
        cfg, tr = self.cfg, self.traffic
        sg = SceneGraphConfig(base=SplatfactoConfig(
            use_sky_sphere=True, sh_degree=cfg["sh_degree"],
            env_map_res=cfg["env_map_res"]))
        self.trainer = tm.Trainer(
            DataParserConfig(data=self.workdir / "clip",
                             orientation_method="none", center_method="none",
                             auto_scale_poses=False),
            sg,
            tm.TrainerConfig(output_dir=self.workdir / "run", resume=True,
                             seed=self.seed % (2 ** 31),
                             background_capacity=cfg["background_capacity"],
                             object_capacity=cfg["object_capacity"],
                             render_precision=self.control or "auto"),
            DataManagerConfig(cache_workers=4), device=self.device)
        t = self.trainer
        if list(t.scene.train_indices) != list(self.train_frames):
            raise RuntimeError(f"train split {list(t.scene.train_indices)}")
        self.step = t.start_step
        # The steps the reference follows, through the window's own call.
        snap = Snapshot()
        for i in range(tr["check_steps"]):
            m = t._iteration(self.step)
            self.step += 1
            snap.losses.append(m["loss"])
            if i == 0:
                snap.first_grad = first_grad_norms(_moments(t.state))
        p3 = _params(t.state)
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

    def run_unit(self):
        self.trainer._iteration(self.step)
        self.step += 1

    def program_modules(self):
        return {"trainer": self.tm}

    def traced_state(self):
        """The flat store for the work count of traced steps."""
        return _store_leaves(self.trainer.state.store)

    def traced_cameras(self, n: int):
        """The cameras the next n steps will use (their frames): the
        datamanager's order, read without drawing from it."""
        dm = self.trainer.dm
        order = list(dm._train_order)
        rng = np.random.RandomState()
        rng.set_state(dm.rng.get_state())
        out = []
        for _ in range(n):
            if not order:
                order = list(dm.scene.train_indices)
                rng.shuffle(order)
            out.append(self._cam(int(order.pop())))
        return out

    def _cam(self, i: int):
        tr = self.traffic
        return scene.camera(scene.clip_poses(self.cfg["track_frames"])[i],
                            tr["width"], tr["height"], tr["focal"],
                            self.tracks["times"][i].item(), self.device)

    def free(self):
        self.trainer = None
        gc.collect()
        if self.device == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------------
    def reference_numbers(self):
        """The reference's three steps from the same inputs."""
        tr, dev = self.traffic, self.device
        sc = scene.make_scene(self.seed, self.cfg, dev)
        imgs = scene.target_images(self.seed, self.cfg["track_frames"],
                                   tr["width"], tr["height"],
                                   tr["image_block"], dev)
        sem = scene.semantic_map(tr["width"], tr["height"], dev)
        gen = scene.generator(self.seed ^ 0x7A11, dev)
        steps = []
        for i, f in enumerate(self.check_frames):
            cam = self._cam(f)
            jitter = torch.rand((2, tr["height"], tr["width"]),
                                generator=gen, device=dev)
            steps.append((tr["start_step"] + i, cam, imgs[f], sem, jitter))
        ref = train_check.reference_steps(sc, self.tracks, steps,
                                          self.cfg["sh_degree"])
        return train_check.compare(self.snap, ref)


def _moments(state):
    opt = state.opt
    out = {}
    for g in scene.PARAMS:
        out[f"bg/{g}"] = opt[g].mu["bg"]
        out[f"obj/{g}"] = opt[g].mu["obj"]
    out["env_map"] = opt["sky_sphere"].mu
    return out


def _params(state):
    return _store_leaves(state.store)


def _store_leaves(store):
    out = {}
    for part, s in (("bg", store.background), ("obj", store.objects)):
        for g in scene.PARAMS:
            out[f"{part}/{g}"] = getattr(s.params, g)
        out[f"{part}/active"] = s.active
    out["env_map"] = store.env_map
    out["delta_center"] = store.delta_center
    out["delta_yaw"] = store.delta_yaw
    return out

