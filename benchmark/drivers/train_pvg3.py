"""PVG training (models.pvg) of the three-camera Waymo segment through
the trainer's loop: one temporal cloud and the sky, no boxes.

Set-up first imports the program's PVG model, so that a program without
it fails at once. It writes waymo3's clip with no tracked vehicle and a
checkpoint of PVG's train state at `start_step` (the cloud made from the
seed, pvg3.make_scene, zero Adam moments for its nine groups and the sky,
a torch.Generator state and the datamanager's sampler), and builds
`engine.trainer.Trainer` with the PVG config as `sgnt-torch-train
--method pvg` does: the data parser keeps the three cameras over the
whole clip, reads no annotation, and splits 0.9 of the images for
training; the trainer resumes from the checkpoint and pre-sizes its pair
capacity by its probe. The first `check_steps` iterations run through
`Trainer._iteration`, one image of each camera; the reference
(reference/pvg.py) follows them over every leaf, the temporal ones
included. It runs on the card in set-up while threads encode the images
and write the checkpoint, as in train_waymo3. The window then calls
`_iteration(step)` step after step.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses

import numpy as np
import torch

from .. import pvg3, scene, waymo3
from ..reference import pvg as pvg_ref
from ..reference import train_check
from . import train_waymo3
from .common import Snapshot, first_grad_norms

GROUPS = scene.PARAMS + pvg3.TEMPORAL


class Driver(train_waymo3.Driver):
    unit = "step"

    def _write_inputs(self, pool):
        """The clip and the checkpoint, the images encoded and the
        checkpoint written on threads: returns (the cloud's leaves on the
        device, what to wait for)."""
        cfg, tr, dev = self.cfg, self.traffic, self.device
        clip = pvg3.clip_config(cfg)
        tracks, stamps = waymo3.make_tracks(clip, dev)
        self.times = tracks["times"]
        pending = waymo3.write_clip(self.workdir / "clip", self.seed, clip,
                                    tr, stamps, tracks, dev, pool)
        sc = pvg3.make_scene(self.seed, cfg, dev)
        host = {}
        for k in GROUPS:
            host[f"store/background/params/{k}"] = sc[f"bg/{k}"]
            for mom in ("mu", "nu"):
                host[f"opt/{k}/{mom}"] = np.zeros(sc[f"bg/{k}"].shape,
                                                  np.float32)
            host[f"opt/{k}/count"] = np.int32(0)
        host["store/background/active"] = sc["bg/active"]
        for st in ("xys_grad_norm", "vis_counts", "max_2dsize"):
            host[f"store/background/{st}"] = np.zeros(sc["bg/active"].shape,
                                                      np.float32)
        host["store/env_map"] = sc["env_map"]
        for mom in ("mu", "nu"):
            host[f"opt/sky_sphere/{mom}"] = np.zeros(sc["env_map"].shape,
                                                     np.float32)
        host["opt/sky_sphere/count"] = np.int32(0)
        host["step"] = np.int32(tr["start_step"])
        gen = scene.generator(self.seed ^ 0x7A11, dev)
        host["torch/generator_state"] = gen.get_state().numpy()
        # The sampler: an epoch's order is a permutation of the train
        # images from the seed; the trainer pops from its end. The first
        # three it pops, the steps the reference follows, are one image
        # of each camera: from the end, the first of each camera.
        rng = np.random.RandomState(self.seed % (2 ** 32))
        order = list(rng.permutation(self.train_frames))
        F, firsts, seen = waymo3.frames(cfg), [], set()
        for g in reversed(order):
            if g // F not in seen:
                seen.add(g // F)
                firsts.append(g)
            if len(firsts) == tr["check_steps"]:
                break
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
        saver = concurrent.futures.ThreadPoolExecutor(1)
        pending.append(saver.submit(
            np.savez, ckpt / f"step-{tr['start_step']:09d}.ckpt.npz", **host))
        saver.shutdown(wait=False)
        self.p0 = {k: sc[k] for k in pvg_ref.leaf_names(sc)}
        return sc, pending

    def data_config(self):
        return dataclasses.replace(super().data_config(),
                                   load_dynamic_annotations=False)

    def pvg_config(self):
        from street_gaussians_ns_tpu_torch.models.pvg import PVGConfig
        return PVGConfig(cycle=self.cfg["cycle_s"])

    def setup(self):
        # First: a program without PVG fails here, before any work.
        self.pvg_config()
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
            train_waymo3._wait(pending)
        if self.device == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        cfg, tr = self.cfg, self.traffic
        sg = SceneGraphConfig(base=SplatfactoConfig(
            use_sky_sphere=True, sh_degree=cfg["sh_degree"],
            env_map_res=cfg["env_map_res"]))
        self.trainer = tm.Trainer(
            self.data_config(), sg,
            tm.TrainerConfig(output_dir=self.workdir / "run", resume=True,
                             seed=self.seed % (2 ** 31),
                             background_capacity=cfg["background_capacity"],
                             render_precision=self.control or "auto"),
            DataManagerConfig(cache_workers=8), device=self.device,
            pvg=self.pvg_config())
        t = self.trainer
        if list(t.scene.train_indices) != list(self.train_frames):
            raise RuntimeError(f"train split {list(t.scene.train_indices)}")
        self.step = t.start_step
        self.live_start = int(t.state.store.active.sum())
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

    def _cam(self, i: int):
        tr = self.traffic
        return scene.camera(waymo3.c2w(self.cfg, i), tr["width"],
                            tr["height"], tr["focal"],
                            self.times[i % waymo3.frames(self.cfg)].item(),
                            self.device)

    def free(self):
        """Reads the live cloud at the window's end first."""
        self.live_end = int(self.trainer.state.store.active.sum())
        super(train_waymo3.Driver, self).free()

    def traced_state(self):
        """The static leaves, for the benchmark's work count (which knows
        no time: it is read by no metric of this cell)."""
        st = self.trainer.state
        out = {f"bg/{g}": getattr(st.store.params, g) for g in scene.PARAMS}
        out["bg/active"] = st.store.active
        out["env_map"] = st.env_map
        return out

    def _reference(self, sc: dict) -> dict:
        """The reference's three steps from the cloud's leaves `sc` and the
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
        lr = {k: tuple(v) for k, v in self.cfg["temporal_lr"].items()}
        flags = (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32)
        try:
            return pvg_ref.reference_steps(sc, steps, self.cfg["sh_degree"],
                                           self.cfg["cycle_s"], lr)
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = flags

    def reference_numbers(self):
        """The program's three steps against the reference's (computed in
        set-up), every leaf compared."""
        ref = self.ref
        out = train_check.compare(self.snap, ref)
        out["detail"]["frames"] = self.check_frames
        out["detail"]["live"] = [self.live_start, self.live_end]
        out["detail"]["first_grad"] = {
            k: [float(f"{self.snap.first_grad[k]:.6g}"), float(f"{v:.6g}")]
            for k, v in ref["first_grad"].items()}
        return out


def _moments(state):
    out = {f"bg/{g}": state.opt[g].mu for g in GROUPS}
    out["env_map"] = state.opt["sky_sphere"].mu
    return out


def _params(state):
    out = {f"bg/{g}": getattr(state.store.params, g) for g in GROUPS}
    out["env_map"] = state.env_map
    return out
