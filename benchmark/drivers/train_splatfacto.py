"""Single-model (Splatfacto) training: `engine.train_step.train_step` step
after step, `refine_step` after each step s with s % refine_every == 0
(the reference's cadence), the cameras cycled one a step and the targets
kept on the device. The first `check_steps` steps go through the same
calls in set-up and the reference follows them."""
from __future__ import annotations

import dataclasses
import gc
from pathlib import Path

import torch

from .. import scene
from ..reference import train_check
from .common import Snapshot, first_grad_norms


def next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


class Driver:
    unit = "step"
    tracks = None              # the single-model pipeline has no vehicles

    def __init__(self, cfg: dict, traffic: dict, seed: int, device: str,
                 workdir: Path, control: str | None = None):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device, self.workdir, self.control = device, workdir, control

    def _cam_ref(self, i: int):
        tr = self.traffic
        c2w = scene.clip_poses(tr["cameras"])[i]
        return scene.camera(c2w, tr["width"], tr["height"], tr["focal"],
                            0.0, self.device)

    def setup(self):
        from street_gaussians_ns_tpu_torch.core.cameras import Camera
        from street_gaussians_ns_tpu_torch.engine import train_step as ts
        from street_gaussians_ns_tpu_torch.models.gaussians import (
            GaussianParams, GaussianStore)
        from street_gaussians_ns_tpu_torch.models.splatfacto import \
            SplatfactoConfig
        from street_gaussians_ns_tpu_torch.ops import tiles
        from street_gaussians_ns_tpu_torch.ops.render import RenderConfig
        from street_gaussians_ns_tpu_torch.core.projection import project
        from street_gaussians_ns_tpu_torch.core.cameras import \
            viewmat_from_c2w

        self.ts = ts
        cfg, tr, dev = self.cfg, self.traffic, self.device
        sc = scene.make_scene(self.seed, cfg, dev)
        self.config = SplatfactoConfig(
            use_sky_sphere=True, sh_degree=cfg["sh_degree"],
            env_map_res=cfg["env_map_res"],
            fourier_features_dim=cfg["background_fourier"])
        zeros = torch.zeros(sc["bg/active"].shape, device=dev)
        store = GaussianStore(
            params=GaussianParams(**{k: sc[f"bg/{k}"].clone()
                                     for k in scene.PARAMS}),
            active=sc["bg/active"].clone(), xys_grad_norm=zeros,
            vis_counts=zeros.clone(), max_2dsize=zeros.clone())
        gen = scene.generator(self.seed ^ 0x7A11, dev)
        state = ts.init_train_state(store, sc["env_map"].clone(), gen)
        self.state = dataclasses.replace(state, step=tr["start_step"])
        n = tr["cameras"]
        self.cams = [Camera.make(tr["focal"], tr["focal"], tr["width"] / 2,
                                 tr["height"] / 2, c2w, tr["width"],
                                 tr["height"], time=0.0, device=dev)
                     for c2w in scene.clip_poses(n)]
        imgs = scene.target_images(self.seed, n, tr["width"], tr["height"],
                                   tr["image_block"], dev)
        sem = scene.semantic_map(tr["width"], tr["height"], dev)
        self.batches = [{"image": imgs[i], "semantic": sem,
                         "time": torch.zeros((), device=dev)}
                        for i in range(n)]
        # Capacity as the trainer's probe sets it: next_pow2(2 x the most
        # pairs / runs any camera needs).
        pairs = runs = 0
        with torch.no_grad():
            op = torch.sigmoid(store.params.opacities[:, 0])
            op = torch.where(store.active, op, torch.zeros_like(op))
            for cam in self.cams:
                proj = project(store.params.means,
                               torch.exp(store.params.scales),
                               store.params.quats, viewmat_from_c2w(cam.c2w),
                               cam.fx, cam.fy, cam.cx, cam.cy, cam.width,
                               cam.height, opacities=op)
                proj = dataclasses.replace(proj, num_tiles_hit=torch.where(
                    store.active, proj.num_tiles_hit, 0))
                p, r = tiles.count_pairs(proj, cam.width, cam.height, 16,
                                         opacities=op)
                pairs, runs = max(pairs, int(p)), max(runs, int(r))
        cap = next_pow2(max(2 * pairs, 1024))
        self.rcfg = RenderConfig(max_pairs=cap, max_rowruns=max(
            next_pow2(max(2 * runs, 512)), cap // 4),
            precision=self.control or "f32")
        self.p0 = {f"bg/{k}": sc[f"bg/{k}"] for k in scene.PARAMS}
        self.p0["env_map"] = sc["env_map"]
        del sc
        snap = Snapshot()
        for i in range(tr["check_steps"]):
            m = self._step()
            snap.losses.append(m["loss"])
            if i == 0:
                snap.first_grad = first_grad_norms(self._moments())
        p3 = self._params()
        snap.change = {k: torch.linalg.vector_norm(p3[k] - self.p0[k])
                       for k in snap.first_grad}
        self.snap = snap.to_host()
        del self.p0, p3
        # Warm-up of the refine pass the window reaches (result dropped).
        self.ts.refine_step(self.state, self.config, n,
                            max(tr["width"], tr["height"]))
        if dev == "cuda":
            torch.cuda.synchronize()

    def _step(self):
        i = (self.state.step - self.traffic["start_step"]) % len(self.cams)
        self.state, m = self.ts.train_step(self.state, self.cams[i],
                                           self.batches[i], self.config,
                                           self.rcfg)
        s = self.state.step - 1
        if s % self.config.refine_every == 0:
            tr = self.traffic
            self.state, _ = self.ts.refine_step(
                self.state, self.config, len(self.cams),
                max(tr["width"], tr["height"]))
        return m

    def run_unit(self):
        self._step()

    def _moments(self):
        out = {f"bg/{k}": self.state.opt[k].mu for k in scene.PARAMS}
        out["env_map"] = self.state.opt["sky_sphere"].mu
        return out

    def _params(self):
        out = {f"bg/{k}": getattr(self.state.store.params, k)
               for k in scene.PARAMS}
        out["env_map"] = self.state.env_map
        return out

    def program_modules(self):
        return {"train_step": self.ts}

    def traced_state(self):
        out = self._params()
        out["bg/active"] = self.state.store.active
        return out

    def traced_cameras(self, n: int):
        s0 = self.state.step - self.traffic["start_step"]
        return [self._cam_ref((s0 + j) % len(self.cams)) for j in range(n)]

    def free(self):
        self.state = self.batches = None
        gc.collect()
        if self.device == "cuda":
            torch.cuda.empty_cache()

    def reference_numbers(self):
        tr, dev = self.traffic, self.device
        sc = scene.make_scene(self.seed, self.cfg, dev)
        sc = {k: v for k, v in sc.items() if k.startswith("bg/")
              or k == "env_map"}
        imgs = scene.target_images(self.seed, tr["cameras"], tr["width"],
                                   tr["height"], tr["image_block"], dev)
        sem = scene.semantic_map(tr["width"], tr["height"], dev)
        gen = scene.generator(self.seed ^ 0x7A11, dev)
        steps = []
        for i in range(tr["check_steps"]):
            jitter = torch.rand((2, tr["height"], tr["width"]),
                                generator=gen, device=dev)
            c = i % tr["cameras"]
            steps.append((tr["start_step"] + i, self._cam_ref(c), imgs[c],
                          sem, jitter))
        ref = train_check.reference_steps(sc, None, steps,
                                          self.cfg["sh_degree"])
        return train_check.compare(self.snap, ref)
