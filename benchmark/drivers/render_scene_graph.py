"""Scene-graph rendering for evaluation: `forward_scene(training=False,
eval_extras=True)` of one pose after the other along a drive, closed loop
with one client; a frame is done when its rgb, depth, accumulation,
object and background heads are on the host, as scripts/render.py fetches
them. Capacity is sized in set-up from the drive's own pair counts. The
heads of a sample of frames, drawn from the seed, are kept for the check.
"""
from __future__ import annotations

import gc
import time
from pathlib import Path

import numpy as np
import torch

from .. import scene
from ..reference import gs

HEADS = ("rgb", "depth", "accumulation", "object_rgb", "background_rgb")


class Driver:
    unit = "frame"

    def __init__(self, cfg: dict, traffic: dict, seed: int, device: str,
                 workdir: Path, control: str | None = None):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device, self.workdir, self.control = device, workdir, control
        self.latencies = []
        self.kept = {}
        tr = traffic
        poses = scene.drive_poses(tr["poses"], tr["length"],
                                  cfg["track_frames"])
        # Frame i renders pose (i * stride) mod n: any stretch of the window
        # samples the whole drive, so the mix of frame costs does not
        # depend on how far a window gets.
        n, stride = len(poses), tr.get("pose_stride", 1)
        self.poses = [poses[(i * stride) % n] for i in range(n)]
        rng = np.random.default_rng(seed)
        self.sample = sorted(int(i) for i in rng.choice(
            min(tr["sample_from"], tr["poses"]), tr["check_frames"],
            replace=False))
        self.frame = 0

    def setup(self):
        from street_gaussians_ns_tpu_torch.core.cameras import Camera
        from street_gaussians_ns_tpu_torch.engine.trainer import \
            scene_pair_counts
        from street_gaussians_ns_tpu_torch.models import scene_graph as sgm
        from street_gaussians_ns_tpu_torch.models.gaussians import (
            GaussianParams, GaussianStore)
        from street_gaussians_ns_tpu_torch.models.splatfacto import \
            SplatfactoConfig
        from street_gaussians_ns_tpu_torch.ops.render import RenderConfig

        self.sgm = sgm
        cfg, tr, dev = self.cfg, self.traffic, self.device
        sc = scene.make_scene(self.seed, cfg, dev)
        tracks, _ = scene.make_tracks(cfg, dev)

        def store(part):
            z = torch.zeros(sc[f"{part}/active"].shape, device=dev)
            return GaussianStore(
                params=GaussianParams(**{k: sc[f"{part}/{k}"]
                                         for k in scene.PARAMS}),
                active=sc[f"{part}/active"], xys_grad_norm=z,
                vis_counts=z.clone(), max_2dsize=z.clone())
        self.store = sgm.SceneGraphStore(
            background=store("bg"), objects=store("obj"),
            env_map=sc["env_map"], delta_center=sc["delta_center"],
            delta_yaw=sc["delta_yaw"], delta_rot=sc["delta_rot"])
        self.tracks = sgm.ObjectTracks(**tracks)
        self.config = sgm.SceneGraphConfig(base=SplatfactoConfig(
            use_sky_sphere=True, sh_degree=cfg["sh_degree"],
            env_map_res=cfg["env_map_res"]))
        self.cams = [Camera.make(tr["focal"], tr["focal"], tr["width"] / 2,
                                 tr["height"] / 2, c2w, tr["width"],
                                 tr["height"], time=t, device=dev)
                     for c2w, t in self.poses]
        pairs = runs = 0
        best = 0
        for i, cam in enumerate(self.cams):
            p, r = scene_pair_counts(self.store, self.tracks, cam,
                                     self.config)
            if int(p) > pairs:
                best = i
            pairs, runs = max(pairs, int(p)), max(runs, int(r))

        def up(v, step=8192):
            return max(step, -(-v // step) * step)
        self.rcfg = RenderConfig(max_pairs=up(pairs), max_rowruns=up(runs),
                                 precision=self.control or "f32")
        for i in (best, 0):
            self._frame(self.cams[i])
        if dev == "cuda":
            torch.cuda.synchronize()

    def _frame(self, cam):
        with torch.no_grad():
            out, _, _ = self.sgm.forward_scene(
                self.store, self.tracks, cam, 0, self.config, self.rcfg,
                training=False, eval_extras=True)
            return {h: out[h].cpu() for h in HEADS}

    def run_unit(self):
        i = self.frame
        t = time.perf_counter()
        heads = self._frame(self.cams[i % len(self.cams)])
        self.latencies.append(time.perf_counter() - t)
        if i in self.sample:
            self.kept[i] = heads
        self.frame += 1

    def program_modules(self):
        return {"scene_graph": self.sgm}

    def traced_state(self):
        return None

    def traced_cameras(self, n: int):
        return [scene.camera(*self._pose((self.frame + j) % len(self.poses)),
                             self.device) for j in range(n)]

    def _pose(self, i):
        c2w, t = self.poses[i]
        tr = self.traffic
        return c2w, tr["width"], tr["height"], tr["focal"], t

    def free(self):
        self.store = self.cams = None
        gc.collect()
        if self.device == "cuda":
            torch.cuda.empty_cache()

    def reference_store(self):
        return scene.make_scene(self.seed, self.cfg, self.device)

    def reference_numbers(self):
        """Each kept frame against the reference's: the mean absolute gap
        of the colour heads (rgb, object, background), of the
        accumulation, and of the depth (relative, where both
        accumulations pass 0.05), the worst frame of the sample; and the
        sampled frames the window never finished. The widest gaps go to
        the detail: a pixel whose transmittance meets the 1e-4 saturation
        test within rounding ends one pair apart in the two, which moves
        it by up to that pair's weight, so the widest gap swings from seed
        to seed while the mean holds."""
        gs.no_tf32()
        dev = self.device
        sc = self.reference_store()
        tracks, _ = scene.make_tracks(self.cfg, dev)
        gaps = {"rgb_mean_gap": 0.0, "acc_mean_gap": 0.0,
                "depth_mean_gap": 0.0}
        widest = {"rgb": 0.0, "acc": 0.0, "depth": 0.0}
        missing = [i for i in self.sample if i not in self.kept]
        for i in self.sample:
            if i not in self.kept:
                continue
            cam = scene.camera(*self._pose(i % len(self.poses)), dev)
            with torch.no_grad():
                ref = gs.forward(sc, tracks, cam, self.cfg["sh_degree"],
                                 training=False, extras=True)
            got = {h: v.to(dev) for h, v in self.kept[i].items()}
            col = torch.cat([(got[h] - ref[h]).abs().reshape(-1) for h in
                             ("rgb", "object_rgb", "background_rgb")])
            acc = (got["accumulation"] - ref["accumulation"]).abs()
            both = ((got["accumulation"] > 0.05)
                    & (ref["accumulation"] > 0.05))
            rel = ((got["depth"] - ref["depth"]).abs()
                   / ref["depth"].abs().clamp(min=1e-3))[both]
            gaps["rgb_mean_gap"] = max(gaps["rgb_mean_gap"],
                                       float(col.mean()))
            gaps["acc_mean_gap"] = max(gaps["acc_mean_gap"],
                                       float(acc.mean()))
            gaps["depth_mean_gap"] = max(
                gaps["depth_mean_gap"],
                float(rel.mean()) if rel.numel() else 0.0)
            for k, v in (("rgb", col), ("acc", acc), ("depth", rel)):
                if v.numel():
                    widest[k] = max(widest[k], float(v.max()))
            del ref, got
        gaps["missing"] = float(len(missing))
        return {"numbers": gaps,
                "detail": {"frames": self.sample, "missing": missing,
                           "widest": widest}}
