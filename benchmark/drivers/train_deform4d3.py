"""4D Gaussian Splatting training (models.deform4d) of the three-camera
Waymo segment through the trainer's loop: one canonical cloud, the sky
and the HexPlane deformation field, no boxes.

Set-up first imports the program's 4DGS model, so that a program without
it fails at once. It writes waymo3's clip with no tracked vehicle and a
checkpoint of 4DGS's train state at `start_step` (the cloud and the field
made from the seed, deform4d3.make_scene, zero Adam moments for the six
gaussian groups, the sky and the field's two, a torch.Generator state and
the datamanager's sampler), and builds `engine.trainer.Trainer` with the
field's config as `sgnt-torch-train --method deform4d` does: the data
parser keeps the three cameras over the whole clip, reads no annotation,
and splits 0.9 of the images for training; the trainer resumes from the
checkpoint and pre-sizes its pair capacity by its probe. The first
`check_steps` iterations run through `Trainer._iteration`, one image of
each camera, each at its image's time; the reference
(reference/deform4d.py) follows them over every leaf, the planes and the
decoder included. It runs on the card in set-up while threads encode the
images and write the checkpoint, as in train_pvg3. The window then calls
`_iteration(step)` step after step.

Controls (`--control`), each of which must come out not correct: "bf16"
renders at bf16 (the program's own lower-precision path, as in the other
train cells); "tf32" lets the program's float32 GEMMs, the decoder's
among them, run in TF32; "bf16_field" puts the reference's field
(reference/deform4d.field), computed in bfloat16, in the place of the
program's. Beside train_pvg3's three numbers the check compares the
decoder's first gradient tensor by tensor (`decoder_gap`; the detail's
`decoder_parts` gives each tensor's norm, program and reference).
"""
from __future__ import annotations

import concurrent.futures

import numpy as np
import torch

from .. import deform4d3, pvg3, scene, waymo3
from ..reference import deform4d as d4_ref
from . import train_pvg3, train_waymo3
from .common import ADAM_B1, Snapshot, first_grad_norms

FIELD = ("planes", "decoder")
CONTROLS = (None, "bf16", "tf32", "bf16_field")


class Driver(train_pvg3.Driver):
    unit = "step"

    def _write_inputs(self, pool):
        """The clip and the checkpoint, the images encoded and the
        checkpoint written on threads: returns (the cloud's and the
        field's leaves on the device, what to wait for)."""
        cfg, tr, dev = self.cfg, self.traffic, self.device
        clip = pvg3.clip_config(cfg)
        tracks, stamps = waymo3.make_tracks(clip, dev)
        self.times = tracks["times"]
        pending = waymo3.write_clip(self.workdir / "clip", self.seed, clip,
                                    tr, stamps, tracks, dev, pool)
        sc = deform4d3.make_scene(self.seed, cfg, dev)
        host = {}

        def zero_group(name, like):
            for mom in ("mu", "nu"):
                host[f"opt/{name}/{mom}"] = np.zeros(like.shape, np.float32)
            host[f"opt/{name}/count"] = np.int32(0)
        for k in scene.PARAMS:
            host[f"store/background/params/{k}"] = sc[f"bg/{k}"]
            zero_group(k, sc[f"bg/{k}"])
        host["store/background/active"] = sc["bg/active"]
        for st in ("xys_grad_norm", "vis_counts", "max_2dsize"):
            host[f"store/background/{st}"] = np.zeros(sc["bg/active"].shape,
                                                      np.float32)
        host["store/env_map"] = sc["env_map"]
        zero_group("sky_sphere", sc["env_map"])
        for k in FIELD + ("aabb", "time_span"):
            host[f"store/field/{k}"] = sc[f"field/{k}"]
        for k in FIELD:
            zero_group(f"field_{k}", sc[f"field/{k}"])
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
        self.p0 = {k: sc[k] for k in d4_ref.leaf_names(sc)}
        return sc, pending

    def deform4d_config(self):
        from street_gaussians_ns_tpu_torch.models.deform4d import \
            Deform4DConfig
        c = self.cfg
        return Deform4DConfig(
            channels=c["plane_channels"], scales=list(c["plane_scales"]),
            base_resolution=c["plane_base_resolution"],
            time_cells=c["time_cells"], net_width=c["net_width"],
            static_steps=c["static_steps"],
            plane_tv_weight=c["plane_tv_weight"],
            time_smoothness_weight=c["time_smoothness_weight"],
            l1_time_planes_weight=c["l1_time_planes_weight"])

    def setup(self):
        if self.control not in CONTROLS:
            raise ValueError(f"control {self.control!r}: one of {CONTROLS}")
        # First: a program without 4DGS fails here, before any work.
        self.deform4d_config()
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
                             render_precision=("bf16" if self.control
                                               == "bf16" else "auto")),
            DataManagerConfig(cache_workers=8), device=self.device,
            deform4d=self.deform4d_config())
        t = self.trainer
        if list(t.scene.train_indices) != list(self.train_frames):
            raise RuntimeError(f"train split {list(t.scene.train_indices)}")
        self.step = t.start_step
        self.live_start = int(t.state.store.active.sum())
        self._plant_control()
        snap = Snapshot()
        for i in range(tr["check_steps"]):
            m = t._iteration(self.step)
            self.step += 1
            snap.losses.append(m["loss"])
            if i == 0:
                moments = _moments(t.state)
                snap.first_grad = first_grad_norms(moments)
                self.decoder_parts = d4_ref.decoder_part_norms(
                    moments["field/decoder"] / (1 - ADAM_B1), self.cfg)
                # The next steps replace the moments: hold none of them.
                del moments
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

    def _plant_control(self):
        """The "tf32" and "bf16_field" controls, for the rest of the run."""
        if self.control == "tf32":
            torch.backends.cuda.matmul.allow_tf32 = True
        elif self.control == "bf16_field":
            from street_gaussians_ns_tpu_torch.models import deform4d
            cfg = self.cfg

            def deform(params, field, t, config):
                bf = torch.bfloat16
                tt = torch.as_tensor(t, dtype=bf, device=params.means.device)
                dx, ds, dr = d4_ref.field(
                    params.means.to(bf), field["planes"].to(bf),
                    field["decoder"].to(bf), field["aabb"].to(bf),
                    field["time_span"].to(bf), tt, cfg)
                return (params.means + dx.float(),
                        params.scales + ds.float(),
                        params.quats + dr.float())
            deform4d.deform = deform

    def reference_numbers(self):
        """train_pvg3's three numbers, and `decoder_gap`: the worst of the
        decoder's tensors, | |g1| - |g1_ref| | / max(|g1_ref|, the median
        tensor's |g1_ref|), g1 the first gradient (train_check's rule
        for leaves, applied inside the decoder's flat leaf)."""
        out = super().reference_numbers()
        prog, ref = self.decoder_parts, self.ref["decoder_parts"]
        base = float(np.median(list(ref.values())))
        gaps = {k: abs(prog[k] - v) / max(v, base, 1e-30)
                for k, v in ref.items()}
        worst = max(gaps, key=gaps.get)
        out["numbers"]["decoder_gap"] = gaps[worst]
        out["detail"]["decoder_leaf"] = worst
        out["detail"]["decoder_parts"] = {
            k: [float(f"{prog[k]:.6g}"), float(f"{v:.6g}")]
            for k, v in ref.items()}
        return out

    def _reference(self, sc: dict) -> dict:
        """The reference's three steps from the cloud's and the field's
        leaves `sc` and the check frames' targets, TF32 off inside them
        only."""
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
            return d4_ref.reference_steps(sc, steps, self.cfg["sh_degree"],
                                          self.cfg)
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = flags


def _moments(state):
    out = {f"bg/{g}": state.opt[g].mu for g in scene.PARAMS}
    out["env_map"] = state.opt["sky_sphere"].mu
    for k in FIELD:
        out[f"field/{k}"] = state.opt[f"field_{k}"].mu
    return out


def _params(state):
    out = {f"bg/{g}": getattr(state.store.params, g) for g in scene.PARAMS}
    out["env_map"] = state.env_map
    for k in FIELD:
        out[f"field/{k}"] = state.field[k]
    return out
