#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU and hold its kernels to their
plain PyTorch versions.

    python3 chip_smoke.py            # the full-width run (needs one CUDA card)

Phases, each printing one JSON line:
  1. device     torch.cuda.is_available() or exit 1; the card's name and
                power limit from nvidia-smi (also printed raw on its own line);
  2. build      nvcc builds every kernel of csrc/ (one process per source,
                all started together) into build/torch_kernels/;
  3. reference  a small scene graph rendered on the card agrees with the
                same render on the CPU (the plain versions of every kernel),
                and one training step and one refinement pass of it from the
                same state, jitter and noise agree too (loss, every gradient,
                the densification statistics, the refine pass's counts);
  4. main_path  the flagship scene graph at full width (1,048,576 background
                gaussians in bench.py's street corridor, 4 vehicles x 65,536
                gaussians with Fourier dim 5 on 3-frame tracks, SH degree 3,
                a 6x1024x1024x3 sky cubemap), weights made from --seed and
                carried in through engine.checkpoints.store_from_numpy,
                rendered by models.scene_graph.forward_scene(training=False,
                eval_extras=True) for 4 cameras of 1600x1056 along the
                corridor. Every launch counter is set to 0 just before the
                frames and read just after;
  5. profile    one frame under torch.profiler: the device's busy share
                and the ops that take its time;
  6. stages     device time of each stage of one render (CUDA events);
  7. train_path the flagship scene graph as a train state (the same weights
                through engine.checkpoints.train_state_from_numpy, one slot in
                16 left free as a trainer's headroom, a target image and a
                semantic map from --seed): 4 steps of
                engine.scene_train_step.scene_train_step with
                subset_accs=False, 1 step with subset_accs=True, from step
                3600 (the SH degree has reached 3, so features_rest trains),
                then one scene_refine_step at a step that densifies. Every launch
                counter is set to 0 just before the steps and read just after;
  8. train_profile / train_stages  one step under torch.profiler, and the
                device time of the stages of one step (CUDA events);
  9. kernels    every kernel of both paths, on the inputs captured from one
                full-width render and one full-width backward, against its
                plain version, with its time, the plain version's time, a
                PyTorch library call's time where one computes the same
                function, and its bound.
The line before the last is the `kernels` JSON; the last line is
{"ok": true, "device": {...}}. Any failure raises and exits non-zero.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))

import torch  # noqa: E402

from street_gaussians_ns_tpu_torch.core.cameras import (  # noqa: E402
    Camera, draw_pixel_jitter)
from street_gaussians_ns_tpu_torch.core.cameras import viewmat_from_c2w  # noqa: E402
from street_gaussians_ns_tpu_torch.core.projection import (  # noqa: E402
    coverage_q, project)
from street_gaussians_ns_tpu_torch.engine import optimizers  # noqa: E402
from street_gaussians_ns_tpu_torch.engine import scene_train_step as sts  # noqa: E402
from street_gaussians_ns_tpu_torch.engine.checkpoints import (  # noqa: E402
    store_from_numpy, tracks_from_numpy, train_state_from_numpy)
from street_gaussians_ns_tpu_torch.models import refinement  # noqa: E402
from street_gaussians_ns_tpu_torch.models.scene_graph import (  # noqa: E402
    SceneGraphConfig, compose, forward_scene, scene_loss_dict)
from street_gaussians_ns_tpu_torch.models.splatfacto import (  # noqa: E402
    SplatfactoConfig, sh_colors, sky_color)
from street_gaussians_ns_tpu_torch.ops import _cuda  # noqa: E402
from street_gaussians_ns_tpu_torch.ops import (  # noqa: E402
    composite, expand, scan, segreduce, tiles)
from street_gaussians_ns_tpu_torch.ops.render import RenderConfig, render  # noqa: E402

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
FP32_OPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
# Kernel D per evaluated (pixel, pair): 2 subtractions, 7 for sigma, the
# exp, 4 for alpha (max, negate, multiply, clamp), 2 skip compares.
D_OPS_PER_EVAL = 16
# Kernel E per evaluated (pixel, pair): kernel D's 16, counted as D counts
# them. Only an evaluation that contributes (passes both skip tests before
# its pixel saturates) needs the rest: next_T and w (3), the colours'
# gradient and g . colour (12 at 4 channels), the prefix and the suffix
# (3), 1 - alpha and dL/dalpha (6), the opacity and sigma gradients (3),
# the five geometry terms (14), and one add per gradient row for the sum
# over the tile's pixels (10).
E_OPS_PER_CONTRIB = 51
# First step of the training phase: the SH degree has reached 3 (one degree
# per 1,000 steps), so features_rest is live in the backward and in Adam as
# in most of a 30k-step run; below stop_split_at, and the refinement pass
# after the phase's steps densifies.
TRAIN_STEP0 = 3600
NUM_TRAIN_DATA = 100               # images of the (synthetic) clip
SH_C0 = 0.28209479177387814
REPO = Path(__file__).resolve().parent


@dataclasses.dataclass(frozen=True)
class Size:
    """The scene and camera widths of a run."""

    bg: int = 1 << 20              # background gaussians
    objects: int = 4               # tracked vehicles
    per_object: int = 1 << 16      # gaussians per vehicle
    env_res: int = 1024            # sky cubemap face resolution
    width: int = 1600
    height: int = 1056
    focal: float = 1200.0
    frames: int = 4


FLAGSHIP = Size()
REPS = 20                          # launches per kernel timing
E_PLAIN_DEPTH = 3072               # deepest tile the plain backward replays


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


# ---------------------------------------------------------------------------
# The scene, made with numpy from a seed.
# ---------------------------------------------------------------------------

def _quats(rng, n):
    q = rng.standard_normal((n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def make_scene(seed: int, n_bg: int, n_obj: int, per_obj: int, env_res: int,
               sh_degree: int = 3, obj_fourier: int = 5):
    """(store arrays keyed as a JAX SceneGraphStore, tracks arrays). The
    background follows bench.py's street corridor: xy ~ N(0, [8, 2]),
    z = -(U^1.5) 60 - 2; vehicles are box-shaped clouds on 3-frame tracks
    driving along the corridor."""
    rng = np.random.default_rng(seed)
    k = (sh_degree + 1) ** 2 - 1
    f32 = np.float32

    def gaussians(n, means, log_scale_mu, fourier, lead=()):
        sh = lead + (n,)
        rgb = rng.random(sh + (3,), dtype=f32)
        dc = np.zeros(sh + (fourier, 3), f32)
        dc[..., 0, :] = (rgb - 0.5) / SH_C0
        if fourier > 1:
            dc[..., 1:, :] = 0.2 * rng.standard_normal(
                sh + (fourier - 1, 3)).astype(f32)
        op = rng.random(sh, dtype=f32) * 0.8 + 0.1
        return {
            "params/means": means.astype(f32),
            "params/scales": (rng.standard_normal(sh + (3,)).astype(f32)
                              * 0.5 + log_scale_mu),
            "params/quats": _quats(rng, int(np.prod(sh))).reshape(sh + (4,)),
            "params/features_dc": dc,
            "params/features_rest": 0.05 * rng.standard_normal(
                sh + (k, 3)).astype(f32),
            "params/opacities": np.log(op / (1.0 - op))[..., None].astype(f32),
            "active": np.ones(sh, bool),
        }

    xy = rng.standard_normal((n_bg, 2)).astype(f32) * np.array([8.0, 2.0], f32)
    z = -(rng.random(n_bg, dtype=f32) ** 1.5) * 60.0 - 2.0
    bg = gaussians(n_bg, np.concatenate([xy, z[:, None]], 1), -3.3, 1)
    obj_means = (rng.standard_normal((n_obj, per_obj, 3)).astype(f32)
                 * np.array([0.6, 0.4, 1.2], f32))
    obj = gaussians(per_obj, obj_means, -3.8, obj_fourier, lead=(n_obj,))

    n_frames = 3
    lanes = np.array([-3.0, 3.0, -1.5, 1.5], f32)
    centers = np.zeros((n_frames, n_obj, 3), f32)
    quats = np.zeros((n_frames, n_obj, 4), f32)
    for f in range(n_frames):
        for o in range(n_obj):
            centers[f, o] = (lanes[o % 4], -1.2, -(10.0 + 9.0 * o) - 1.5 * f)
            yaw = 0.1 * (o - 1.5) + 0.05 * f
            quats[f, o] = (math.cos(yaw / 2), 0.0, math.sin(yaw / 2), 0.0)
    tracks = {
        "times": np.arange(n_frames, dtype=f32),
        "centers": centers,
        "quats": quats,
        "valid": np.ones((n_frames, n_obj), bool),
        "sizes": np.tile(np.array([[1.2, 0.8, 2.4]], f32), (n_obj, 1)),
        "obj_first": np.zeros((n_obj,), f32),
        "obj_last": np.full((n_obj,), n_frames - 1, f32),
    }
    store = {f"background/{k_}": v for k_, v in bg.items()}
    store.update({f"objects/{k_}": v for k_, v in obj.items()})
    store["env_map"] = rng.random((6, env_res, env_res, 3), dtype=f32)
    store["delta_center"] = 0.05 * rng.standard_normal(
        (n_frames, n_obj, 3)).astype(f32)
    store["delta_yaw"] = 0.02 * rng.standard_normal(
        (n_frames, n_obj)).astype(f32)
    store["delta_rot"] = np.zeros((n_frames, n_obj, 3), f32)
    return store, tracks


def scene_config(sh_degree: int, env_res: int, obj_fourier: int):
    return SceneGraphConfig(
        base=SplatfactoConfig(use_sky_sphere=True, sh_degree=sh_degree,
                              env_map_res=env_res),
        background=SplatfactoConfig(fourier_features_dim=1,
                                    sh_degree=sh_degree,
                                    use_sky_sphere=False),
        object_template=SplatfactoConfig(fourier_features_dim=obj_fourier,
                                         sh_degree=sh_degree,
                                         use_sky_sphere=False))


def cameras(n: int, width: int, height: int, focal: float, device):
    """n cameras stepping down the corridor (-z) at distinct track times;
    time 1.0 is an annotated frame (the exact-frame bbox branch)."""
    times = [0.0, 0.6, 1.0, 1.7, 0.3, 1.3, 0.9, 1.9]
    cams = []
    for i in range(n):
        c2w = np.eye(3, 4, dtype=np.float32)
        c2w[2, 3] = -1.5 * i
        cams.append(Camera.make(focal, focal, width / 2, height / 2, c2w,
                                width, height, time=times[i % len(times)],
                                device=device))
    return cams


def make_batch(seed: int, width: int, height: int, device):
    """A training batch from the seed: a random target image and a
    semantic map whose top third is sky."""
    rng = np.random.default_rng(seed + 7)
    semantic = np.zeros((height, width, 1), np.int32)
    semantic[: height // 3] = 2
    return {"image": torch.from_numpy(rng.random(
                (height, width, 3), dtype=np.float32)).to(device),
            "semantic": torch.from_numpy(semantic).to(device)}


def train_arrays(store_np: dict, step: int, every: int = 16) -> dict:
    """The scene's arrays under a train checkpoint's keys, with one slot
    in `every` marked inactive: the headroom a trainer keeps for the
    children of a refinement pass."""
    arrays = {f"store/{k}": v for k, v in store_np.items()}
    for part in ("background", "objects"):
        active = store_np[f"{part}/active"].copy()
        active[..., every - 1::every] = False
        arrays[f"store/{part}/active"] = active
    arrays["step"] = np.asarray(step, np.int32)
    return arrays


def size_capacity(store, tracks, cfg, cams, step: int = 8192):
    """max_pairs / max_rowruns from count_pairs over the cameras (the
    largest of them), rounded up to a multiple of `step`."""
    pairs = rowruns = 0
    for cam in cams:
        flat, active, _ = compose(store, tracks, cam.time, config=cfg)
        op = torch.sigmoid(flat["opacities"][:, 0])
        op = torch.where(active, op, torch.zeros_like(op))
        proj = project(flat["means"], torch.exp(flat["scales"]),
                       flat["quats"], viewmat_from_c2w(cam.c2w), cam.fx,
                       cam.fy, cam.cx, cam.cy, cam.width, cam.height,
                       opacities=op)
        proj = dataclasses.replace(proj, num_tiles_hit=torch.where(
            active, proj.num_tiles_hit, 0))
        p, r = tiles.count_pairs(proj, cam.width, cam.height, 16, opacities=op)
        pairs, rowruns = max(pairs, int(p)), max(rowruns, int(r))

    def up(v):
        return max(step, -(-v // step) * step)
    return up(pairs), up(rowruns), pairs, rowruns


# ---------------------------------------------------------------------------
# Timing and bounds.
# ---------------------------------------------------------------------------

def time_ms(fn, reps: int, warmup: int = 1) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: float, ops: float = 0.0):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


class Recorder:
    """Records the arguments of a module-level kernel wrapper while a
    render runs (those calls count as launches of that render only)."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.orig = getattr(module, name)
        self.calls = []

    def __enter__(self):
        def rec(*args, **kw):
            self.calls.append((args, kw))
            return self.orig(*args, **kw)
        setattr(self.module, self.name, rec)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


# ---------------------------------------------------------------------------
# Phases.
# ---------------------------------------------------------------------------

def phase_device():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    line = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    if smi.returncode != 0 or not line:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr}")
    print(line, flush=True)
    emit("device", name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=line,
         torch=torch.__version__, cuda=torch.version.cuda)
    return line


def phase_build():
    t0 = time.perf_counter()
    _cuda.build_all()
    dt = time.perf_counter() - t0
    for k in _cuda.KERNELS:
        regs = [ln.strip() for ln in k.build_log.splitlines()
                if "registers" in ln or "spill" in ln]
        print(f"[build] {k.source}: " + " | ".join(regs), file=sys.stderr)
    emit("build", seconds=round(dt, 3),
         kernels=[k.name for k in _cuda.KERNELS])


def _heads_close(got: dict, want: dict, atol: float):
    errs = {}
    for key, w in want.items():
        g = got[key].detach().cpu()
        if g.shape != w.shape:
            raise AssertionError(f"{key}: shape {tuple(g.shape)} vs "
                                 f"{tuple(w.shape)}")
        if key.endswith("depth"):
            acc_key = {"depth": "accumulation",
                       "object_depth": "object_acc",
                       "background_depth": "background_acc"}[key]
            m = want[acc_key] > 1e-3
            err = ((g - w).abs() / w.abs().clamp(min=1e-6))[m]
            err = float(err.max()) if err.numel() else 0.0
            if err > 1e-4:
                raise AssertionError(f"{key}: max relative error {err}")
        else:
            err = float((g - w).abs().max())
            if err > atol:
                raise AssertionError(f"{key}: max abs error {err} > {atol}")
        errs[key] = err
    return errs


def phase_reference(seed: int):
    """A small scene graph (64x48) rendered on the card (the kernels) and
    on the CPU (their plain versions) must agree: rgb and accumulations
    at atol 2e-5, depths at rtol 1e-4 where the accumulation > 1e-3."""
    store_np, tracks_np = make_scene(seed + 1, 600, 2, 80, 16, sh_degree=1)
    cfg = scene_config(1, 16, 5)
    rcfg = RenderConfig(max_pairs=1 << 14)
    outs = {}
    for dev in ("cpu", "cuda"):
        store = store_from_numpy(store_np, cfg, device=dev)
        tracks = tracks_from_numpy(tracks_np, device=dev)
        cam = Camera.make(60.0, 60.0, 32.0, 24.0,
                          np.eye(3, 4, dtype=np.float32), 64, 48, time=0.6,
                          device=dev)
        with warnings.catch_warnings():
            warnings.simplefilter("error", RuntimeWarning)
            outs[dev] = forward_scene(store, tracks, cam, 0, cfg, rcfg,
                                      eval_extras=True)[0]
    want = outs["cpu"]
    errs = _heads_close(outs["cuda"], want, atol=2e-5)
    if float(want["accumulation"].max()) <= 0.3:
        raise AssertionError("reference scene renders almost nothing")
    emit("reference", size=[64, 48], max_err=errs)


def _all_grads(grads: dict):
    """(name, tensor) over every gradient of scene_loss_and_grads."""
    for name, g in grads["gauss"].items():
        for k, t in g.items():
            yield f"{name}/{k}", t
    for name, t in grads["bbox"].items():
        yield f"bbox/{name}", t
    yield "xys", grads["xys"]
    if grads["env_map"] is not None:
        yield "env_map", grads["env_map"]


def phase_reference_train(seed: int, devices=("cpu", "cuda")):
    """The training slice at a small size on the card against the CPU
    (the plain versions), from the same state, sky jitter and split noise:
    one step's loss and gradients with subset_accs=True past stop_split_at
    (the entropy loss live), then one step below it (the statistics
    accumulate) and one refinement pass. The loss at atol 2e-5, every
    gradient at 1e-4 of its group's largest |g|, visibility counts,
    screen sizes and every refine count exact, the accumulated gradient
    norms at the gradient tolerance."""
    store_np, tracks_np = make_scene(seed + 1, 600, 2, 80, 16, sh_degree=1)
    cfg = scene_config(1, 16, 5)
    rcfg = RenderConfig(max_pairs=1 << 14)
    late = cfg.background.stop_split_at + 1
    rng = np.random.default_rng(seed + 3)
    jitter = rng.random((2, 48, 64), dtype=np.float32)
    res = {}
    for dev in devices:
        tracks = tracks_from_numpy(tracks_np, device=dev)
        cam = Camera.make(60.0, 60.0, 32.0, 24.0,
                          np.eye(3, 4, dtype=np.float32), 64, 48, time=0.6,
                          device=dev)
        batch = make_batch(seed, 64, 48, dev)
        jit = torch.from_numpy(jitter).to(dev)
        state = train_state_from_numpy(train_arrays(store_np, late), cfg,
                                       device=dev, seed=seed)
        with warnings.catch_warnings():
            warnings.simplefilter("error", RuntimeWarning)
            total, _, _, _, grads = sts.scene_loss_and_grads(
                state, tracks, cam, batch, cfg, rcfg, subset_accs=True,
                jitter=jit)
            state = dataclasses.replace(state, step=TRAIN_STEP0)
            state, metrics = sts.scene_train_step(
                state, tracks, cam, batch, cfg, rcfg, subset_accs=True,
                jitter=jit)
        noise = {"bg": refinement.draw_split_noise(
                     cfg.background, state.store.background.capacity,
                     torch.Generator().manual_seed(seed), "cpu").to(dev),
                 "obj": torch.stack([refinement.draw_split_noise(
                     cfg.object_template, state.store.objects.capacity,
                     torch.Generator().manual_seed(seed + 1 + o), "cpu")
                     for o in range(state.store.num_objects)]).to(dev)}
        refined, info = sts.scene_refine_step(state, cfg, NUM_TRAIN_DATA, 64,
                                              noise=noise)
        res[dev] = dict(
            loss=float(total), step_loss=float(metrics["loss"]),
            grads={k: v.cpu() for k, v in _all_grads(grads)},
            stats={f"{part}/{k}": getattr(getattr(state.store, part), k).cpu()
                   for part in ("background", "objects")
                   for k in ("xys_grad_norm", "vis_counts", "max_2dsize")},
            info={k: int(v) for k, v in info.items()},
            active=int(refined.store.background.active.sum()))
    want = res[devices[0]]
    got = res[devices[-1]]
    errs = {"loss": abs(got["loss"] - want["loss"]),
            "step_loss": abs(got["step_loss"] - want["step_loss"])}
    if max(errs.values()) > 2e-5:
        raise AssertionError(f"reference train: loss differs {errs}")
    for k, w in want["grads"].items():
        top = float(w.abs().max())
        err = float((got["grads"][k] - w).abs().max())
        if k.startswith("bbox/"):
            if top != 0.0 or err != 0.0:
                raise AssertionError(f"reference train: {k} must be zero")
            continue
        if not top > 0 or err > 1e-4 * top:
            raise AssertionError(f"reference train: gradient {k} differs "
                                 f"by {err} (largest |g| {top})")
        errs[f"grad {k}"] = err / top
    g_top = float(want["grads"]["xys"].abs().max())
    for k, w in want["stats"].items():
        err = float((got["stats"][k] - w).abs().max())
        if err > (1e-4 * g_top if k.endswith("xys_grad_norm") else 0.0):
            raise AssertionError(f"reference train: stat {k} differs by "
                                 f"{err}")
    if float(want["stats"]["background/vis_counts"].sum()) <= 0:
        raise AssertionError("reference train: nothing visible")
    if got["info"] != want["info"] or got["active"] != want["active"]:
        raise AssertionError(f"reference train: refine counts differ: "
                             f"{got['info']} vs {want['info']}")
    if want["info"]["bg_refine_splits_count"] <= 0:
        raise AssertionError("reference train: the refine pass split "
                             "nothing")
    emit("reference_train", size=[64, 48], tolerance="loss atol 2e-5; "
         "gradients 1e-4 of the group's largest |g|; counts exact",
         max_err=errs, refine=want["info"])


def phase_main(seed: int, size: Size = FLAGSHIP, dev="cuda"):
    """The main path. dev="cpu" rehearses it on the plain versions (no
    launch counts there)."""
    t0 = time.perf_counter()
    store_np, tracks_np = make_scene(seed, size.bg, size.objects,
                                     size.per_object, size.env_res)
    cfg = scene_config(3, size.env_res, 5)
    store = store_from_numpy(store_np, cfg, device=dev)
    tracks = tracks_from_numpy(tracks_np, device=dev)
    del store_np
    cams = cameras(size.frames, size.width, size.height, size.focal, dev)
    max_pairs, max_rowruns, need_p, need_r = size_capacity(
        store, tracks, cfg, cams)
    rcfg = RenderConfig(max_pairs=max_pairs, max_rowruns=max_rowruns)
    setup_s = time.perf_counter() - t0
    n_gauss = store.background.capacity + (store.num_objects
                                           * store.objects.capacity)

    def frame(cam):
        with warnings.catch_warnings():
            warnings.simplefilter("error", RuntimeWarning)
            return forward_scene(store, tracks, cam, 0, cfg, rcfg,
                                 eval_extras=True)

    frame(cams[0])                     # warm-up: allocator, cub init
    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    sync()
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    for k in _cuda.KERNELS:
        k.launches = 0
    times, frames = [], []
    for cam in cams:
        t = time.perf_counter()
        outputs, out, boxes = frame(cam)
        sync()
        times.append((time.perf_counter() - t) * 1e3)
        frames.append((outputs, out))
    launches = {k.name: k.launches for k in _cuda.KERNELS}
    peak = torch.cuda.max_memory_allocated() if dev == "cuda" else None

    per_frame = {"flat_scan": 9, "expand_ragged": 6, "pack_feat_cols": 3,
                 "composite_fwd": 3}
    for name, n in per_frame.items():
        if dev == "cuda" and launches[name] != n * len(cams):
            raise AssertionError(f"{name} launched {launches[name]} times "
                                 f"over {len(cams)} frames, expected "
                                 f"{n} per frame")
    heads = ("rgb", "accumulation", "depth", "sky", "object_acc",
             "background_acc", "background_rgb", "object_rgb",
             "background_depth", "object_depth")
    acc_max = []
    for outputs, out in frames:
        for h in heads:
            v = outputs[h]
            if not bool(torch.isfinite(v).all()):
                raise AssertionError(f"head {h} has non-finite values")
        rgb = outputs["rgb"]
        if tuple(rgb.shape) != (size.height, size.width, 3):
            raise AssertionError(f"rgb shape {tuple(rgb.shape)}")
        if float(rgb.min()) < 0.0 or float(rgb.max()) > 1.0:
            raise AssertionError("rgb outside [0, 1]")
        acc_max.append(float(outputs["accumulation"].max()))
        if acc_max[-1] <= 0.5:
            raise AssertionError(f"accumulation max {acc_max[-1]} <= 0.5")
        if int(out.bins.num_pairs) > max_pairs:
            raise AssertionError("pair capacity overflow")
        if int(out.bins.num_rowruns) > max_rowruns:
            raise AssertionError("row-run capacity overflow")
    ms = float(np.median(times))
    emit("main_path", gaussians=n_gauss, frames=len(cams),
         size=[size.width, size.height], max_pairs=max_pairs,
         max_rowruns=max_rowruns, needed_pairs=need_p, needed_rowruns=need_r,
         num_pairs=[int(o.bins.num_pairs) for _, o in frames],
         ms_per_frame=times, ms_per_frame_median=ms,
         mpix_per_s=size.width * size.height / 1e6 / (ms / 1e3),
         max_memory_allocated=peak, setup_seconds=setup_s,
         accumulation_max=acc_max, launches=launches)
    return store, tracks, cfg, rcfg, cams[0], launches


def phase_train(seed: int, tracks, cfg, rcfg, cam, size: Size = FLAGSHIP,
                dev="cuda"):
    """The training path: 4 steps with subset_accs=False, 1 step with
    subset_accs=True, one refinement pass. dev="cpu" rehearses it on the
    plain versions (no launch counts there)."""
    t0 = time.perf_counter()
    store_np, _ = make_scene(seed, size.bg, size.objects, size.per_object,
                             size.env_res)
    state = train_state_from_numpy(train_arrays(store_np, TRAIN_STEP0), cfg,
                                   device=dev, seed=seed)
    del store_np
    batch = make_batch(seed, size.width, size.height, dev)
    setup_s = time.perf_counter() - t0
    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    first = state

    def step(st, subset_accs):
        with warnings.catch_warnings():
            warnings.simplefilter("error", RuntimeWarning)
            return sts.scene_train_step(st, tracks, cam, batch, cfg, rcfg,
                                        subset_accs=subset_accs)

    # Warm-up (allocator, cub), and the gradients looked at directly.
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        total, _, _, _, grads = sts.scene_loss_and_grads(
            state, tracks, cam, batch, cfg, rcfg, subset_accs=False,
            jitter=draw_pixel_jitter(cam, state.generator))
    if not math.isfinite(float(total)):
        raise AssertionError(f"train: loss {float(total)}")
    has_grad = {}
    for name, g in _all_grads(grads):
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"train: gradient {name} is not finite")
        has_grad[name] = bool(g.any())
    sh_active = min(TRAIN_STEP0 // cfg.background.sh_degree_interval,
                    cfg.background.sh_degree)
    if sh_active != cfg.background.sh_degree:
        raise AssertionError(f"train: SH degree {sh_active} at step "
                             f"{TRAIN_STEP0}, the scene's is "
                             f"{cfg.background.sh_degree}")
    dead = [name for name in ("features_rest/bg", "features_rest/obj")
            if not has_grad[name]]
    if dead:
        raise AssertionError(f"train: no gradient in {dead} at the full SH "
                             f"degree")
    grad_absmax = {name: float(g.abs().max())
                   for name, g in _all_grads(grads)}
    del grads
    sync()
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    for k in _cuda.KERNELS:
        k.launches = 0
    times, losses, pairs = [], [], []
    plan = [False, False, False, False, True]
    for subset_accs in plan:
        t = time.perf_counter()
        state, metrics = step(state, subset_accs)
        sync()
        times.append((time.perf_counter() - t) * 1e3)
        losses.append(float(metrics["loss"]))
        pairs.append(int(metrics["num_pairs"]))
        if not math.isfinite(losses[-1]):
            raise AssertionError(f"train: loss {losses[-1]} at step "
                                 f"{state.step - 1}")
        if (pairs[-1] > rcfg.max_pairs
                or int(metrics["num_rowruns"]) > rcfg.rowrun_capacity):
            raise AssertionError("train: render capacity overflow")
    t = time.perf_counter()
    refined, info = sts.scene_refine_step(state, cfg, NUM_TRAIN_DATA,
                                          max(cam.width, cam.height))
    sync()
    refine_ms = (time.perf_counter() - t) * 1e3
    launches = {k.name: k.launches for k in _cuda.KERNELS}
    peak = torch.cuda.max_memory_allocated() if dev == "cuda" else None

    # A step with subset_accs renders three times; the loss reads the full
    # render and the object-only accumulation, so two of them run backward.
    renders = sum(3 if s else 1 for s in plan)
    backwards = sum(2 if s else 1 for s in plan)
    expected = {"flat_scan": 3 * renders, "expand_ragged": 2 * renders,
                "pack_feat_cols": renders, "composite_fwd": renders,
                "composite_bwd": backwards, "rank_rowsum": backwards}
    for name, n in expected.items():
        if dev == "cuda" and launches[name] != n:
            raise AssertionError(f"train: {name} launched {launches[name]} "
                                 f"times over {renders} renders and "
                                 f"{backwards} backward passes, expected "
                                 f"{n}")

    def params_of(st):
        out = {}
        for name in sts.GAUSSIAN_GROUPS:
            for k, t_ in sts._gaussian_group_params(st.store, name).items():
                out[f"{name}/{k}"] = t_
        out["env_map"] = st.store.env_map
        return out

    moved = {}
    for name, new in params_of(state).items():
        if not bool(torch.isfinite(new).all()):
            raise AssertionError(f"train: parameter {name} is not finite")
        moved[name] = bool((new != params_of(first)[name]).any())
        if has_grad[name] and not moved[name]:
            raise AssertionError(f"train: group {name} has a gradient and "
                                 f"did not move")
    for name, st in state.opt.items():
        for leaf in (st.mu, st.nu):
            for t_ in (leaf.values() if isinstance(leaf, dict) else [leaf]):
                if not bool(torch.isfinite(t_).all()):
                    raise AssertionError(f"train: Adam moments of {name} "
                                         f"are not finite")
    info = {k: int(v) for k, v in info.items()}
    n_active = int(refined.store.background.active.sum()
                   + refined.store.objects.active.sum())
    if info["bg_gaussian_count"] + info["obj_gaussian_count"] != n_active:
        raise AssertionError("train: the refine pass's count disagrees "
                             "with its active masks")
    if info["bg_refine_splits_count"] + info["bg_refine_dups_count"] <= 0:
        raise AssertionError("train: the refine pass densified nothing")
    if float(state.store.background.vis_counts.max()) != len(plan):
        raise AssertionError("train: the densification statistics did not "
                             "accumulate over the steps")
    ms = float(np.median(times[:4]))
    emit("train_path", steps=len(plan), renders=renders,
         backward_passes=backwards,
         first_step=TRAIN_STEP0, sh_degree_active=sh_active,
         size=[size.width, size.height],
         gaussians_active=int(first.store.background.active.sum()
                              + first.store.objects.active.sum()),
         ms_per_step=times, ms_per_step_median=ms,
         steps_per_s=1e3 / ms, ms_step_subset_accs=times[4],
         loss_per_step=losses, num_pairs=pairs,
         max_memory_allocated=peak, setup_seconds=setup_s,
         grad_absmax=grad_absmax, moved=moved, refine_ms=refine_ms,
         refine=info, gaussians_after_refine=n_active, launches=launches)
    return state, batch, launches


def capture_train(state, tracks, cfg, rcfg, cam, batch):
    """Inputs of kernels E and F in one full-width backward (one step's
    full render), with the step's results."""
    jitter = draw_pixel_jitter(cam, state.generator)
    recs = [Recorder(composite, "composite_bwd"),
            Recorder(composite, "rank_rowsum")]
    for r in recs:
        r.__enter__()
    try:
        res = sts.scene_loss_and_grads(state, tracks, cam, batch, cfg, rcfg,
                                       subset_accs=False, jitter=jitter)
    finally:
        for r in recs:
            r.__exit__()
    return {r.name: r.calls for r in recs}, jitter, res


def phase_train_stages(state, tracks, cfg, rcfg, cam, batch, calls, jitter,
                       res, reps: int = 3):
    """Device time of the stages of one training step (CUDA events), the
    pieces of the backward on the inputs captured from it."""
    _, _, outputs, rout, grads = res
    (bwd_args, _), = calls["composite_bwd"]
    feat, ts, tc, ntx, nc, g_accum, g_t, tfin, ncon, accum = bwd_args
    n = rout.bins.depth_order.shape[0]
    gpair = composite.composite_bwd(*bwd_args)
    nvis = torch.minimum(ncon.amax(dim=1), tc)
    pair = composite._visited_pairs(ts, nvis)
    kk = composite.K
    g = gpair[pair // kk, :11, pair % kk]
    rank_s, perm = torch.sort(g[:, 10].to(torch.int32), stable=True)
    rows11 = g.index_select(0, perm).T.contiguous()
    rank_sums = segreduce.rank_rowsum(rows11, rank_s, n)
    store = state.store

    def adam():
        for name in sts.GAUSSIAN_GROUPS:
            c = optimizers.DEFAULT_GROUPS[name]
            optimizers.adam_update(
                grads["gauss"][name], state.opt[name],
                sts._gaussian_group_params(store, name),
                optimizers.schedule(c, state.step), c)
        c = optimizers.DEFAULT_GROUPS["sky_sphere"]
        optimizers.adam_update(grads["env_map"], state.opt["sky_sphere"],
                               store.env_map,
                               optimizers.schedule(c, state.step), c)

    def fwd():
        with torch.no_grad():
            return forward_scene(store, tracks, cam, state.step, cfg, rcfg,
                                 training=True, subset_accs=False,
                                 jitter=jitter)

    def gather_visited():
        pr = composite._visited_pairs(ts, nvis)
        return gpair[pr // kk, :11, pr % kk]

    cap_bg = store.background.capacity
    stages = {
        "forward_scene(training)": fwd,
        "scene_loss_dict": lambda: scene_loss_dict(outputs, batch, cfg,
                                                   state.step),
        "loss_and_grads": lambda: sts.scene_loss_and_grads(
            state, tracks, cam, batch, cfg, rcfg, subset_accs=False,
            jitter=jitter),
        "bwd.composite_bwd": lambda: composite.composite_bwd(*bwd_args),
        "bwd.gather_visited": gather_visited,
        "bwd.rank_sort": lambda: g.index_select(0, torch.sort(
            g[:, 10].to(torch.int32), stable=True).indices).T.contiguous(),
        "bwd.rank_rowsum": lambda: segreduce.rank_rowsum(rows11, rank_s, n),
        "bwd.unsort": lambda: composite._unsort_rank_sums(
            rank_sums, rout.bins.depth_order),
        "bwd.reduce(compact)": lambda: composite._reduce_pair_grads_ranked(
            gpair, ts, nvis, rout.bins.depth_order, n),
        "adam(7 groups)": adam,
        "update_stats": lambda: refinement.update_stats(
            store.background, grads["xys"][:cap_bg],
            rout.projected.radii[:cap_bg], max(cam.width, cam.height),
            state.step, cfg.background),
        "scene_train_step": lambda: sts.scene_train_step(
            state, tracks, cam, batch, cfg, rcfg, subset_accs=False,
            jitter=jitter),
    }
    ms = {k: time_ms(fn, reps) for k, fn in stages.items()}
    ms["backward(derived)"] = (ms["loss_and_grads"]
                               - ms["forward_scene(training)"]
                               - ms["scene_loss_dict"])
    ms["bwd.autograd_rest(derived)"] = (ms["backward(derived)"]
                                        - ms["bwd.composite_bwd"]
                                        - ms["bwd.reduce(compact)"])
    emit("train_stages", ms=ms, pairs_visited=int(pair.shape[0]),
         pairs_in_stream=int(tc.sum()), max_pairs=rcfg.max_pairs)


def phase_profile(phase: str, fn, top: int = 15):
    """One call of `fn` (an eval frame, a train step) under
    torch.profiler: device time by kernel, and the device's busy share of
    the call's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    ops, busy = [], 0.0
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if e.device_type == DeviceType.CUDA:
            busy += us / 1e3           # the kernels themselves
        elif us > 0:
            ops.append((us / 1e3, e.count, e.key))   # the ops launching them
    ops.sort(reverse=True)
    emit(phase, wall_ms=wall_ms, device_busy_ms=busy,
         device_idle_share=(1.0 - busy / wall_ms) if busy else None,
         top_ops=[{"ms": ms, "calls": n, "name": name[:100]}
                  for ms, n, name in ops[:top]])


def phase_stages(store, tracks, cfg, rcfg, cam, reps: int = 5):
    """Device time of each stage of one eval frame (CUDA events): the
    per-frame work (compose, SH colours, sky) once, then the stages of the
    full render, whose sum is one of the frame's three renders."""
    flat, active, _ = compose(store, tracks, cam.time, config=cfg)
    rgbs = sh_colors(flat["means"], flat["features_dc_t"],
                     flat["features_rest"], cam, 0, cfg.base, training=False)
    op = torch.sigmoid(flat["opacities"][:, 0])
    op = torch.where(active, op, torch.zeros_like(op))
    scales = torch.exp(flat["scales"])
    vm = viewmat_from_c2w(cam.c2w)

    def proj_fn():
        p = project(flat["means"], scales, flat["quats"], vm, cam.fx, cam.fy,
                    cam.cx, cam.cy, cam.width, cam.height, opacities=op)
        return dataclasses.replace(p, num_tiles_hit=torch.where(
            active, p.num_tiles_hit, 0), radii=torch.where(active, p.radii, 0))

    proj = proj_fn()
    colors4 = torch.cat([rgbs, proj.depths[:, None]], dim=-1)
    depth_key = torch.where(proj.num_tiles_hit > 0, proj.depths,
                            torch.full_like(proj.depths, float("inf")))
    sorted_cols = tiles._depth_sort_cols(proj.xys, proj.conics, depth_key,
                                         colors4, op, True)
    fs = sorted_cols[2]
    box_s = proj.tile_box.index_select(0, sorted_cols[1])
    nty = -(-cam.height // 16)
    ntx = -(-cam.width // 16)
    bin_args = (proj.xys, proj.conics, proj.tile_box, depth_key, colors4,
                op, cam.width, cam.height, 16, rcfg.max_pairs,
                rcfg.max_rowruns)
    bins, feats = tiles.bin_and_pack(*bin_args, last_color_is_depth=True)
    feat = composite.pack_feat_cols(feats, rcfg.max_pairs)
    stages = {
        "compose": lambda: compose(store, tracks, cam.time, config=cfg),
        "sh_colors": lambda: sh_colors(flat["means"], flat["features_dc_t"],
                                       flat["features_rest"], cam, 0,
                                       cfg.base, training=False),
        "sky_color": lambda: sky_color(store.env_map, cam),
        "project": proj_fn,
        "bin.depth_sort": lambda: tiles._depth_sort_cols(
            proj.xys, proj.conics, depth_key, colors4, op, True),
        "bin.row_trim": lambda: tiles._row_trim_counts(
            fs[:, 2:5], fs[:, 0:2], box_s, 16, nty,
            coverage_q(fs[:, 5])),
        "bin_and_pack": lambda: tiles.bin_and_pack(
            *bin_args, last_color_is_depth=True),
        "pack_feat_cols": lambda: composite.pack_feat_cols(
            feats, rcfg.max_pairs),
        "composite_fwd": lambda: composite.composite_fwd(
            feat, bins.tile_start, bins.tile_count, ntx, 4),
        "rasterize_tiles_fused": lambda: composite.rasterize_tiles_fused(
            proj, colors4, op, cam.width, cam.height, 16,
            torch.zeros(4, device=op.device), rcfg.max_pairs,
            rcfg.max_rowruns, last_color_is_depth=True),
        "render": lambda: render(flat["means"], scales, flat["quats"], op,
                                 rgbs, cam, rcfg, training=False,
                                 active=active),
    }
    emit("stages", ms={k: time_ms(fn, reps) for k, fn in stages.items()})


def capture(store, tracks, cfg, rcfg, cam):
    """Inputs of every kernel in one full-width render (the full render of
    forward_scene on `cam`)."""
    flat, active, _ = compose(store, tracks, cam.time, config=cfg)
    rgbs = sh_colors(flat["means"], flat["features_dc_t"],
                     flat["features_rest"], cam, 0, cfg.base, training=False)
    op = torch.sigmoid(flat["opacities"][:, 0])
    op = torch.where(active, op, torch.zeros_like(op))
    recs = [Recorder(scan, "cumsum_flat"), Recorder(expand, "expand_ragged"),
            Recorder(composite, "pack_feat_cols"),
            Recorder(composite, "composite_fwd")]
    for r in recs:
        r.__enter__()
    try:
        render(flat["means"], torch.exp(flat["scales"]), flat["quats"], op,
               rgbs, cam, rcfg, training=False, active=active)
    finally:
        for r in recs:
            r.__exit__()
    return {r.name: r.calls for r in recs}


def _max_err(a, b):
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def phase_kernels(calls, launches, train_launches, reps: int = REPS):
    rows = []
    rel = rel_path = lambda p: str(  # noqa: E731
        Path(p).resolve().relative_to(REPO))

    # A: flat scan, the render's 3 int32 cumsums (2 of N, 1 of max_rowruns).
    ms = plain = lib = nbytes = err = 0.0
    shapes = []
    for (x,), _ in calls["cumsum_flat"]:
        err = max(err, _max_err(scan.cumsum_flat(x),
                                scan.cumsum_flat_plain(x)))
        err = max(err, _max_err(scan.cummax_flat(x),
                                scan.cummax_flat_plain(x)))
        xf = x.to(torch.float32)
        err = max(err, _max_err(scan.cummax_flat(xf),
                                scan.cummax_flat_plain(xf)))
        ms += time_ms(lambda: scan.cumsum_flat(x), reps)
        plain += time_ms(lambda: scan.cumsum_flat_plain(x), reps)
        lib += time_ms(lambda: torch.cumsum(x, 0, dtype=torch.int32), reps)
        nbytes += 2 * 4 * x.numel()
        shapes.append(x.numel())
    if err != 0.0:
        raise AssertionError(f"flat_scan differs from torch.cumsum/cummax "
                             f"by {err} (must be exact)")
    b, by = bound(nbytes)
    rows.append(dict(name="flat_scan", route="cuda",
                     source=rel(_cuda.CSRC / scan.KERNEL.source),
                     replaces=scan.KERNEL.replaces,
                     launches=launches["flat_scan"], max_abs_err=err,
                     tolerance="exact", ms=ms, plain_ms=plain,
                     bound_ms=b, bound_by=by, library_ms=lib,
                     library="torch.cumsum", shapes=shapes))

    # B: ragged expansion, the render's 2 calls (16 x N, 14 x max_rowruns).
    ms = plain = lib = nbytes = err = 0.0
    shapes = []
    for (src, starts, ends, out_len), kw in calls["expand_ragged"]:
        got = expand.expand_ragged(src, starts, ends, out_len)
        err = max(err, _max_err(got, expand.expand_ragged_plain(
            src, starts, ends, out_len)))
        ms += time_ms(lambda: expand.expand_ragged(src, starts, ends,
                                                   out_len), reps)
        plain += time_ms(lambda: expand.expand_ragged_plain(
            src, starts, ends, out_len), reps)
        cnt = ends - starts
        lib += time_ms(lambda: torch.repeat_interleave(src, cnt, dim=1),
                       reps)
        c, s = src.shape
        nbytes += 4 * (c * s + 2 * s + c * out_len)
        shapes.append([c, s, out_len])
    if err != 0.0:
        raise AssertionError(f"expand_ragged differs by {err} (must be "
                             f"exact)")
    b, by = bound(nbytes)
    rows.append(dict(name="expand_ragged", route="cuda",
                     source=rel(_cuda.CSRC / expand.KERNEL.source),
                     replaces=expand.KERNEL.replaces,
                     launches=launches["expand_ragged"], max_abs_err=err,
                     tolerance="exact", ms=ms, plain_ms=plain,
                     bound_ms=b, bound_by=by, library_ms=lib,
                     library="torch.repeat_interleave", shapes=shapes))

    # C: feature pack.
    (feats, max_pairs), _ = calls["pack_feat_cols"][0]
    got = composite.pack_feat_cols(feats, max_pairs)
    err = _max_err(got, composite.pack_feat_cols_plain(feats, max_pairs))
    if err != 0.0:
        raise AssertionError(f"pack_feat_cols differs by {err} (must be "
                             f"exact)")
    ms = time_ms(lambda: composite.pack_feat_cols(feats, max_pairs), reps)
    plain = time_ms(lambda: composite.pack_feat_cols_plain(feats,
                                                           max_pairs), reps)
    b, by = bound(4 * (len(feats) * max_pairs + got.numel()))
    rows.append(dict(name="pack_feat_cols", route="cuda",
                     source=rel(_cuda.CSRC / composite.PACK_KERNEL.source),
                     replaces=composite.PACK_KERNEL.replaces,
                     launches=launches["pack_feat_cols"], max_abs_err=err,
                     tolerance="exact", ms=ms, plain_ms=plain, bound_ms=b,
                     bound_by=by, library_ms=None,
                     shapes=[len(feats), max_pairs, list(got.shape)]))

    # D: forward compositor.
    (feat, ts, tc, ntx, nc), _ = calls["composite_fwd"][0]
    evals = torch.zeros((2,), dtype=torch.int64, device=feat.device)
    acc_k, t_k, n_k = composite.composite_fwd(feat, ts, tc, ntx, nc,
                                              evals=evals)
    acc_p, t_p, n_p = composite.composite_fwd_plain(feat, ts, tc, ntx, nc)
    # A pixel whose transmittance lands on the other side of T_EPS ends at
    # another pair; such pixels (at most 0.1%) are counted, the rest held
    # at atol 2e-5.
    same = n_k == n_p
    err = max(_max_err(acc_k[same], acc_p[same]),
              _max_err(t_k[same], t_p[same]))
    n_bad = int((~same).sum())
    n_pix = n_k.numel()
    if err > 2e-5 or n_bad > 1e-3 * n_pix:
        raise AssertionError(f"composite_fwd: max abs error {err} (atol "
                             f"2e-5), n_contrib differs on {n_bad} of "
                             f"{n_pix} pixels (at most 0.1%)")
    ms = time_ms(lambda: composite.composite_fwd(feat, ts, tc, ntx, nc),
                 reps)
    plain = time_ms(lambda: composite.composite_fwd_plain(feat, ts, tc, ntx,
                                                          nc), 1)
    n_eval, n_need = (int(v) for v in evals.tolist())
    # The loop ends early: count the pairs the tiles needed (their 6 + nc
    # used feature rows), not the whole stream.
    nbytes = 4 * (n_need * (6 + nc) + 2 * ts.numel() + acc_k.numel()
                  + t_k.numel() + n_k.numel())
    b, by = bound(nbytes, D_OPS_PER_EVAL * n_eval)
    rows.append(dict(name="composite_fwd", route="cuda",
                     source=rel(_cuda.CSRC / composite.FWD_KERNEL.source),
                     replaces=composite.FWD_KERNEL.replaces,
                     launches=launches["composite_fwd"], max_abs_err=err,
                     tolerance="atol 2e-5 (accum, T); n_contrib <= 0.1%",
                     n_contrib_mismatch=n_bad, ms=ms, plain_ms=plain,
                     bound_ms=b, bound_by=by, library_ms=None,
                     pixel_pair_evals=n_eval, pairs_needed=n_need,
                     pairs_in_stream=int(tc.sum()),
                     bytes_bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                     ops_bound_ms=D_OPS_PER_EVAL * n_eval / FP32_OPS_PER_S
                     * 1e3, tiles=ts.numel(),
                     max_tile_count=int(tc.max())))

    # E: backward compositor, on one full-width backward's inputs. The
    # plain version takes one Python iteration per within-tile pair index,
    # so the comparison leaves out the tiles that visit more than
    # E_PLAIN_DEPTH pairs (their count set to 0 for both versions).
    (bwd_args, _), = calls["composite_bwd"]
    feat, ts, tc, ntx, nc, g_accum, g_t, tfin, ncon, accum = bwd_args
    nvis = torch.minimum(ncon.amax(dim=1), tc)
    shallow = nvis <= E_PLAIN_DEPTH
    tc_cmp = torch.where(shallow, tc, torch.zeros_like(tc))
    cmp_args = (feat, ts, tc_cmp, ntx, nc, g_accum, g_t, tfin, ncon, accum)
    got = composite.composite_bwd(*cmp_args)
    t0 = time.perf_counter()
    want = composite.composite_bwd_plain(
        *cmp_args[:-1], torch.sum(g_accum * accum, dim=-1))
    torch.cuda.synchronize()
    plain = (time.perf_counter() - t0) * 1e3
    top = float(want[:, :10].abs().max())
    err = _max_err(got[:, :10], want[:, :10])
    rel = float(((got[:, :10] - want[:, :10]).abs()
                 / (1e-4 * want[:, :10].abs() + 1e-5 * top)).max())
    if (not top > 0 or rel > 1.0
            or not torch.equal(got[:, 10:], want[:, 10:])):
        raise AssertionError(f"composite_bwd: max abs error {err} at "
                             f"largest |g| {top} (rtol 1e-4, atol 1e-5 of "
                             f"it; rank row exact)")
    evals = torch.zeros((3,), dtype=torch.int64, device=feat.device)
    full = composite.composite_bwd(*bwd_args, evals=evals)
    if not torch.equal(full, composite.composite_bwd(*bwd_args)):
        raise AssertionError("composite_bwd: two launches on the same "
                             "inputs differ")
    ms = time_ms(lambda: composite.composite_bwd(*bwd_args), reps)
    n_eval, n_vis, n_contrib = (int(v) for v in evals.tolist())
    nbytes = 4 * (n_vis * 11 + n_vis * 11 + ts.numel() * 256 * (nc + 4)
                  + 2 * ts.numel())
    ops = D_OPS_PER_EVAL * n_eval + E_OPS_PER_CONTRIB * n_contrib
    b, by = bound(nbytes, ops)
    rows.append(dict(name="composite_bwd", route="cuda",
                     source=rel_path(_cuda.CSRC / composite.BWD_KERNEL.source),
                     replaces=composite.BWD_KERNEL.replaces,
                     launches=train_launches["composite_bwd"],
                     max_abs_err=err,
                     tolerance="rtol 1e-4 + atol 1e-5 of the largest |g|; "
                               "rank row exact; two launches bit-equal",
                     largest_grad=top, ms=ms, plain_ms=plain, bound_ms=b,
                     bound_by=by, library_ms=None,
                     plain_compared_tiles=int(shallow.sum()),
                     tiles=ts.numel(), plain_depth=E_PLAIN_DEPTH,
                     pixel_pair_evals=n_eval,
                     contributing_evals=n_contrib, pairs_visited=n_vis,
                     pairs_in_stream=int(tc.sum()),
                     max_visited_in_a_tile=int(nvis.max()),
                     bytes_bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                     ops_bound_ms=ops / FP32_OPS_PER_S * 1e3))

    # F: rank-keyed row sum, on the same backward's sorted gradient rows.
    (f_args, _), = calls["rank_rowsum"]
    rows11, rank_s, n_out = f_args
    got = segreduce.rank_rowsum(rows11, rank_s, n_out)
    want = segreduce.rank_rowsum_plain(rows11, rank_s, n_out)
    top = float(want.abs().max())
    err = _max_err(got, want)
    relf = float(((got - want).abs()
                  / (1e-4 * want.abs() + 1e-5 * top)).max())
    if not top > 0 or relf > 1.0:
        raise AssertionError(f"rank_rowsum: max abs error {err} at largest "
                             f"|sum| {top} (rtol 1e-4, atol 1e-5 of it)")
    if not torch.equal(got, segreduce.rank_rowsum(rows11, rank_s, n_out)):
        raise AssertionError("rank_rowsum: two launches on the same inputs "
                             "differ")
    ms = time_ms(lambda: segreduce.rank_rowsum(rows11, rank_s, n_out), reps)
    plain = time_ms(lambda: segreduce.rank_rowsum_plain(rows11, rank_s,
                                                        n_out), reps)
    idx = rank_s.to(torch.int64)
    vals = rows11[:10]
    lib = time_ms(lambda: torch.zeros(
        (10, n_out + 1), dtype=torch.float32,
        device=vals.device).index_add_(1, idx, vals), reps)
    p_len = rows11.shape[1]
    b, by = bound(4 * (11 * p_len + 10 * n_out))
    runs = torch.bincount(idx, minlength=n_out + 1)[:n_out]
    rows.append(dict(name="rank_rowsum", route="cuda",
                     source=rel_path(_cuda.CSRC / segreduce.KERNEL.source),
                     replaces=segreduce.KERNEL.replaces,
                     launches=train_launches["rank_rowsum"], max_abs_err=err,
                     tolerance="rtol 1e-4 + atol 1e-5 of the largest |sum|; "
                               "two launches bit-equal",
                     largest_sum=top, ms=ms, plain_ms=plain, bound_ms=b,
                     bound_by=by, library_ms=lib,
                     library="torch.Tensor.index_add_",
                     shapes=[list(rows11.shape), n_out],
                     longest_run=int(runs.max()),
                     runs_over_32=int((runs > 32).sum()),
                     ranks_with_pairs=int((runs > 0).sum())))
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random scene weights")
    args = ap.parse_args()

    smi = phase_device()
    phase_build()
    phase_reference(args.seed)
    phase_reference_train(args.seed)
    store, tracks, cfg, rcfg, cam0, launches = phase_main(args.seed)
    phase_profile("profile", lambda: forward_scene(
        store, tracks, cam0, 0, cfg, rcfg, eval_extras=True))
    phase_stages(store, tracks, cfg, rcfg, cam0)
    calls = capture(store, tracks, cfg, rcfg, cam0)
    del store
    state, batch, train_launches = phase_train(args.seed, tracks, cfg, rcfg,
                                               cam0)
    phase_profile("train_profile", lambda: sts.scene_train_step(
        state, tracks, cam0, batch, cfg, rcfg, subset_accs=False))
    train_calls, jitter, res = capture_train(state, tracks, cfg, rcfg, cam0,
                                             batch)
    phase_train_stages(state, tracks, cfg, rcfg, cam0, batch, train_calls,
                       jitter, res)
    del res
    calls.update(train_calls)
    rows = phase_kernels(calls, launches, train_launches)
    for r in rows:
        r["card"] = smi
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
