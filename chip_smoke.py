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
                semantic map from --seed): 3 steps of
                engine.scene_train_step.scene_train_step with
                subset_accs=False, 1 step with subset_accs=True, from step
                3600 (the SH degree has reached 3, so features_rest trains),
                then one scene_refine_step at a step that densifies. Every launch
                counter is set to 0 just before the steps and read just after;
  8. train_profile / train_stages  one step under torch.profiler, and the
                device time of the stages of one step (CUDA events);
  9. reference_modes  the small scene on the card against the CPU through
                every other route of ops.render.rasterize: depth_slices=3,
                impl="chunked" and "scan" (heads, one step's loss and
                gradients), shared bins through the unfused kernel route
                and three tile strips (image, loss, gradients); and on the
                card sliced, unfused and strips against the fused route;
 10. sliced_path  the flagship scene with RenderConfig(depth_slices=2): 2
                eval frames and 2 training steps, the counts set to 0 just
                before and read just after (kernels D and E run with t_in
                once per render / backward), then sliced and unsliced in
                turns for the latencies;
 11. unfused_path  the flagship scene, one render + backward through
                ops.tiles.bin_gaussians and rasterize_tiles_pallas (kernels
                A in max mode, D, E, G), held against the fused route, with
                stage times;
 12. row_scan_path  kernel H, which no render path of either package
                calls, through its entry points cumsum_rows / cummax_rows at
                the three shapes of the JAX package's micro-benchmark;
 13. kernels    every kernel of these paths, on the inputs captured from
                them, against its plain version, with its time, the plain
                version's time, a PyTorch library call's time where one
                computes the same function, and its bound; D and E also in
                their t_in mode and with a tile0 strip held bit for bit
                against the full launch; A also in float32, counted for
                device launches a call (1) and repeated 200 times over two
                streams; D and E with their registers and occupancy from
                the build log and the pairs a tile needs (D) or visits
                (E); D with n_contrib equal to the plain version's on
                every pixel; E also as the fused routes call it (into an
                undefined buffer), with the time of the zero fill it
                spares; F also behind a busy card, beside index_add_, with
                the pairs a rank owns. A line of its own before the
                `kernels` line quotes the times rows A, E, D and F had
                before their redesign; every number in the `kernels` line
                itself is this run's.
The line before the last is the `kernels` JSON; the last line is
{"ok": true, "device": {...}}. Any failure raises and exits non-zero.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import re
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
from street_gaussians_ns_tpu_torch.ops.render import (  # noqa: E402
    RenderConfig, rasterize, render)

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
# Quoted, not measured here: the times of rows A, E, D and F before the
# kernels were redesigned (PERF.md section 6; NVIDIA H100 80GB HBM3, 700 W).
# Printed on a line of their own, never in the `kernels` line.
EARLIER_MS = {"flat_scan": 0.111, "composite_bwd": 1.298,
              "composite_bwd[t_in]": 0.135, "composite_fwd": 0.367,
              "composite_fwd[t_in]": 0.0376, "rank_rowsum": 0.162}
SCAN_REPEATS = 200                 # launches of the look-back race check
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


def time_ms_queued(fn, reps: int) -> float:
    """time_ms with the card kept busy while the host enqueues: the
    launches wait in the stream behind a spinning kernel, so the interval
    between the events holds the card's work and none of the host's
    launch path. For kernels that take less than their launch does."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)      # ~10 ms of the card's clock
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


def reset_launches() -> None:
    for k in _cuda.KERNELS:
        k.reset_launches()


def read_launches() -> dict:
    """Launches per kernel since reset_launches, and per mode of a kernel
    as "name[mode]"."""
    out = {k.name: k.launches for k in _cuda.KERNELS}
    for k in _cuda.KERNELS:
        for mode, n in k.mode_launches.items():
            out[f"{k.name}[{mode}]"] = n
    return out


def check_launches(phase: str, launches: dict, expected: dict) -> None:
    for name, n in expected.items():
        if launches.get(name, 0) != n:
            raise AssertionError(f"{phase}: {name} launched "
                                 f"{launches.get(name, 0)} times, expected "
                                 f"{n}")


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
    reset_launches()
    times, frames = [], []
    for cam in cams:
        t = time.perf_counter()
        outputs, out, boxes = frame(cam)
        sync()
        times.append((time.perf_counter() - t) * 1e3)
        frames.append((outputs, out))
    launches = read_launches()
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
    """The training path: 3 steps with subset_accs=False, 1 step with
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
    reset_launches()
    times, losses, pairs = [], [], []
    plan = [False, False, False, True]
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
    launches = read_launches()
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
    ms = float(np.median(times[:-1]))
    emit("train_path", steps=len(plan), renders=renders,
         backward_passes=backwards,
         first_step=TRAIN_STEP0, sh_degree_active=sh_active,
         size=[size.width, size.height],
         gaussians_active=int(first.store.background.active.sum()
                              + first.store.objects.active.sum()),
         ms_per_step=times, ms_per_step_median=ms,
         steps_per_s=1e3 / ms, ms_step_subset_accs=times[-1],
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
    nvis = composite.visited_counts(ncon, tc)
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
        "bwd.composite_bwd": lambda: composite.composite_bwd(
            *bwd_args, zero_fill=False),
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
    _, _, fs, box_s = tiles._depth_sort_cols(
        proj.xys, proj.conics, proj.tile_box, depth_key, colors4, op, True)
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
            proj.xys, proj.conics, proj.tile_box, depth_key, colors4, op,
            True),
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


# ---------------------------------------------------------------------------
# The secondary routes of ops.render.rasterize.
# ---------------------------------------------------------------------------

def _flat_inputs(store, tracks, cfg, cam, training: bool = False):
    """What `render` hands the rasterizer for the full render of `cam`:
    (proj, colors4 = rgb + depth, opacities), the inactive slots masked."""
    flat, active, _ = compose(store, tracks, cam.time, config=cfg)
    rgbs = sh_colors(flat["means"], flat["features_dc_t"],
                     flat["features_rest"], cam, 0, cfg.base,
                     training=training)
    op = torch.sigmoid(flat["opacities"][:, 0])
    op = torch.where(active, op, torch.zeros_like(op))
    proj = project(flat["means"], torch.exp(flat["scales"]), flat["quats"],
                   viewmat_from_c2w(cam.c2w), cam.fx, cam.fy, cam.cx, cam.cy,
                   cam.width, cam.height, opacities=op)
    proj = dataclasses.replace(
        proj, num_tiles_hit=torch.where(active, proj.num_tiles_hit, 0),
        radii=torch.where(active, proj.radii, 0))
    colors4 = torch.cat([rgbs, proj.depths[:, None]], dim=-1)
    return proj, colors4, op


def _raster_loss_and_grads(proj, colors4, op, route):
    """A mean-type loss of the image and alpha that `route` rasterizes,
    and its gradients with respect to (xys, conics, colours, opacities)."""
    leaves = [t.detach().clone().requires_grad_(True)
              for t in (proj.xys, proj.conics, colors4, op)]
    pr = dataclasses.replace(proj, xys=leaves[0], conics=leaves[1])
    img, alpha = route(pr, leaves[2], leaves[3])
    loss = (img - 0.5).abs().mean() + 0.3 * (alpha ** 2).mean()
    grads = torch.autograd.grad(loss, leaves)
    return dict(loss=float(loss.detach()), img=img.detach(), alpha=alpha.detach(),
                grads=dict(zip(("xys", "conics", "colors", "opacities"),
                               grads)))


def _raster_routes(cam, rcfg, n_strips: int = 3):
    """The rasterizer-level routes: fused, shared bins through the unfused
    kernel compositor, and tile strips put together."""
    w, h = cam.width, cam.height
    ntx, nty = -(-w // 16), -(-h // 16)
    bg = lambda t: torch.zeros(4, device=t.device)       # noqa: E731

    def fused(pr, colors, op):
        return rasterize(pr, colors, op, cam, bg(op), rcfg,
                         last_color_is_depth=True)[:2]

    def shared_bins(pr, colors, op):
        bins = tiles.bin_gaussians(pr, w, h, 16, rcfg.max_pairs,
                                   rcfg.max_rowruns, opacities=op.detach())
        return rasterize(pr, colors, op, cam, bg(op), rcfg, bins=bins)[:2]

    def strips(pr, colors, op):
        per = -(-ntx * nty // n_strips)
        parts = [composite.composite_tiles_fused(
            pr, colors, op, s_ * per, per, w, h, rcfg.max_pairs,
            rcfg.max_rowruns, last_color_is_depth=True)
            for s_ in range(n_strips)]
        accum = torch.cat([p_[0] for p_ in parts])[:ntx * nty]
        alpha = torch.cat([p_[1] for p_ in parts])[:ntx * nty]
        return (composite._tiles_to_image(accum, ntx, nty, w, h),
                composite._tiles_to_image(alpha, ntx, nty, w, h))

    return {"fused": fused, "shared_bins": shared_bins, "strips": strips}


def _close_grads(phase, got, want, rtol_of_top, errs, prefix=""):
    for k, w in want.items():
        top = float(w.abs().max())
        err = float((got[k].cpu() - w.cpu()).abs().max())
        if k.startswith("bbox/"):
            if top != 0.0 or err != 0.0:
                raise AssertionError(f"{phase}: {prefix}{k} must be zero")
            continue
        if not top > 0 or err > rtol_of_top * top:
            raise AssertionError(f"{phase}: {prefix}gradient {k} differs by "
                                 f"{err} (largest |g| {top})")
        errs[f"{prefix}grad {k}"] = err / top


def phase_reference_modes(seed: int, devices=("cpu", "cuda")):
    """The small scene through every route of ops.render.rasterize but
    the fused one, on the card (the kernels) against the CPU (their plain
    versions): heads at atol 2e-5 (depths rtol 1e-4), one training step's
    loss at atol 2e-5, every gradient at 1e-4 of its group's largest |g|.
    And on the card against the fused route: depth_slices=3 (image atol
    3e-5, gradients 2e-4 of the group's largest), shared bins (1e-6, 1e-4)
    and three tile strips (1e-5, 2e-4)."""
    store_np, tracks_np = make_scene(seed + 1, 600, 2, 80, 16, sh_degree=1)
    cfg = scene_config(1, 16, 5)
    late = cfg.background.stop_split_at + 1
    base = dict(max_pairs=1 << 14)
    configs = {"fused": RenderConfig(**base),
               "depth_slices=3": RenderConfig(depth_slices=3, **base),
               "impl=chunked": RenderConfig(impl="chunked",
                                            max_per_tile=1024, **base),
               "impl=scan": RenderConfig(impl="scan", max_per_tile=1024,
                                         **base)}
    rng = np.random.default_rng(seed + 3)
    jitter = rng.random((2, 48, 64), dtype=np.float32)
    heads = ("rgb", "accumulation", "depth")
    scene, raster = {}, {}
    for dev in devices:
        tracks = tracks_from_numpy(tracks_np, device=dev)
        cam = Camera.make(60.0, 60.0, 32.0, 24.0,
                          np.eye(3, 4, dtype=np.float32), 64, 48, time=0.6,
                          device=dev)
        batch = make_batch(seed, 64, 48, dev)
        jit = torch.from_numpy(jitter).to(dev)
        state = train_state_from_numpy(train_arrays(store_np, late), cfg,
                                       device=dev, seed=seed)
        scene[dev] = {}
        with warnings.catch_warnings():
            warnings.simplefilter("error", RuntimeWarning)
            for mode, rc in configs.items():
                outs = forward_scene(state.store, tracks, cam, 0, cfg, rc,
                                     eval_extras=True)[0]
                total, _, _, rout, grads = sts.scene_loss_and_grads(
                    state, tracks, cam, batch, cfg, rc, subset_accs=True,
                    jitter=jit)
                scene[dev][mode] = dict(
                    heads={k: outs[k].detach().cpu() for k in heads},
                    loss=float(total), densest=int(rout.bins.max_tile_count),
                    grads={k: v.cpu() for k, v in _all_grads(grads)})
            proj, colors4, op = _flat_inputs(state.store, tracks, cfg, cam)
            raster[dev] = {
                name: _raster_loss_and_grads(proj, colors4, op, route)
                for name, route in _raster_routes(cam,
                                                  configs["fused"]).items()}
    ref, dut = devices[0], devices[-1]
    errs = {}
    for mode in configs:
        if mode == "fused":
            continue
        want, got = scene[ref][mode], scene[dut][mode]
        for k, e in _heads_close(got["heads"], want["heads"],
                                 atol=2e-5).items():
            errs[f"{mode} {k}"] = e
        errs[f"{mode} loss"] = abs(got["loss"] - want["loss"])
        if errs[f"{mode} loss"] > 2e-5:
            raise AssertionError(f"reference_modes: {mode} loss differs by "
                                 f"{errs[f'{mode} loss']}")
        _close_grads("reference_modes", got["grads"], want["grads"], 1e-4,
                     errs, prefix=f"{mode} ")
    for name in ("shared_bins", "strips"):
        want, got = raster[ref][name], raster[dut][name]
        errs[f"{name} loss"] = abs(got["loss"] - want["loss"])
        errs[f"{name} image"] = float(
            (got["img"].cpu()[..., :3] - want["img"].cpu()[..., :3])
            .abs().max())
        if errs[f"{name} loss"] > 2e-5 or errs[f"{name} image"] > 2e-5:
            raise AssertionError(f"reference_modes: {name} differs from the "
                                 f"CPU: {errs}")
        _close_grads("reference_modes", got["grads"], want["grads"], 1e-4,
                     errs, prefix=f"{name} ")
    # On the device under test, against the fused route.
    fused_s, sliced = scene[dut]["fused"], scene[dut]["depth_slices=3"]
    for k, e in _heads_close(sliced["heads"], fused_s["heads"],
                             atol=3e-5).items():
        errs[f"sliced vs fused {k}"] = e
    if sliced["densest"] != fused_s["densest"]:
        raise AssertionError("reference_modes: the sliced max_tile_count "
                             f"{sliced['densest']} is not the scene's "
                             f"{fused_s['densest']}")
    _close_grads("reference_modes", sliced["grads"], fused_s["grads"], 2e-4,
                 errs, prefix="sliced vs fused ")
    fused_r = raster[dut]["fused"]
    for name, img_tol, g_tol in (("shared_bins", 1e-6, 1e-4),
                                 ("strips", 1e-5, 2e-4)):
        got = raster[dut][name]
        e = max(float((got["img"][..., :3] - fused_r["img"][..., :3])
                      .abs().max()),
                float((got["alpha"] - fused_r["alpha"]).abs().max()))
        errs[f"{name} vs fused image"] = e
        if e > img_tol:
            raise AssertionError(f"reference_modes: {name} image differs "
                                 f"from the fused route by {e}")
        _close_grads("reference_modes", got["grads"], fused_r["grads"],
                     g_tol, errs, prefix=f"{name} vs fused ")
    if float(fused_r["alpha"].max()) <= 0.3:
        raise AssertionError("reference_modes: the scene renders almost "
                             "nothing")
    emit("reference_modes", size=[64, 48], devices=list(devices),
         modes=list(configs)[1:] + ["shared_bins", "strips"],
         tolerance="against the CPU: heads atol 2e-5 (depth rtol 1e-4), "
                   "loss atol 2e-5, gradients 1e-4 of the group's largest; "
                   "against the fused route: sliced 3e-5 / 2e-4, shared "
                   "bins 1e-6 / 1e-4, strips 1e-5 / 2e-4",
         densest_tile=fused_s["densest"], max_err=errs)


def phase_sliced(state, tracks, cfg, rcfg, cams, batch, k: int = 2,
                 dev="cuda"):
    """The flagship scene through RenderConfig(depth_slices=k): eval
    frames on `cams` and 2 training steps on cams[0], counted; then sliced
    and unsliced in turns. The capacities are grown from the demand counts
    of a sizing render, as a trainer grows them. Returns the captured
    second-window launches of kernels D and E and the counted launches."""
    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    store = state.store

    def up(v, step=8192):
        return -(-int(v) // step) * step

    def frame(cam, rc):
        with torch.no_grad():
            return forward_scene(store, tracks, cam, 0, cfg, rc,
                                 eval_extras=True)

    def step(st, rc):
        return sts.scene_train_step(st, tracks, cams[0], batch, cfg, rc,
                                    subset_accs=False)

    # Sizing (and warm-up): a generous first guess, then the demand.
    guess = RenderConfig(max_pairs=up(1.25 * rcfg.max_pairs),
                         max_rowruns=up(2 * rcfg.rowrun_capacity),
                         depth_slices=k)
    demand_p = demand_r = 0
    for cam in cams:
        bins = frame(cam, guess)[1].bins
        demand_p = max(demand_p, int(bins.num_pairs))
        demand_r = max(demand_r, int(bins.num_rowruns))
    rc = RenderConfig(max_pairs=up(demand_p), max_rowruns=up(demand_r),
                      depth_slices=k)
    step(state, rc)
    sync()
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    reset_launches()
    frame_ms, step_ms, losses, outs = [], [], [], []
    st = state
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        for cam in cams:
            t = time.perf_counter()
            outputs, out, _ = frame(cam, rc)
            sync()
            frame_ms.append((time.perf_counter() - t) * 1e3)
            outs.append((outputs, out))
        for _ in range(2):
            t = time.perf_counter()
            st, metrics = step(st, rc)
            sync()
            step_ms.append((time.perf_counter() - t) * 1e3)
            losses.append(float(metrics["loss"]))
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() if dev == "cuda" else None
    renders, backwards = 3 * len(cams) + 2, 2
    if dev == "cuda":
        check_launches("sliced_path", launches, {
            "flat_scan": (1 + 3 * k) * renders,
            "expand_ragged": 2 * k * renders, "pack_feat_cols": k * renders,
            "composite_fwd": k * renders,
            "composite_fwd[t_in]": (k - 1) * renders,
            "composite_bwd": k * backwards,
            "composite_bwd[t_in]": (k - 1) * backwards,
            "rank_rowsum": k * backwards})
    for loss in losses:
        if not math.isfinite(loss):
            raise AssertionError(f"sliced_path: loss {loss}")
    demand = []
    for (outputs, out), cam in zip(outs, cams):
        for h, v in outputs.items():
            if not bool(torch.isfinite(v).all()):
                raise AssertionError(f"sliced_path: head {h} is not finite")
        demand.append([int(out.bins.num_pairs), int(out.bins.num_rowruns)])
        if demand[-1][0] > rc.max_pairs or demand[-1][1] > rc.rowrun_capacity:
            raise AssertionError("sliced_path: capacity overflow")
        # Against the unsliced frame: the same pairs in the same order,
        # the windows' accums added in another.
        want = frame(cam, rcfg)
        diff = float((outputs["rgb"] - want[0]["rgb"]).abs().max())
        dacc = float((outputs["accumulation"]
                      - want[0]["accumulation"]).abs().max())
        if max(diff, dacc) > 3e-5:
            raise AssertionError(f"sliced_path: the sliced frame differs "
                                 f"from the unsliced by {diff} (rgb), "
                                 f"{dacc} (accumulation)")
        if int(out.bins.max_tile_count) != int(want[1].bins.max_tile_count):
            raise AssertionError("sliced_path: max_tile_count is not the "
                                 "unsliced render's")
        demand[-1] += [diff, dacc, int(want[1].bins.num_pairs),
                       int(want[1].bins.num_rowruns)]

    # Sliced and unsliced in turns, on the host's clock and on the card's.
    turns = {"sliced": ([], [], rc), "unsliced": ([], [], rcfg)}
    st_turn = st
    for _ in range(2):
        for name, (f_ms, s_ms, rcx) in turns.items():
            t = time.perf_counter()
            frame(cams[0], rcx)
            sync()
            f_ms.append((time.perf_counter() - t) * 1e3)
            t = time.perf_counter()
            st_turn, _ = step(st_turn, rcx)
            sync()
            s_ms.append((time.perf_counter() - t) * 1e3)
    proj, colors4, op = _flat_inputs(store, tracks, cfg, cams[0])
    bg = torch.zeros(4, device=op.device)
    device_ms = {
        name: time_ms(lambda rcx=rcx: composite.rasterize_tiles_fused(
            proj, colors4, op, cams[0].width, cams[0].height, 16, bg,
            rcx.max_pairs, rcx.max_rowruns, last_color_is_depth=True,
            depth_slices=rcx.depth_slices), 3)
        for name, (_, _, rcx) in turns.items()}

    # One sliced step with the compositor launches recorded.
    recs = [Recorder(composite, "composite_fwd"),
            Recorder(composite, "composite_bwd")]
    for r in recs:
        r.__enter__()
    try:
        sts.scene_loss_and_grads(
            st, tracks, cams[0], batch, cfg, rc, subset_accs=False,
            jitter=draw_pixel_jitter(cams[0], st.generator))
    finally:
        for r in recs:
            r.__exit__()
    fwd_calls, bwd_calls = (r.calls for r in recs)
    if len(fwd_calls) != k or len(bwd_calls) != k:
        raise AssertionError("sliced_path: expected one forward and one "
                             "backward launch per window")
    captured = {
        "composite_fwd[t_in]": next(c for c in fwd_calls
                                    if c[1].get("t_in") is not None),
        "composite_bwd[t_in]": next(c for c in bwd_calls
                                    if c[1].get("t_in") is not None)}
    emit("sliced_path", depth_slices=k, frames=len(cams), steps=2,
         renders=renders, backward_passes=backwards,
         max_pairs=rc.max_pairs, max_rowruns=rc.rowrun_capacity,
         unsliced_max_pairs=rcfg.max_pairs,
         unsliced_max_rowruns=rcfg.rowrun_capacity,
         per_frame=[dict(zip(("demand_pairs", "demand_rowruns",
                              "rgb_diff_vs_unsliced",
                              "accumulation_diff_vs_unsliced",
                              "unsliced_pairs", "unsliced_rowruns"), d))
                    for d in demand],
         pairs_per_window=[int(c[0][2].sum()) for c in fwd_calls],
         pairs_visited_per_window=[
             int(composite.visited_counts(c[0][8], c[0][2]).sum())
             for c in bwd_calls],
         ms_per_frame=frame_ms, ms_per_step=step_ms, loss_per_step=losses,
         max_memory_allocated=peak, launches=launches,
         in_turns={name: dict(ms_per_frame=f_ms, ms_per_step=s_ms,
                              rasterize_device_ms=device_ms[name])
                   for name, (f_ms, s_ms, _) in turns.items()})
    return captured, launches


def phase_unfused(store, tracks, cfg, rcfg, cam, dev="cuda", reps: int = 3):
    """The flagship scene through shared bins: ops.tiles.bin_gaussians,
    then one render and backward of rasterize_tiles_pallas, counted, held
    against the fused route on the same inputs, with stage times. Returns
    kernel G's captured arguments and the counted launches."""
    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    w, h = cam.width, cam.height
    with torch.no_grad():
        proj, colors4, op = _flat_inputs(store, tracks, cfg, cam)
    bg = torch.zeros(4, device=op.device)
    mp, mr = rcfg.max_pairs, rcfg.rowrun_capacity

    last_bins = []

    def unfused(pr, colors, opac):
        bins = tiles.bin_gaussians(pr, w, h, 16, mp, mr,
                                   opacities=opac.detach())
        last_bins[:] = [bins]
        return composite.rasterize_tiles_pallas(pr.xys, pr.conics, colors,
                                                opac, bins, w, h, 16, bg)

    def fused(pr, colors, opac):
        return composite.rasterize_tiles_fused(
            pr, colors, opac, w, h, 16, bg, mp, mr,
            last_color_is_depth=True)[:2]

    _raster_loss_and_grads(proj, colors4, op, unfused)       # warm-up
    sync()
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with Recorder(composite, "segment_rowsum") as rec:
        t = time.perf_counter()
        got = _raster_loss_and_grads(proj, colors4, op, unfused)
        sync()
        ms = (time.perf_counter() - t) * 1e3
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() if dev == "cuda" else None
    if dev == "cuda":
        check_launches("unfused_path", launches, {
            "flat_scan": 5, "composite_fwd": 1, "composite_bwd": 1,
            "segment_rowsum": 1, "expand_ragged": 0, "pack_feat_cols": 0,
            "rank_rowsum": 0})
    bins, = last_bins
    n_pairs, n_runs = int(bins.num_pairs), int(bins.num_rowruns)
    if n_pairs > mp or n_runs > mr:
        raise AssertionError(f"unfused_path: capacity overflow ({n_pairs} "
                             f"pairs, {n_runs} runs)")
    want = _raster_loss_and_grads(proj, colors4, op, fused)
    errs = {"loss": abs(got["loss"] - want["loss"]),
            "image": float((got["img"] - want["img"]).abs().max()),
            "alpha": float((got["alpha"] - want["alpha"]).abs().max())}
    if errs["loss"] > 1e-6 or errs["image"] > 1e-5 or errs["alpha"] > 1e-6:
        raise AssertionError(f"unfused_path: differs from the fused route: "
                             f"{errs}")
    _close_grads("unfused_path", got["grads"], want["grads"], 1e-4, errs)
    if float(got["alpha"].max()) <= 0.5:
        raise AssertionError("unfused_path: renders almost nothing")

    # Stage times, on the captured pieces.
    xys, conics = proj.xys, proj.conics
    feat = composite._build_feat(xys, conics, colors4, op, bins)
    ntx = bins.num_tiles_x
    accum, tfin, ncon = composite.composite_fwd(feat, bins.tile_start,
                                                bins.tile_count, ntx, 4)
    g_accum = torch.full_like(accum, 1e-6)
    g_t = torch.full_like(tfin, -1e-6)
    gpair = composite.composite_bwd(feat, bins.tile_start, bins.tile_count,
                                    ntx, 4, g_accum, g_t, tfin, ncon, accum)
    (g_args, _), = rec.calls
    rows_cm, starts, ends = g_args
    rank_sums = segreduce.segment_rowsum(rows_cm, starts, ends)
    cols = gpair[:mp // 128, :10].permute(1, 0, 2).reshape(10, mp)
    slot = bins.exp_slot.to(torch.int64)

    def scatter_back():
        out = torch.zeros((10, mp + 1), dtype=torch.float32,
                          device=cols.device)
        out.index_copy_(1, slot, cols)
        return out[:, :mp].contiguous()

    def no_grad(fn):
        def run():
            with torch.no_grad():
                return fn(proj, colors4, op)
        return run

    stages = {
        "bin_gaussians": lambda: tiles.bin_gaussians(
            proj, w, h, 16, mp, mr, opacities=op),
        "_build_feat": lambda: composite._build_feat(xys, conics, colors4,
                                                     op, bins),
        "composite_fwd": lambda: composite.composite_fwd(
            feat, bins.tile_start, bins.tile_count, ntx, 4),
        "composite_bwd": lambda: composite.composite_bwd(
            feat, bins.tile_start, bins.tile_count, ntx, 4, g_accum, g_t,
            tfin, ncon, accum),
        "reduce.scatter_to_expansion_order": scatter_back,
        "reduce.segment_rowsum": lambda: segreduce.segment_rowsum(
            rows_cm, starts, ends),
        "reduce.unsort": lambda: composite._unsort_rank_sums(
            rank_sums, bins.depth_order),
        "_reduce_pair_grads": lambda: composite._reduce_pair_grads(
            gpair, bins, 4),
        "forward(unfused)": no_grad(unfused),
        "forward(fused)": no_grad(fused),
        "forward+backward(unfused)": lambda: _raster_loss_and_grads(
            proj, colors4, op, unfused),
        "forward+backward(fused)": lambda: _raster_loss_and_grads(
            proj, colors4, op, fused),
    }
    stage_ms = {k_: time_ms(fn, reps) for k_, fn in stages.items()}
    emit("unfused_path", size=[w, h], max_pairs=mp, max_rowruns=mr,
         num_pairs=n_pairs, num_rowruns=n_runs,
         ms_render_and_backward=ms, max_memory_allocated=peak,
         tolerance="against the fused route: loss 1e-6, image 1e-5, alpha "
                   "1e-6, gradients 1e-4 of the group's largest",
         max_err=errs, stage_ms=stage_ms, launches=launches)
    return {"segment_rowsum": rec.calls[0]}, launches


ROW_SCAN_ROWS = 4_456_448      # rows of the JAX micro-benchmark's arrays


def phase_row_scans(seed: int, rows: int = ROW_SCAN_ROWS, dev="cuda"):
    """Kernel H through its entry points, at the shapes of the JAX
    package's micro-benchmark (tools/micro_bench.py): cumulative max of
    (rows, 6) and (rows, 8) int32 owner marks (-1 but where a run
    starts), cumulative sum of (rows, 16) float32. No render path calls
    the row scans, so this phase is their path: the counts are set to 0
    just before and read just after."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    idx = torch.arange(rows, dtype=torch.int32, device=dev)[:, None]
    inputs = []
    for c in (6, 8):
        hit = torch.rand((rows, c), generator=gen, device=dev) < 0.3
        inputs.append(("max", torch.where(hit, idx, -1).contiguous()))
    inputs.append(("add", torch.randn((rows, 16), generator=gen,
                                      device=dev)))
    reset_launches()
    t = time.perf_counter()
    outs = [scan.cummax_rows(x) if op == "max" else scan.cumsum_rows(x)
            for op, x in inputs]
    if dev == "cuda":
        torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3
    launches = read_launches()
    if dev == "cuda":
        check_launches("row_scan_path", launches, {"scan_rows": 3})
    for (op, x), y in zip(inputs, outs):
        if y.shape != x.shape or y.dtype != x.dtype:
            raise AssertionError("row_scan_path: shape or dtype changed")
        if not bool(torch.isfinite(y.to(torch.float32)).all()):
            raise AssertionError("row_scan_path: non-finite result")
        if op == "max" and not bool((y[1:] >= y[:-1]).all()):
            raise AssertionError("row_scan_path: a cumulative max falls")
    emit("row_scan_path", shapes=[[op, list(x.shape), str(x.dtype)]
                                  for op, x in inputs],
         ms_three_scans=ms, launches=launches)
    return {"scan_rows": inputs}, launches


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


def _pair_major(gpair):
    """(rows, 16, 128) stream -> (rows * 128, 16): one row per pair."""
    return gpair.permute(0, 2, 1).reshape(-1, composite.NFEAT)


def scan_race_check(x, repeats: int = SCAN_REPEATS) -> None:
    """Kernel A's blocks hand their totals on through global memory:
    `repeats` launches alternating between two streams (each with a
    scratch of its own) must all give the one result."""
    want = scan.cumsum_flat(x)
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    torch.cuda.synchronize()
    outs = []
    for i in range(repeats):
        with torch.cuda.stream(streams[i % 2]):
            outs.append(scan.cumsum_flat(x))
    torch.cuda.synchronize()
    bad = sum(not torch.equal(o, want) for o in outs)
    if bad:
        raise AssertionError(f"flat_scan: {bad} of {repeats} launches on "
                             f"two streams differ from the first")


def ptxas_entries(log: str) -> dict:
    """Mangled kernel name -> (registers, spill store bytes, static shared
    memory bytes) from an `nvcc -Xptxas -v` log."""
    out, name, spill = {}, None, 0
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            smem = re.search(r"(\d+) bytes smem", ln)
            out[name] = (int(m.group(1)), spill,
                         int(smem.group(1)) if smem else 0)
            name = None
    return out


def occupancy(registers: int, threads: int, smem: int) -> dict:
    """Resident CTAs and warps an SM of the H100 holds for a kernel (65,536
    registers allotted in units of 256 a warp, 64 warps, 32 CTAs, 227 KB
    of shared memory with 1 KB reserved a CTA)."""
    warps = -(-threads // 32)
    regs_cta = -(-registers * 32 // 256) * 256 * warps
    ctas = min(65536 // regs_cta, 64 // warps, 32,
               (227 * 1024) // (smem + 1024))
    return dict(ctas_per_sm=ctas, warps_per_sm=ctas * warps,
                share_of_64_warps=ctas * warps / 64)


def quantiles(x) -> dict:
    """Mean, p50, p90, p99 and max of a 1-d count tensor."""
    x = x.double()
    q = torch.quantile(x, torch.tensor([0.5, 0.9, 0.99], dtype=x.dtype,
                                       device=x.device))
    return dict(mean=float(x.mean()), p50=float(q[0]), p90=float(q[1]),
                p99=float(q[2]), max=int(x.max()))


def visited_histogram(nvis) -> dict:
    """The pairs a tile's backward visits (or its forward needs), over the
    tiles of one launch."""
    return dict(quantiles(nvis),
                share_of_tiles_over_512=float((nvis > 512).double().mean()),
                share_of_tiles_with_none=float((nvis == 0).double().mean()))


def _ptxas_entry(kernel, instantiation: str, name: str):
    """(registers, spill store bytes, static shared memory bytes) of the
    launched instantiation of a kernel, from its build log; raises where
    the log lacks it or where any instantiation spilled."""
    entries = ptxas_entries(kernel.build_log)
    entry = next((v for k_, v in entries.items() if instantiation in k_),
                 None)
    if entry is None:
        raise AssertionError(f"{name}: no ptxas line for the launched "
                             f"instantiation in the build log")
    spilled = {k_: v[1] for k_, v in entries.items() if v[1]}
    if spilled:
        raise AssertionError(f"{name}: ptxas spilled registers: {spilled}")
    return entry


def _fwd_row(name: str, call, launches: int, reps: int,
             tile0_check: bool = False) -> dict:
    """Kernel D on one captured launch (with its t_in when it has one)
    against its plain version."""
    (feat, ts, tc, ntx, nc), kw = call
    t_in = kw.get("t_in")
    kw = dict(t_in=t_in, mark_done=kw.get("mark_done", False))
    evals = torch.zeros((2 + ts.numel(),), dtype=torch.int64,
                        device=feat.device)
    acc_k, t_k, n_k = composite.composite_fwd(feat, ts, tc, ntx, nc,
                                              evals=evals, **kw)
    acc_p, t_p, n_p = composite.composite_fwd_plain(feat, ts, tc, ntx, nc,
                                                    **kw)
    # sigma, alpha, T and the termination test round as the plain version
    # does, so every pixel ends at the same pair: n_contrib equal on every
    # pixel, accum and T at atol 2e-5 (the colour sums use fused
    # multiply-adds).
    n_bad = int((n_k != n_p).sum())
    n_pix = n_k.numel()
    err = max(_max_err(acc_k, acc_p), _max_err(t_k, t_p))
    if err > 2e-5 or n_bad:
        raise AssertionError(f"{name}: max abs error {err} (atol 2e-5), "
                             f"n_contrib differs on {n_bad} of {n_pix} "
                             f"pixels (must be none)")
    again = composite.composite_fwd(feat, ts, tc, ntx, nc, **kw)
    if not all(torch.equal(a, b) for a, b in zip(again, (acc_k, t_k, n_k))):
        raise AssertionError(f"{name}: two launches on the same inputs "
                             f"differ")
    extra = {}
    if tile0_check:
        # A strip of a tenth of the tiles from the middle of the grid: the
        # same tiles of the full launch, bit for bit.
        n_strip = max(1, ts.numel() // 10)
        t0 = ts.numel() // 2
        sl = slice(t0, t0 + n_strip)
        part = composite.composite_fwd(
            feat, ts[sl].contiguous(), tc[sl].contiguous(), ntx, nc,
            tile0=t0, mark_done=kw["mark_done"],
            t_in=t_in[sl].contiguous() if t_in is not None else None)
        if not all(torch.equal(a, b[sl])
                   for a, b in zip(part, (acc_k, t_k, n_k))):
            raise AssertionError(f"{name}: the strip at tile0={t0} differs "
                                 f"from the full launch")
        extra = dict(tile0_strip_bit_equal=True, tile0=t0,
                     strip_tiles=n_strip)
    ms = time_ms(lambda: composite.composite_fwd(feat, ts, tc, ntx, nc,
                                                 **kw), reps)
    queued = time_ms_queued(lambda: composite.composite_fwd(
        feat, ts, tc, ntx, nc, **kw), reps)
    plain = time_ms(lambda: composite.composite_fwd_plain(
        feat, ts, tc, ntx, nc, **kw), 1)
    n_eval, n_need = (int(v) for v in evals[:2].tolist())
    need = evals[2:]
    if int(need.sum()) != n_need:
        raise AssertionError(f"{name}: the tiles' needs do not add up to "
                             f"their total")
    entry = _ptxas_entry(composite.FWD_KERNEL,
                         f"ILi{nc}ELb{int(t_in is not None)}ELb0EE", name)
    # The loop ends early: count the pairs the tiles needed (their 6 + nc
    # used feature rows), not the whole stream.
    nbytes = 4 * (n_need * (6 + nc) + 2 * ts.numel() + acc_k.numel()
                  + t_k.numel() + n_k.numel()
                  + (t_in.numel() if t_in is not None else 0))
    b, by = bound(nbytes, D_OPS_PER_EVAL * n_eval)
    return dict(name=name, route="cuda",
                source=_rel(_cuda.CSRC / composite.FWD_KERNEL.source),
                replaces=composite.FWD_KERNEL.replaces,
                launches=launches, max_abs_err=err,
                tolerance="atol 2e-5 (accum, T); n_contrib equal on "
                          "every pixel; two launches bit-equal",
                n_contrib_mismatch=n_bad, ms=ms, plain_ms=plain,
                bound_ms=b, bound_by=by, library_ms=None,
                ms_behind_a_busy_card=queued, registers=entry[0], spill_store_bytes=entry[1],
                static_smem_bytes=entry[2],
                threads_per_cta=composite.FWD_THREADS,
                occupancy=occupancy(entry[0], composite.FWD_THREADS,
                                    entry[2]),
                pairs_needed_per_tile=visited_histogram(need),
                pixel_pair_evals=n_eval, pairs_needed=n_need,
                pairs_in_stream=int(tc.sum()),
                bytes_bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                ops_bound_ms=D_OPS_PER_EVAL * n_eval / FP32_OPS_PER_S * 1e3,
                tiles=ts.numel(), max_tile_count=int(tc.max()),
                pixels_arriving_done=(int((t_in <= 1e-4).sum())
                                      if t_in is not None else None),
                pixels_done_at_end=(int((t_k < 0).sum())
                                    if kw["mark_done"] else None),
                **extra)


def _bwd_row(name: str, call, launches: int, reps: int,
             tile0_check: bool = False) -> dict:
    """Kernel E on one captured launch (with its t_in when it has one)
    against its plain version. The plain version takes one Python
    iteration per within-tile pair index, so the comparison leaves out the
    tiles that visit more than E_PLAIN_DEPTH pairs (their count set to 0
    for both versions)."""
    bwd_args, kw = call
    t_in = kw.get("t_in")
    feat, ts, tc, ntx, nc, g_accum, g_t, tfin, ncon, accum = bwd_args
    nvis = composite.visited_counts(ncon, tc)
    shallow = nvis <= E_PLAIN_DEPTH
    tc_cmp = torch.where(shallow, tc, torch.zeros_like(tc))
    cmp_args = (feat, ts, tc_cmp, ntx, nc, g_accum, g_t, tfin, ncon, accum)
    got = composite.composite_bwd(*cmp_args, t_in=t_in)
    t0 = time.perf_counter()
    want = composite.composite_bwd_plain(
        *cmp_args[:-1], torch.sum(g_accum * accum, dim=-1), t_in)
    torch.cuda.synchronize()
    plain = (time.perf_counter() - t0) * 1e3
    top = float(want[:, :10].abs().max())
    err = _max_err(got[:, :10], want[:, :10])
    rel = float(((got[:, :10] - want[:, :10]).abs()
                 / (1e-4 * want[:, :10].abs() + 1e-5 * top)).max())
    if (not top > 0 or rel > 1.0
            or not torch.equal(got[:, 10:], want[:, 10:])):
        raise AssertionError(f"{name}: max abs error {err} at largest |g| "
                             f"{top} (rtol 1e-4, atol 1e-5 of it; rank row "
                             f"exact)")
    evals = torch.zeros((3,), dtype=torch.int64, device=feat.device)
    full = composite.composite_bwd(*bwd_args, evals=evals, t_in=t_in)
    if not torch.equal(full, composite.composite_bwd(*bwd_args, t_in=t_in)):
        raise AssertionError(f"{name}: two launches on the same inputs "
                             f"differ")
    # As the fused routes call it: into an undefined buffer, the visited
    # pairs the same bits.
    pair = composite._visited_pairs(ts, nvis)
    kk = composite.K
    loose = composite.composite_bwd(*bwd_args, t_in=t_in, zero_fill=False)
    if not torch.equal(loose[pair // kk, :11, pair % kk],
                       full[pair // kk, :11, pair % kk]):
        raise AssertionError(f"{name}: the visited pairs differ when the "
                             f"buffer is not zero-filled")
    extra = {}
    if tile0_check:
        # The strip's launch writes its own tiles' pairs, bit for bit what
        # the full launch wrote there, and nothing else.
        n_strip = max(1, ts.numel() // 10)
        t0_ = ts.numel() // 2
        sl = slice(t0_, t0_ + n_strip)
        part = composite.composite_bwd(
            feat, ts[sl].contiguous(), tc[sl].contiguous(), ntx, nc,
            g_accum[sl].contiguous(), g_t[sl].contiguous(),
            tfin[sl].contiguous(), ncon[sl].contiguous(),
            accum[sl].contiguous(), tile0=t0_)
        lo = int(ts[t0_])
        hi = int(ts[t0_ + n_strip - 1] + tc[t0_ + n_strip - 1])
        pm_part, pm_full = _pair_major(part), _pair_major(full)
        if (not torch.equal(pm_part[lo:hi], pm_full[lo:hi])
                or bool(pm_part[:lo].any()) or bool(pm_part[hi:].any())):
            raise AssertionError(f"{name}: the strip at tile0={t0_} differs "
                                 f"from the full launch")
        extra = dict(tile0_strip_bit_equal=True, tile0=t0_,
                     strip_tiles=n_strip, strip_pairs=hi - lo)
    # ms: the call the fused routes make (no fill of the stream);
    # ms_zero_filled: the public default, which the earlier rows timed.
    ms = time_ms(lambda: composite.composite_bwd(
        *bwd_args, t_in=t_in, zero_fill=False), reps)
    ms_filled = time_ms(lambda: composite.composite_bwd(*bwd_args, t_in=t_in),
                        reps)
    zero_fill_ms = time_ms(lambda: torch.zeros_like(feat), reps)
    n_eval, n_vis, n_contrib = (int(v) for v in evals.tolist())
    # Per tile: g_accum and accum (nc each), g_t, T_final, n_contrib and,
    # continuing, t_in, for 256 pixels; its start and count.
    nbytes = 4 * (n_vis * 11 + n_vis * 11
                  + ts.numel() * 256 * (2 * nc + 3 + (t_in is not None))
                  + 2 * ts.numel())
    ops = D_OPS_PER_EVAL * n_eval + E_OPS_PER_CONTRIB * n_contrib
    b, by = bound(nbytes, ops)
    entry = _ptxas_entry(composite.BWD_KERNEL,
                         f"ILi{nc}ELb{int(t_in is not None)}ELb0EE", name)
    return dict(name=name, route="cuda",
                source=_rel(_cuda.CSRC / composite.BWD_KERNEL.source),
                replaces=composite.BWD_KERNEL.replaces,
                launches=launches, max_abs_err=err,
                tolerance="rtol 1e-4 + atol 1e-5 of the largest |g|; rank "
                          "row exact; two launches bit-equal; the visited "
                          "pairs bit-equal into an undefined buffer",
                largest_grad=top, ms=ms, plain_ms=plain, bound_ms=b,
                bound_by=by, library_ms=None,
                ms_zero_filled=ms_filled, zero_fill_ms=zero_fill_ms,
                registers=entry[0], spill_store_bytes=entry[1],
                static_smem_bytes=entry[2],
                threads_per_cta=composite.BWD_THREADS,
                occupancy=occupancy(entry[0], composite.BWD_THREADS,
                                    entry[2]),
                visited_pairs_per_tile=visited_histogram(nvis),
                plain_compared_tiles=int(shallow.sum()),
                tiles=ts.numel(), plain_depth=E_PLAIN_DEPTH,
                pixel_pair_evals=n_eval, contributing_evals=n_contrib,
                pairs_visited=n_vis, pairs_in_stream=int(tc.sum()),
                max_visited_in_a_tile=int(nvis.max()),
                bytes_bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                ops_bound_ms=ops / FP32_OPS_PER_S * 1e3, **extra)


def _rel(path) -> str:
    return str(Path(path).resolve().relative_to(REPO))


def phase_kernels(calls, launches, train_launches, sliced_launches,
                  unfused_launches, scan_launches, reps: int = REPS):
    """calls: the captured arguments of every kernel; launches: of the
    eval frames; train_launches, sliced_launches, unfused_launches,
    scan_launches: of the paths that first drove kernels E and F, the
    t_in modes, kernel G and kernel H."""
    rows = []

    # A: flat scan, the render's 3 int32 cumsums (2 of N, 1 of max_rowruns):
    # int32 add and max and float32 max exact; float32 add at rtol 1e-5 of
    # the largest running sum against a float64 sum; two launches bit-equal.
    ms = plain = lib = nbytes = err = f32_add_err = 0.0
    queued_ms = queued_lib = 0.0
    shapes, per_call = [], []
    gen = torch.Generator(device="cuda").manual_seed(0)
    for (x,), _ in calls["cumsum_flat"]:
        err = max(err, _max_err(scan.cumsum_flat(x),
                                scan.cumsum_flat_plain(x)))
        err = max(err, _max_err(scan.cummax_flat(x),
                                scan.cummax_flat_plain(x)))
        xf = torch.randn(x.shape, generator=gen, device=x.device)
        err = max(err, _max_err(scan.cummax_flat(xf),
                                scan.cummax_flat_plain(xf)))
        got = scan.cumsum_flat(xf)
        want64 = scan.cumsum_flat_plain(xf.double())
        e = float((got.double() - want64).abs().max())
        if e > 1e-5 * float(want64.abs().max()):
            raise AssertionError(f"flat_scan float32 add: error {e} at a "
                                 f"largest running sum of "
                                 f"{float(want64.abs().max())} (rtol 1e-5)")
        f32_add_err = max(f32_add_err, e)
        for fn, arg in ((scan.cumsum_flat, x), (scan.cummax_flat, x),
                        (scan.cummax_flat, xf), (scan.cumsum_flat, xf)):
            if not torch.equal(fn(arg), fn(arg)):
                raise AssertionError("flat_scan: two launches differ")
        per_call.append(_cuda.captured_launches(
            scan.KERNEL, lambda: scan.cumsum_flat(x)))
        ms += time_ms(lambda: scan.cumsum_flat(x), reps)
        plain += time_ms(lambda: scan.cumsum_flat_plain(x), reps)
        lib += time_ms(lambda: torch.cumsum(x, 0, dtype=torch.int32), reps)
        queued_ms += time_ms_queued(lambda: scan.cumsum_flat(x), reps)
        queued_lib += time_ms_queued(
            lambda: torch.cumsum(x, 0, dtype=torch.int32), reps)
        nbytes += 2 * 4 * x.numel()
        shapes.append(x.numel())
    if err != 0.0:
        raise AssertionError(f"flat_scan differs from torch.cumsum/cummax "
                             f"by {err} (must be exact)")
    if any(n != 1 for n in per_call):
        raise AssertionError(f"flat_scan: a call made {per_call} device "
                             f"launches, expected 1 each")
    scan_race_check(max((x for (x,), _ in calls["cumsum_flat"]),
                        key=lambda t: t.numel()))
    b, by = bound(nbytes)
    rows.append(dict(name="flat_scan", route="cuda",
                     source=_rel(_cuda.CSRC / scan.KERNEL.source),
                     replaces=scan.KERNEL.replaces,
                     launches=launches["flat_scan"], max_abs_err=err,
                     tolerance="int32 add and max, float32 max exact; "
                               "float32 add rtol 1e-5 of the largest running "
                               "sum against float64; two launches bit-equal",
                     ms=ms, plain_ms=plain,
                     bound_ms=b, bound_by=by, library_ms=lib,
                     library="torch.cumsum", shapes=shapes,
                     device_launches_per_call=per_call,
                     ms_behind_a_busy_card=queued_ms,
                     library_ms_behind_a_busy_card=queued_lib,
                     float32_add_abs_err=f32_add_err,
                     repeats_on_two_streams_equal=SCAN_REPEATS))

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
                     source=_rel(_cuda.CSRC / expand.KERNEL.source),
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
                     source=_rel(_cuda.CSRC / composite.PACK_KERNEL.source),
                     replaces=composite.PACK_KERNEL.replaces,
                     launches=launches["pack_feat_cols"], max_abs_err=err,
                     tolerance="exact", ms=ms, plain_ms=plain, bound_ms=b,
                     bound_by=by, library_ms=None,
                     shapes=[len(feats), max_pairs, list(got.shape)]))

    # D and E: the compositors, whole-image launches of the fused path.
    rows.append(_fwd_row("composite_fwd", calls["composite_fwd"][0],
                         launches["composite_fwd"], reps, tile0_check=True))
    rows.append(_bwd_row("composite_bwd", calls["composite_bwd"][0],
                         train_launches["composite_bwd"], reps,
                         tile0_check=True))

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
    queued = time_ms_queued(lambda: segreduce.rank_rowsum(rows11, rank_s,
                                                          n_out), reps)
    plain = time_ms(lambda: segreduce.rank_rowsum_plain(rows11, rank_s,
                                                        n_out), reps)
    idx = rank_s.to(torch.int64)
    vals = rows11[:10]

    def index_add():
        return torch.zeros((10, n_out + 1), dtype=torch.float32,
                           device=vals.device).index_add_(1, idx, vals)
    lib = time_ms(index_add, reps)
    lib_queued = time_ms_queued(index_add, reps)
    p_len = rows11.shape[1]
    b, by = bound(4 * (11 * p_len + 10 * n_out))
    runs = torch.bincount(idx, minlength=n_out + 1)[:n_out]
    owned = runs[runs > 0]
    rows.append(dict(name="rank_rowsum", route="cuda",
                     source=_rel(_cuda.CSRC / segreduce.KERNEL.source),
                     replaces=segreduce.KERNEL.replaces,
                     launches=train_launches["rank_rowsum"], max_abs_err=err,
                     tolerance="rtol 1e-4 + atol 1e-5 of the largest |sum|; "
                               "two launches bit-equal",
                     largest_sum=top, ms=ms, plain_ms=plain, bound_ms=b,
                     bound_by=by, library_ms=lib,
                     library="torch.Tensor.index_add_",
                     ms_behind_a_busy_card=queued,
                     library_ms_behind_a_busy_card=lib_queued,
                     shapes=[list(rows11.shape), n_out],
                     pairs_per_owned_rank=quantiles(owned),
                     longest_run=int(runs.max()),
                     runs_over_32=int((runs > 32).sum()),
                     runs_over_1024=int((runs > 1024).sum()),
                     ranks_with_pairs=int((runs > 0).sum())))

    # D and E continuing a transmittance: the second window of one sliced
    # full-width render and of its backward.
    rows.append(_fwd_row("composite_fwd[t_in]", calls["composite_fwd[t_in]"],
                         sliced_launches["composite_fwd[t_in]"], reps,
                         tile0_check=True))
    rows.append(_bwd_row("composite_bwd[t_in]", calls["composite_bwd[t_in]"],
                         sliced_launches["composite_bwd[t_in]"], reps))

    # G: segmented row sum, on the unfused backward's rows in expansion
    # order and the bins' runs.
    (rows_cm, starts, ends), _ = calls["segment_rowsum"]
    got = segreduce.segment_rowsum(rows_cm, starts, ends)
    want = segreduce.segment_rowsum_plain(rows_cm, starts, ends)
    top = float(want.abs().max())
    err = _max_err(got, want)
    relg = float(((got - want).abs()
                  / (1e-4 * want.abs() + 1e-5 * top)).max())
    if not top > 0 or relg > 1.0:
        raise AssertionError(f"segment_rowsum: max abs error {err} at "
                             f"largest |sum| {top} (rtol 1e-4, atol 1e-5 of "
                             f"it)")
    if not torch.equal(got, segreduce.segment_rowsum(rows_cm, starts, ends)):
        raise AssertionError("segment_rowsum: two launches on the same "
                             "inputs differ")
    ms = time_ms(lambda: segreduce.segment_rowsum(rows_cm, starts, ends),
                 reps)
    plain = time_ms(lambda: segreduce.segment_rowsum_plain(rows_cm, starts,
                                                           ends), reps)
    lens = (ends - starts).to(torch.int64)
    n_seg = starts.shape[0]
    seg_ids = torch.repeat_interleave(
        torch.arange(n_seg, device=starts.device), lens)
    covered = int(seg_ids.shape[0])
    # The runs are contiguous from pair 0, so the covered pairs are the
    # first `covered` columns.
    if int(starts[0]) != 0 or int(ends.max()) != covered:
        raise AssertionError("segment_rowsum: the captured runs do not tile "
                             "[0, covered)")
    vals = rows_cm[:, :covered]
    lib = time_ms(lambda: torch.zeros(
        (rows_cm.shape[0], n_seg), dtype=torch.float32,
        device=vals.device).index_add_(1, seg_ids, vals), reps)
    b, by = bound(4 * (rows_cm.shape[0] * covered + 2 * n_seg
                       + rows_cm.shape[0] * n_seg))
    rows.append(dict(name="segment_rowsum", route="cuda",
                     source=_rel(_cuda.CSRC / segreduce.SEG_KERNEL.source),
                     replaces=segreduce.SEG_KERNEL.replaces,
                     launches=unfused_launches["segment_rowsum"],
                     max_abs_err=err,
                     tolerance="rtol 1e-4 + atol 1e-5 of the largest |sum|; "
                               "two launches bit-equal",
                     largest_sum=top, ms=ms, plain_ms=plain, bound_ms=b,
                     bound_by=by, library_ms=lib,
                     library="torch.Tensor.index_add_ (segment ids prepared "
                             "outside the timing)",
                     shapes=[list(rows_cm.shape), n_seg],
                     covered_pairs=covered, longest_run=int(lens.max()),
                     runs_over_32=int((lens > 32).sum()),
                     empty_runs=int((lens == 0).sum())))

    # H: row scans at the three shapes of the JAX package's
    # micro-benchmark. int32 exact; the float32 sum at rtol 1e-5 of the
    # column's largest running magnitude (its association differs from
    # torch.cumsum's).
    ms = plain = lib = nbytes = err = 0.0
    shapes = []
    for op, x in calls["scan_rows"]:
        fn, fn_plain = ((scan.cummax_rows, scan.cummax_rows_plain)
                        if op == "max" else
                        (scan.cumsum_rows, scan.cumsum_rows_plain))
        # torch.cummax / torch.cumsum along dim 0 of an (M, C) array take
        # about a second each at these shapes: the plain version runs once
        # (and once more in float64 for the float32 sum), timed as it runs.
        holder = {}
        one_plain = time_ms(lambda: holder.update(want=fn_plain(x)), 1,
                            warmup=0)
        got, want = fn(x), holder.pop("want")
        if x.dtype == torch.int32:
            if not torch.equal(got, want):
                raise AssertionError(f"scan_rows {op} {tuple(x.shape)} "
                                     f"int32 is not exact")
        else:
            # Millions of float32 terms: the plain version's own rounding
            # is of the tolerance's size, so the kernel is held against
            # the plain version run in float64.
            want64 = fn_plain(x.double())
            plain_err = float((want.double() - want64).abs().max())
            e = (got.double() - want64).abs()
            top = want64.abs().amax(dim=0, keepdim=True)
            if bool((e > 1e-5 * top).any()):
                raise AssertionError(
                    f"scan_rows {op} {tuple(x.shape)} float32: error "
                    f"{float((e / top).max())} of the column's largest "
                    f"(rtol 1e-5)")
            err = max(err, float(e.max()))
            del want64, e
        if not torch.equal(got, fn(x)):
            raise AssertionError("scan_rows: two launches differ")
        del got, want
        one = time_ms(lambda: fn(x), reps)
        ms += one
        plain += one_plain
        lib += one_plain      # the plain version is the library call
        nbytes += 2 * 4 * x.numel()
        shapes.append(dict(shape=list(x.shape), dtype=str(x.dtype), op=op,
                           ms=one, library_ms=one_plain,
                           plain_float32_abs_err=(
                               plain_err if x.dtype == torch.float32
                               else None),
                           bound_ms=2 * 4 * x.numel() / HBM_BYTES_PER_S
                           * 1e3))
    b, by = bound(nbytes)
    rows.append(dict(name="scan_rows", route="cuda",
                     source=_rel(_cuda.CSRC / scan.ROWS_KERNEL.source),
                     replaces=scan.ROWS_KERNEL.replaces,
                     launches=scan_launches["scan_rows"], max_abs_err=err,
                     tolerance="int32 exact; float32 sum rtol 1e-5 of the "
                               "column's largest, against the plain version "
                               "in float64; two launches bit-equal",
                     ms=ms, plain_ms=plain, bound_ms=b, bound_by=by,
                     library_ms=lib,
                     library="torch.cummax / torch.cumsum along dim 0",
                     on_render_path=False, shapes=shapes))
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
    phase_reference_modes(args.seed)
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
    cams2 = cameras(2, FLAGSHIP.width, FLAGSHIP.height, FLAGSHIP.focal,
                    "cuda")
    sliced_calls, sliced_launches = phase_sliced(state, tracks, cfg, rcfg,
                                                 cams2, batch)
    calls.update(sliced_calls)
    unfused_calls, unfused_launches = phase_unfused(state.store, tracks, cfg,
                                                    rcfg, cam0)
    calls.update(unfused_calls)
    del state
    scan_calls, scan_launches = phase_row_scans(args.seed)
    calls.update(scan_calls)
    rows = phase_kernels(calls, launches, train_launches, sliced_launches,
                         unfused_launches, scan_launches)
    for r in rows:
        r["card"] = smi
    emit("earlier_times", quoted_from="PERF.md section 6",
         measured_in_this_run=False, ms=EARLIER_MS)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
