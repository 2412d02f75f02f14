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
                and so does its render on tracks with no frame (a clip
                without tracked objects: no object drawn on either); one
                training step and one refinement pass of it from the
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
  9. row_scan_path  kernel H, which no render path of either package
                calls, through its entry points cumsum_rows / cummax_rows at
                the three shapes of the JAX package's micro-benchmark;
 10. splatfacto_path  the single-model pipeline at full width: the
                flagship's background alone (1,048,576 gaussians, SH degree
                3, Fourier dim 1, the 6x1024x1024 sky) through
                models.splatfacto.forward(training=False) for 4 cameras of
                1600x1056, then 3 engine.train_step.train_step steps from
                step 3600 and one refine_step, each counted; first the same
                pipeline at 64x48 on the card against the CPU (heads, loss,
                gradients, statistics, refine counts);
 11. camopt_path  the flagship train state with the camera optimizer,
                "SO3xR3", then "SE3" with bbox_mode="SE3" and
                bbox_differentiable=True: 3 counted steps each on rows 0, 3,
                5 of 8 pose deltas (calls 3, the accumulator non-zero on
                those rows only, the delta_rot gradient finite), the step
                time beside train_path's; first 100 calls at 64x48 on the
                card and on the CPU (the deltas still through call 99,
                moved at call 100, the two equal);
 12. cli_path   the entry points a user runs, on a clip on disk at full
                width: write_clip writes 10 frames of 1600x1056 (PNG renders
                of a seeded truth scene by the port, segs with the top third
                sky), a COLMAP model with 1,000,000 points in the corridor,
                annotation.json with 4 moving vehicles and 30,000 LiDAR
                points each; then scripts.train.main (the defaults but the
                paths, 100 steps, a checkpoint every 50: SH degree 3, Fourier
                dims 1 / 5, the 1024 sky cubemap, capacities 2^20 / 2^15;
                the refine pass at step 100, the eval split at the end),
                scripts.eval.main, scripts.render.main (rgb, accumulation,
                background_rgb, object_rgb, gt-rgb, and depth where OpenCV
                imports), scripts.export.main. Checks: the loss finite and
                falling, both checkpoints, finite PSNR / SSIM / LPIPS, the
                PSNR equal to a direct render of the restored state (1e-3
                dB), a PNG per eval frame and head, the exported rows equal
                to the active counts, kernels A-F and I launched in training
                and A-D and I in eval + render (the counts set to 0 before
                each), no
                capacity overflow, the native COLMAP reader used. Prints the
                trainer's construction split, steps/s, the refine pass,
                checkpoint, eval_setup, eval, render and export times, the
                peak memory and the card machine's Pillow and OpenCV;
 13. viewer_path  the live viewer on cli_path's run: eval_setup +
                attach_viewer(port=0) on 127.0.0.1 serving /, /init, /state
                and 8 frames (4 at 480x270, 4 at 960x540) to a client
                thread while this thread services them (JPEGs of the
                ladder's size, renders bit for bit a direct forward_scene,
                A-D counted, each request's client latency and each
                render's device ms, one frame's torch.profiler trace in
                chiprun_out/viewer_trace/ holding kernel D's launches);
                then a Trainer on the clip with viewer_port=0 and
                camera_opt_mode="SE3" answering 4 requests between its 20
                steps;
 14. bf16_path  RenderConfig(precision="bf16"): the small scene's render,
                step and refine on the card against the CPU
                (reference_bf16, reference_train_bf16, at reference's and
                reference_train's tolerances), then the flagship: the f32
                and the bf16 frame of one camera (rgb max and mean
                difference, beside the JAX docstring's "sub-1e-2"), and,
                counted, 4 bf16 eval frames, 3 bf16 steps and a refine
                pass, the f32 frame and step beside them;
 15. mesh_path  parallel/ at full width: (a) mesh_path_unit, a (1, 1)
                mesh on NCCL (world 1, this process): 3 sharded steps and
                a sharded refine against scene_train_step /
                scene_refine_step from the same state (losses 2e-5, the
                first step's gradients 1e-4 of each group's largest,
                refine counts exact, bit-equality printed); (b)
                mesh_path_shared, two processes sharing the card through
                gloo named explicitly (tests/torch_ranks.run_ranks): the
                (2, 1) loss against the mean of two single-device losses
                (2e-5) and its gradients against their mean (1e-4); the
                (1, 2) mesh in float32 and in bf16 against the single
                device at its precision: the merged frame (rgb and
                accumulation; against 2e-3 the printed value is the
                finding, above 1e-2 it fails), the loss (5e-5), the
                per-device pair counts (summing to the single device's,
                max / mean <= 1.1), the first step's gradients (0.5 of
                each group's largest: the lost done state moves the
                sky's by 0.13); correctness, not scaling; (c)
                mesh_path_cli, after
                viewer_path: the train CLI with --mesh-data 1
                --mesh-model 1 on cli_path's clip for 20 steps, its
                checkpoint restored by the single-device eval_setup; (d)
                mesh_path_viewer, the live viewer of a multi-process run:
                two gloo ranks sharing the card, each a ShardedTrainer(
                viewer_port=0) on cli_path's clip as a (1, 2) mesh, 20
                steps while a client asks for 4 frames at 480x270 and 1
                at 960x540 and parks one more during the final step
                (JPEGs of the ladder's sizes, rank 1 bound no port, every
                frame bit for bit the single-device _viewer_render of the
                same state, A-D and I counted in the frames and A-F and I
                in the steps, no render_error, no overflow, both ranks exit 0),
                then 20 steps with the viewer on and 20 off (steps/s
                each, the hand-off's ms), each request's latency, the
                gather's and the render's ms, each rank's peak memory;
 16. preprocess_path  the offline preprocess, raw clip to trained scene:
                write_raw_clip writes a clip in extract_waymo's layout (20
                frames 0.1 s apart of Waymo's five cameras as JPEG, FRONT,
                FRONT_LEFT, FRONT_RIGHT at 1920x1280 and the SIDEs at
                1920x886; a 170,000-point TOP sweep a frame; 6 moving cars
                of 800-1,200 returns a sweep and 6 parked ones in
                annotation.json); the port's tools run on the card as
                scripts/data_process.sh chains them (segs naive, masks
                --dilate 25, transform2colmap, run_colmap, whose
                RuntimeError without a colmap is printed before the
                origin model becomes sparse/0, pcd2colmap at 10,000
                points a sweep, combine, extract_object_pts) and again
                with --device cpu on a copy: segs and masks byte-equal,
                the LiDAR rows' ids and colours equal and xyz within 1e-9
                of the point's norm, the plys' gids, rows and colours
                equal and xyz within one float32 ulp; then
                scripts.train.main on FRONT with the combined seeds for
                20 steps and scripts.eval.main: 200,000 seeds, 6 tracks,
                each car's ply holding its returns, a finite loss, A-F
                and I launched in training and A-D and I in eval (the
                counts set to 0 before each), no capacity overflow. Prints each tool's
                seconds on the card and on the CPU, and for each JPEG the
                pixels that Pillow's decode (segs, pcd2colmap) and
                OpenCV's (the masks tool, as the reference) differ by;
 17. schedule_path  the whole training schedule through sgnt-train:
                write_clip's clip with 500,000 seeds (10 frames of
                1600x1056, 4 vehicles of 30,000 LiDAR points), scripts.
                train.main for 1,000 steps of the default model with
                500,608 background slots and max_pairs 12,000,000 without
                the probe (so the first densify meets a full store and
                the capacity check doubles max_pairs), the
                schedule compressed on the command line (SCHEDULE: warmup
                100, a refine every 100 steps, an opacity reset every 5
                refines, the SH degree up every 200 steps, screen-size
                rules until 600, splits until 900, on --model.base,
                --model.background and --model.object-template), then
                scripts.eval.main. Checks: every event at the step the
                schedule gives (densify 200, 300, 400, 700, 800; reset 600;
                final cull 900; SH degrees 1-3 at 200, 400, 600; three
                renders a step past 900); every parameter group and Adam
                moment finite at every refine; no pair or row-run overflow
                left standing by the capacity check after it; the first
                densifying refine and the reset refine run again on the
                CPU from the same state and split noise, counts, masks,
                statistics and moments exact and parameters within 1e-6;
                kernels A-F of one train step at the final state against
                their plain versions at phase 18's tolerances; the final
                loss below the first; A-F and I launched in training (the
                counts set to 0 before it). Prints each refine's counts, the
                gaussians after it, its host and device ms, each capacity
                growth and overflow with its step, steps/s before
                densification, while densifying and past stop_split_at,
                loss and PSNR every 100 steps, the held-out PSNR, the peak
                memory, and the final step's pair counts and visited /
                contributing shares beside train_path's random-weight
                step's;
 18. kernels    every kernel of these paths, on the inputs captured from
                them, against its plain version, with its time, the plain
                version's time, a PyTorch library call's time where one
                computes the same function (for C the JAX package's own
                off-TPU formulation: a stack and a transposing copy), and
                its bound; D and E also in their t_in mode (no caller in
                the port: a second window over each tile's trailing
                pairs, its t_in from a first pass over the leading ones)
                and with a tile0 strip held bit for bit against the full
                launch; A also in float32, counted for
                device launches a call (1) and repeated 200 times over two
                streams; D and E with their registers and occupancy from
                the build log and the pairs a tile needs (D) or visits
                (E); D with n_contrib equal to the plain version's on
                every pixel; E also as the fused routes call it (into an
                undefined buffer), with the time of the zero fill it
                spares; F also behind a busy card, beside index_add_, with
                the pairs a rank owns; G (no caller in the port) on the
                train step's rank-ordered gradient rows, one segment per
                rank; G and H counted for device launches a call (1) and
                also timed behind a busy card, G beside index_add_, H's
                float32 sum repeated 200 times over two streams; I (the
                row trim) on the eval render's and the
                train render's own arguments, first, last and count
                equal to the plain trim's, counted for device launches a
                call (1), also timed behind a busy card, its bound the
                bytes it reads and writes (52 a gaussian); J (the SH
                colour) on the eval frame's and the train step's own
                arguments, its colours equal to the k-order formulation
                (tests/sh_cases.k_order) bit for bit and to the einsum's
                within 2e-6, its gradients equal to autograd's through
                both (the einsum's where its sum is on the same side of
                the clamp), one device launch a call each way, forward
                and backward also behind a busy card, beside the plain
                path and the einsum alone, its bounds the bytes each way
                reads and writes (217 a slot at degree 3); K (Adam) on the
                train step's own 16 leaves and on scene_graph_waymo3's
                leaf set, p', m', v' equal to the plain version's bit for
                bit, one device launch a call, also behind a busy card,
                beside the plain version and torch.optim.Adam(fused=True)
                over the same leaves, its bound 28 bytes a float and a
                mask byte a row. A line of its
                own before the `kernels` line
                quotes the times rows A, E, D, F, G and H had before their
                redesign; every number in the `kernels` line itself is
                this run's. Each row's `launches` is the main path's;
                `launches_on_later_paths` adds those of phases 10, 11 (its
                SE3 mode), 13, 14, 15 (each of its four parts, the
                viewer's frames and steps apart), 16 and 17.
The line before the last is the `kernels` JSON; the last line is
{"ok": true, "device": {...}}. Any failure raises and exits non-zero.
"""
from __future__ import annotations

import argparse
import dataclasses
import io
import json
import math
import re
import shutil
import struct
import subprocess
import sys
import tempfile
import threading
import time
import urllib.parse
import urllib.request
import warnings
from pathlib import Path
from types import SimpleNamespace
from typing import Optional

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))

import torch  # noqa: E402

from street_gaussians_ns_tpu_torch.core.cameras import (  # noqa: E402
    Camera, draw_pixel_jitter)
from street_gaussians_ns_tpu_torch.core.cameras import viewmat_from_c2w  # noqa: E402
from street_gaussians_ns_tpu_torch.core.projection import (  # noqa: E402
    coverage_q, project)
from street_gaussians_ns_tpu_torch.core.sh import sh_basis  # noqa: E402
from street_gaussians_ns_tpu_torch.data import colmap_io  # noqa: E402
from street_gaussians_ns_tpu_torch.data.ply_io import (  # noqa: E402
    read_ply, write_ply)
from street_gaussians_ns_tpu_torch.engine import optimizers  # noqa: E402
from street_gaussians_ns_tpu_torch.engine import scene_train_step as sts  # noqa: E402
from street_gaussians_ns_tpu_torch.engine import train_step as ts_mod  # noqa: E402
from street_gaussians_ns_tpu_torch.engine import trainer as trainer_mod  # noqa: E402
from street_gaussians_ns_tpu_torch.engine.checkpoints import (  # noqa: E402
    state_to_numpy, store_from_numpy, tracks_from_numpy,
    train_state_from_numpy)
from street_gaussians_ns_tpu_torch.engine.setup import (  # noqa: E402
    eval_setup, load_run_config)
from street_gaussians_ns_tpu_torch.models import refinement  # noqa: E402
from street_gaussians_ns_tpu_torch.models import splatfacto  # noqa: E402
from street_gaussians_ns_tpu_torch.models.gaussians import (  # noqa: E402
    GaussianParams, GaussianStore, zeros_stats)
from street_gaussians_ns_tpu_torch.models.scene_graph import (  # noqa: E402
    SceneGraphConfig, compose, forward_scene, scene_loss_dict)
from street_gaussians_ns_tpu_torch.models.splatfacto import (  # noqa: E402
    SplatfactoConfig, sh_colors, sky_color)
from street_gaussians_ns_tpu_torch.ops import _cuda  # noqa: E402
from street_gaussians_ns_tpu_torch.ops import adam as adam_kernel  # noqa: E402
from street_gaussians_ns_tpu_torch.ops import (  # noqa: E402
    composite, expand, scan, segreduce, tiles)
from street_gaussians_ns_tpu_torch.ops import project as project_kernel  # noqa: E402
from street_gaussians_ns_tpu_torch.ops import sh_colors as sh_kernel  # noqa: E402
from street_gaussians_ns_tpu_torch.ops.render import (  # noqa: E402
    RenderConfig, render)
from street_gaussians_ns_tpu_torch.ops.ssim import psnr  # noqa: E402
from street_gaussians_ns_tpu_torch.scripts import eval as eval_cli  # noqa: E402
from street_gaussians_ns_tpu_torch.scripts import export as export_cli  # noqa: E402
from street_gaussians_ns_tpu_torch.scripts import render as render_cli  # noqa: E402
from street_gaussians_ns_tpu_torch.scripts import train as train_cli  # noqa: E402
from street_gaussians_ns_tpu_torch.utils import profiling  # noqa: E402
from street_gaussians_ns_tpu_torch.utils.optional import pillow_image  # noqa: E402
from street_gaussians_ns_tpu_torch.utils.viewer import RES_LADDER  # noqa: E402

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
# Quoted, not measured here: the times of rows A, E, D, F, G and H before
# the kernels were redesigned (PERF.md section 6; NVIDIA H100 80GB HBM3,
# 700 W). Printed on a line of their own, never in the `kernels` line.
EARLIER_MS = {"flat_scan": 0.111, "composite_bwd": 1.298,
              "composite_bwd[t_in]": 0.135, "composite_fwd": 0.367,
              "composite_fwd[t_in]": 0.0376, "rank_rowsum": 0.162,
              "segment_rowsum": 0.187,
              "scan_rows[(4456448, 6) int32 max]": 0.227,
              "scan_rows[(4456448, 8) int32 max]": 0.283,
              "scan_rows[(4456448, 16) float32 add]": 0.600}
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
    def cloud(cam):
        flat, active, _ = compose(store, tracks, cam.time, config=cfg)
        return flat, active
    return _capacity(cloud, cams, step)


def _capacity(cloud, cams, step: int):
    """size_capacity over `cloud(cam)` -> (params dict with means, log
    scales, quats and logit opacities; active mask)."""
    pairs = rowruns = 0
    for cam in cams:
        flat, active = cloud(cam)
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


def phase_reference(seed: int, precision: str = "f32",
                    phase: str = "reference"):
    """A small scene graph (64x48) rendered on the card (the kernels) and
    on the CPU (their plain versions) must agree: rgb and accumulations
    at atol 2e-5, depths at rtol 1e-4 where the accumulation > 1e-3."""
    store_np, tracks_np = make_scene(seed + 1, 600, 2, 80, 16, sh_degree=1)
    cfg = scene_config(1, 16, 5)
    rcfg = RenderConfig(max_pairs=1 << 14, precision=precision)
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
    no_tracks = {}
    if precision == "f32":
        no_tracks = reference_no_tracks(store_np, tracks_np, cfg, rcfg)
    emit(phase, size=[64, 48], precision=precision, max_err=errs,
         no_tracks_max_err=no_tracks)


def reference_no_tracks(store_np: dict, tracks_np: dict, cfg, rcfg,
                        devices=("cpu", "cuda")):
    """The reference scene on tracks with no frame (a clip without
    tracked objects): card against CPU at reference's tolerances, and no
    object drawn on either."""
    store_np = {k: (v[:0] if k.startswith("delta_") else v)
                for k, v in store_np.items()}
    tracks_np = {k: (v[:0] if k in ("times", "centers", "quats", "valid")
                     else v) for k, v in tracks_np.items()}
    outs = []
    for dev in devices:
        store = store_from_numpy(store_np, cfg, device=dev)
        tracks = tracks_from_numpy(tracks_np, device=dev)
        cam = Camera.make(60.0, 60.0, 32.0, 24.0,
                          np.eye(3, 4, dtype=np.float32), 64, 48, time=0.6,
                          device=dev)
        with warnings.catch_warnings():
            warnings.simplefilter("error", RuntimeWarning)
            outs.append(forward_scene(store, tracks, cam, 0, cfg, rcfg,
                                      eval_extras=True)[0])
    for dev, out in zip(devices, outs):
        if float(out["object_acc"].max()) != 0.0:
            raise AssertionError(f"no-tracks scene draws objects on {dev}")
    if float(outs[0]["accumulation"].max()) <= 0.3:
        raise AssertionError("no-tracks scene renders almost nothing")
    return _heads_close(outs[1], outs[0], atol=2e-5)


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


def phase_reference_train(seed: int, devices=("cpu", "cuda"),
                          precision: str = "f32",
                          phase: str = "reference_train"):
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
    rcfg = RenderConfig(max_pairs=1 << 14, precision=precision)
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
    emit(phase, size=[64, 48], precision=precision,
         tolerance="loss atol 2e-5; gradients 1e-4 of the group's largest "
         "|g|; counts exact", max_err=errs, refine=want["info"])


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
                 "composite_fwd": 3, "row_trim": 3, "sh_colors": 1,
                 "project": 3}
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
    subset_accs=True, one refinement pass. Returns (state, batch,
    launches, median ms of the subset_accs=False steps). dev="cpu"
    rehearses it on the plain versions (no launch counts there)."""
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
                "composite_bwd": backwards, "rank_rowsum": backwards,
                "row_trim": renders, "sh_colors": 2 * len(plan),
                "sh_colors[bwd]": len(plan), "adam": len(plan),
                "project": renders + backwards, "project[bwd]": backwards}
    for name, n in expected.items():
        if dev == "cuda" and launches.get(name, 0) != n:
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
    return state, batch, launches, ms


def capture_train(state, tracks, cfg, rcfg, cam, batch):
    """Inputs of kernels E and F in one full-width backward (one step's
    full render), of kernel I in its binning, of kernels J and L (both
    ways) and of kernel K (the step's Adam groups), with the step's
    results."""
    jitter = draw_pixel_jitter(cam, state.generator)
    recs = [Recorder(composite, "composite_bwd"),
            Recorder(composite, "rank_rowsum"),
            Recorder(tiles, "_row_trim_counts"),
            Recorder(sh_kernel, "sh_colors_cuda"),
            Recorder(project_kernel, "project_cuda"),
            Recorder(project_kernel, "project_bwd")]
    for r in recs:
        r.__enter__()
    try:
        res = sts.scene_loss_and_grads(state, tracks, cam, batch, cfg, rcfg,
                                       subset_accs=False, jitter=jitter)
        g = res[4]
        with Recorder(optimizers, "_step_kernel") as adam_rec:
            sts.scene_adam(state.store, state.opt, g["gauss"], g["env_map"],
                           g["bbox"], state.step)
    finally:
        for r in recs:
            r.__exit__()
    calls = {r.name: r.calls for r in recs}
    calls["row_trim[train]"] = calls.pop("_row_trim_counts")
    calls["sh_colors[train]"] = calls.pop("sh_colors_cuda")
    calls["project[train]"] = calls.pop("project_cuda")
    calls["project[bwd]"] = calls.pop("project_bwd")
    calls["adam[train]"] = adam_rec.calls
    return calls, jitter, res


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
        sts.scene_adam(store, state.opt, grads["gauss"], grads["env_map"],
                       grads["bbox"], state.step)

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
        return project(flat["means"], scales, flat["quats"], vm, cam.fx,
                       cam.fy, cam.cx, cam.cy, cam.width, cam.height,
                       opacities=op, active=active)

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


# ---------------------------------------------------------------------------
# The entry points on a clip on disk.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Clip:
    """The clip cli_path writes and how long it trains."""

    frames: int = 10
    points: int = 1_000_000        # points3D.bin, under the 2^20 default
    objects: int = 4
    obj_points: int = 30_000       # each vehicle's LiDAR, under 2^15
    steps: int = 100
    save_every: int = 50
    size: Size = FLAGSHIP
    train_flags: tuple = ()        # more sgnt-train flags (the rehearsal's)


CLIP = Clip()
CLIP_TS0 = 1_557_000_000_000_000   # 16-digit microsecond stamps
CLIP_DT_US = 100_000               # 0.1 s between frames
CLIP_HEADS = ["rgb", "accumulation", "background_rgb", "object_rgb",
              "gt-rgb"]
SKY_ID = 27                        # Mapillary sky


def clip_truth(seed: int, clip: Clip = CLIP):
    """The seeded scene graph a clip is made from: make_scene's corridor
    with clip.points background gaussians and clip.objects vehicles of
    clip.obj_points, on tracks over the clip's frames; the times are the
    clip's stamps as the data parser maps them (seconds from the first)."""
    store, _ = make_scene(seed, clip.points, clip.objects, clip.obj_points,
                          env_res=64)
    f32 = np.float32
    F, O = clip.frames, clip.objects
    lanes = np.array([-3.0, 3.0, -1.5, 1.5], f32)
    centers = np.zeros((F, O, 3), f32)
    quats = np.zeros((F, O, 4), f32)
    for f in range(F):
        for o in range(O):
            centers[f, o] = (lanes[o % 4], -1.2, -(10.0 + 9.0 * o) - 1.2 * f)
            yaw = 0.1 * (o - 1.5) + 0.03 * f
            quats[f, o] = (math.cos(yaw / 2), 0.0, math.sin(yaw / 2), 0.0)
    stamps = CLIP_TS0 + CLIP_DT_US * np.arange(F, dtype=np.int64)
    tracks = {
        "times": ((stamps - stamps[0]).astype(np.float64) * 1e-6).astype(f32),
        "centers": centers, "quats": quats,
        "valid": np.ones((F, O), bool),
        "sizes": np.tile(np.array([[2.4, 1.6, 4.8]], f32), (O, 1)),
        "obj_first": np.zeros((O,), f32),
        "obj_last": np.full((O,), F - 1, f32),
    }
    store["delta_center"] = np.zeros((F, O, 3), f32)
    store["delta_yaw"] = np.zeros((F, O), f32)
    store["delta_rot"] = np.zeros((F, O, 3), f32)
    return store, tracks, stamps


def _rgb8(dc0: np.ndarray) -> np.ndarray:
    """SH DC row -> the uint8 colour it renders at."""
    return (np.clip(dc0 * SH_C0 + 0.5, 0.0, 1.0) * 255).astype(np.uint8)


def write_clip(root: Path, seed: int, clip: Clip = CLIP, dev="cuda"):
    """A clip in tests/test_data.write_clip's layout, at full width, from
    clip_truth(seed): COLMAP binary model (one PINHOLE camera, the frames,
    points3D.bin of the background means), transform.json, PNG images
    rendered from the truth by the port on the card, segs/ with the top
    third sky, annotation.json with the vehicles' boxes, and each
    vehicle's LiDAR as aggregate_lidar/dynamic_objects/<gid>.ply. Returns
    the seconds it took, by part."""
    Image = pillow_image()
    t0 = time.perf_counter()
    store_np, tracks_np, stamps = clip_truth(seed, clip)
    names = [f"cam1/{s}.png" for s in stamps]
    recon = root / "colmap" / "sparse" / "0"
    recon.mkdir(parents=True)
    w, h, focal = clip.size.width, clip.size.height, clip.size.focal
    with open(recon / "cameras.bin", "wb") as f:
        f.write(struct.pack("<Q", 1))
        f.write(struct.pack("<iiQQ", 1, 1, w, h))          # PINHOLE
        f.write(struct.pack("<4d", focal, focal, w / 2, h / 2))
    c2ws = []
    with open(recon / "images.bin", "wb") as f:
        f.write(struct.pack("<Q", len(names)))
        for i, name in enumerate(names):
            c2w = np.eye(4)
            c2w[2, 3] = -1.5 * i                   # OpenGL, down the corridor
            c2ws.append(c2w[:3].astype(np.float32))
            cv = c2w.copy()
            cv[:3, 1:3] *= -1                      # OpenGL -> OpenCV
            w2c = np.linalg.inv(cv)
            f.write(struct.pack("<idddddddi", i + 1,
                                *colmap_io.rotmat2qvec(w2c[:3, :3]),
                                *w2c[:3, 3], 1))
            f.write(name.encode() + b"\x00")
            f.write(struct.pack("<Q", 0))
    rec = np.zeros(clip.points, np.dtype([
        ("id", "<u8"), ("xyz", "<f8", 3), ("rgb", "u1", 3), ("err", "<f8"),
        ("track", "<u8")]))
    rec["id"] = np.arange(clip.points)
    rec["xyz"] = store_np["background/params/means"]
    rec["rgb"] = _rgb8(store_np["background/params/features_dc"][:, 0])
    rec["err"] = 0.5
    with open(recon / "points3D.bin", "wb") as f:
        f.write(struct.pack("<Q", clip.points))
        f.write(rec.tobytes())
    with open(root / "transform.json", "w") as f:
        json.dump({"frames": [
            {"file_path": f"images/{n}", "timestamp": int(s),
             "transform_matrix": np.eye(4).tolist()}
            for n, s in zip(names, stamps)]}, f)
    lidar = root / "aggregate_lidar" / "dynamic_objects"
    lidar.mkdir(parents=True)
    boxes = []
    for f_idx, s in enumerate(stamps):
        boxes.append({"timestamp": int(s), "objects": [
            {"gid": f"veh{o}", "type": "car", "is_moving": True,
             "translation": tracks_np["centers"][f_idx, o].tolist(),
             "rotation": tracks_np["quats"][f_idx, o].tolist(),
             "size": tracks_np["sizes"][o].tolist()}
            for o in range(clip.objects)]})
    with open(root / "annotation.json", "w") as f:
        json.dump({"frames": boxes}, f)
    for o in range(clip.objects):
        xyz = store_np["objects/params/means"][o]
        rgb = _rgb8(store_np["objects/params/features_dc"][o, :, 0])
        write_ply(lidar / f"veh{o}.ply", {
            "x": xyz[:, 0], "y": xyz[:, 1], "z": xyz[:, 2],
            "red": rgb[:, 0], "green": rgb[:, 1], "blue": rgb[:, 2]})
    seg = np.zeros((h, w), np.uint8)
    seg[: h // 3] = SKY_ID
    files_s = time.perf_counter() - t0

    t1 = time.perf_counter()
    cfg = scene_config(3, 64, 5)
    store = store_from_numpy(store_np, cfg, device=dev)
    tracks = tracks_from_numpy(tracks_np, device=dev)
    del store_np
    cams = [Camera.make(focal, focal, w / 2, h / 2, c2w, w, h, time=t,
                        device=dev)
            for c2w, t in zip(c2ws, tracks_np["times"])]
    max_pairs, max_rowruns, _, _ = size_capacity(store, tracks, cfg, cams)
    rcfg = RenderConfig(max_pairs=max_pairs, max_rowruns=max_rowruns)
    for name, cam in zip(names, cams):
        with torch.no_grad():
            rgb = forward_scene(store, tracks, cam, 0, cfg, rcfg)[0]["rgb"]
        img = root / "images" / name
        img.parent.mkdir(parents=True, exist_ok=True)
        Image.fromarray((rgb.cpu().numpy() * 255).astype(np.uint8)).save(img)
        sp = root / "segs" / name
        sp.parent.mkdir(parents=True, exist_ok=True)
        Image.fromarray(seg).save(sp)
    del store
    return {"files_s": files_s, "render_and_png_s": time.perf_counter() - t1,
            "frames": len(names)}


class Timed:
    """Times every call of a module-level function (or a class's method)
    while active, on the host's clock; with sync=True the card's work of
    the call is waited for before the clock stops."""

    def __init__(self, owner, name, sync: bool = False):
        self.owner, self.name, self.sync = owner, name, sync
        self.orig = getattr(owner, name)
        self.seconds = []

    def __enter__(self):
        def timed(*args, **kw):
            t = time.perf_counter()
            out = self.orig(*args, **kw)
            if self.sync:
                torch.cuda.synchronize()
            self.seconds.append(time.perf_counter() - t)
            return out
        setattr(self.owner, self.name, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self.orig)


def _image_libraries() -> dict:
    out = {}
    for name, module in (("pillow", "PIL"), ("opencv", "cv2")):
        try:
            out[name] = __import__(module).__version__
        except ImportError:
            out[name] = None
    return out


def phase_cli(seed: int, workdir: Path, clip: Clip = CLIP, dev="cuda"):
    """sgnt-train / eval / render / export of the port, through their
    main() functions with the defaults but the data path, the output
    directory, clip.steps steps and a checkpoint every clip.save_every, on
    a full-width clip written to workdir/clip (write_clip); the run goes
    to workdir/run, which is returned. The
    launch counts are set to 0 before training and read after it, then
    again around eval + render. dev="cpu" rehearses it on the plain
    versions (no launch counts, no device memory there)."""
    cuda = dev == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    libs = _image_libraries()
    heads = CLIP_HEADS + (["depth"] if libs["opencv"] else [])
    root, run = Path(workdir) / "clip", Path(workdir) / "run"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    made = write_clip(root, seed + 101, clip, dev)
    sync()
    colmap_io.POINTS3D_READERS.clear()
    timers = {"refine": Timed(trainer_mod, "scene_refine_step",
                              sync=cuda),
              "checkpoint": Timed(trainer_mod, "save_checkpoint"),
              "batch_to_device": Timed(trainer_mod.Trainer,
                                       "_device_batch"),
              "next_batch": Timed(trainer_mod.FullImageDatamanager,
                                  "next_train"),
              "metrics_sync": Timed(trainer_mod, "_scalars"),
              "eval_setup_eval": Timed(eval_cli, "eval_setup"),
              "eval_setup_render": Timed(render_cli, "eval_setup"),
              "eval_setup_export": Timed(export_cli, "eval_setup")}
    for t in timers.values():
        t.__enter__()
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            reset_launches()
            t = time.perf_counter()
            trainer = train_cli.main([
                "--data", str(root), "--trainer.output-dir", str(run),
                "--trainer.max-num-iterations", str(clip.steps),
                "--trainer.steps-per-save", str(clip.save_every),
                "--device", dev, *clip.train_flags])
            sync()
            train_s = time.perf_counter() - t
            train_launches = read_launches()
            reset_launches()
            t = time.perf_counter()
            evaluated = eval_cli.main(["--load-dir", str(run),
                                       "--device", dev])
            eval_s = time.perf_counter() - t
            t = time.perf_counter()
            served = render_cli.main([
                "--load-dir", str(run), "--output-path",
                str(run / "renders"), "--device", dev,
                "--rendered-output-names", *heads])
            sync()
            render_s = time.perf_counter() - t
            eval_launches = read_launches()
            t = time.perf_counter()
            exported = export_cli.main(["--load-dir", str(run),
                                        "--device", dev, "--output-dir",
                                        str(run / "exports")])
            export_s = time.perf_counter() - t
    finally:
        for t in timers.values():
            t.__exit__()
    peak = torch.cuda.max_memory_allocated() if cuda else None
    readers = dict(colmap_io.POINTS3D_READERS)
    overflow = [str(w.message) for w in caught
                if "capacity overflow" in str(w.message)]
    rows = [json.loads(r) for r in
            (run / "metrics.jsonl").read_text().splitlines()]
    steps = [r for r in rows if "train/loss" in r]
    losses = [r["train/loss"] for r in steps]
    ckpts = sorted(p.name for p in (run / "checkpoints").glob("*.npz"))
    res = evaluated["results"]
    n_eval = served.dm.num_eval
    pngs = {h: len(list((run / "renders" / h).glob("*.png")))
            for h in heads}

    # The eval CLI's PSNR against a direct forward_scene of the
    # restored state (the render CLI's trainer) on the same frames.
    direct = []
    with torch.no_grad():
        for cam, batch in served.dm.fixed_indices_eval():
            out, _, _ = forward_scene(
                served.state.store, served.tracks, cam,
                served.state.step, served.config, served.render_config)
            gt = torch.as_tensor(batch["image"]).to(dev)
            direct.append(float(psnr(out["rgb"], gt)))
    store = served.state.store
    active = {"background": int(store.background.active.sum())}
    for i in range(store.num_objects):
        active[f"object_veh{i}"] = int(store.objects.active[i].sum())
    ply_rows = {p.stem.replace("point_cloud_", ""): len(read_ply(p)["x"])
                for p in (run / "exports").glob("*.ply")}

    fails = []
    if not np.isfinite(losses).all() or len(losses) < 6:
        fails.append(f"losses {losses}")
    elif not np.mean(losses[-3:]) < np.mean(losses[:3]):
        fails.append(f"the loss did not fall: {losses}")
    want_ckpts = [f"step-{s:09d}.ckpt.npz"
                  for s in range(clip.save_every, clip.steps + 1,
                                 clip.save_every)]
    if ckpts != want_ckpts:
        fails.append(f"checkpoints {ckpts}")
    if not all(math.isfinite(res.get(k, math.nan))
               for k in ("psnr", "ssim", "lpips")):
        fails.append(f"eval results {res}")
    if abs(float(np.mean(direct)) - res["psnr"]) > 1e-3:
        fails.append(f"eval PSNR {res['psnr']} vs direct {direct}")
    if any(n != n_eval for n in pngs.values()) or n_eval < 1:
        fails.append(f"PNGs {pngs} for {n_eval} eval frames")
    if ply_rows != active or exported != active:
        fails.append(f"exported rows {ply_rows} / {exported}, active "
                     f"{active}")
    for name in FUSED_KERNELS:
        if cuda and train_launches.get(name, 0) == 0:
            fails.append(f"training launched no {name}")
    for name in RENDER_KERNELS:
        if cuda and eval_launches.get(name, 0) == 0:
            fails.append(f"eval + render launched no {name}")
    if overflow:
        fails.append(f"capacity overflow: {overflow[:2]}")
    if readers.get("native", 0) < 1 or readers.get("python", 0):
        fails.append(f"the native COLMAP reader did not parse every "
                     f"points3D.bin: {readers}")
    sps = [r["train/steps_per_sec"] for r in steps]
    timing = {k: t.seconds for k, t in timers.items()}
    emit("cli_path", frames=made["frames"], points=clip.points,
         objects=clip.objects, object_points=clip.obj_points,
         size=[clip.size.width, clip.size.height], steps=clip.steps,
         clip=made, image_libraries=libs, heads=heads,
         construction_s=trainer.setup_seconds,
         eval_setup_construction_s=served.setup_seconds,
         render_config=[trainer.render_config.max_pairs,
                        trainer.render_config.max_rowruns],
         train_s=train_s, steps_per_s_rows=sps,
         steps_per_s_median=float(np.median(sps)),
         loss_rows=losses, refine_ms=[s * 1e3 for s in timing["refine"]],
         checkpoint_s=timing["checkpoint"],
         pairs_rows=[r["train/num_pairs"] for r in steps],
         batch_to_device_ms_total=1e3 * sum(timing["batch_to_device"]),
         next_batch_ms_total=1e3 * sum(timing["next_batch"]),
         metrics_sync_ms_total=1e3 * sum(timing["metrics_sync"]),
         eval_setup_s={k[len("eval_setup_"):]: v[0] for k, v in
                       timing.items() if k.startswith("eval_setup_")},
         eval_results=res, eval_fps=res["fps"], eval_s=eval_s,
         direct_psnr=direct, render_s=render_s,
         render_ms_per_frame=1e3 * (render_s - timing["eval_setup_render"][0])
         / max(n_eval, 1), pngs=pngs, export_s=export_s,
         export_rows=ply_rows, active=active,
         max_memory_allocated=peak, points3d_readers=readers,
         train_launches=train_launches, eval_render_launches=eval_launches,
         failures=fails)
    if fails:
        raise AssertionError("cli_path: " + "; ".join(fails))
    return run


# ---------------------------------------------------------------------------
# The single-model Splatfacto pipeline.
# ---------------------------------------------------------------------------

def splat_config(sh_degree: int, env_res: int) -> SplatfactoConfig:
    """Splatfacto's defaults with the sky and the scene's SH degree."""
    return SplatfactoConfig(use_sky_sphere=True, sh_degree=sh_degree,
                            env_map_res=env_res, fourier_features_dim=1)


def splat_arrays(seed: int, n: int, env_res: int, sh_degree: int = 3):
    """make_scene's background cloud alone (the corridor, Fourier dim 1),
    its arrays keyed as a GaussianStore's, and the sky cubemap."""
    store_np, _ = make_scene(seed, n, 0, 1, env_res, sh_degree=sh_degree)
    cloud = {k[len("background/"):]: v for k, v in store_np.items()
             if k.startswith("background/")}
    return cloud, store_np["env_map"]


def gaussian_store(arrays: dict, device, every: int = 0) -> GaussianStore:
    """A GaussianStore from arrays keyed as its leaves; with every > 0,
    one slot in `every` inactive (a trainer's headroom)."""
    active = arrays["active"].copy()
    if every:
        active[every - 1::every] = False
    params = GaussianParams(**{
        k: torch.from_numpy(arrays[f"params/{k}"]).to(device)
        for k in sts.GAUSSIAN_GROUPS})
    g, v, m = zeros_stats(active.shape[0], device)
    return GaussianStore(params=params,
                         active=torch.from_numpy(active).to(device),
                         xys_grad_norm=g, vis_counts=v, max_2dsize=m)


def splat_capacity(store: GaussianStore, cams, step: int = 8192):
    """max_pairs / max_rowruns of one cloud over the cameras, as
    size_capacity sizes a scene graph's."""
    return _capacity(lambda cam: (store.params.as_dict(), store.active),
                     cams, step)


def splat_reference(seed: int, devices=("cpu", "cuda")) -> dict:
    """The Splatfacto pipeline at a small size (600 gaussians, 64x48) on
    the card against the CPU, from the same cloud, jitter and split noise,
    at reference_train's tolerances: the eval heads (atol 2e-5, depth
    rtol 1e-4), one step's loss (atol 2e-5) and gradients (1e-4 of the
    group's largest |g|), the statistics (counts exact) and one refine
    pass's counts (exact)."""
    cloud, env_np = splat_arrays(seed + 1, 600, 16, sh_degree=1)
    cfg = splat_config(1, 16)
    rcfg = RenderConfig(max_pairs=1 << 14)
    jitter = np.random.default_rng(seed + 3).random((2, 48, 64),
                                                    dtype=np.float32)
    res = {}
    for dev in devices:
        cam = Camera.make(60.0, 60.0, 32.0, 24.0,
                          np.eye(3, 4, dtype=np.float32), 64, 48, device=dev)
        env = torch.from_numpy(env_np).to(dev)
        state = dataclasses.replace(ts_mod.init_train_state(
            gaussian_store(cloud, dev, every=16), env,
            torch.Generator(device=dev).manual_seed(seed)), step=TRAIN_STEP0)
        batch = make_batch(seed, 64, 48, dev)
        jit = torch.from_numpy(jitter).to(dev)
        with warnings.catch_warnings():
            warnings.simplefilter("error", RuntimeWarning)
            with torch.no_grad():
                heads = splatfacto.forward(state.store.params,
                                           state.store.active, cam, 0, cfg,
                                           rcfg, env_map=env,
                                           training=False)[0]
            total, _, _, _, grads = ts_mod.loss_and_grads(
                state, cam, batch, cfg, rcfg, jitter=jit)
            state, metrics = ts_mod.train_step(state, cam, batch, cfg, rcfg,
                                               jitter=jit)
        noise = refinement.draw_split_noise(
            cfg, state.store.capacity, torch.Generator().manual_seed(seed),
            "cpu").to(dev)
        refined, info = ts_mod.refine_step(state, cfg, NUM_TRAIN_DATA, 64,
                                           noise=noise)
        res[dev] = dict(
            heads={k: v.cpu() for k, v in heads.items()},
            loss=float(total), step_loss=float(metrics["loss"]),
            grads={**{k: v.cpu() for k, v in grads["params"].items()},
                   "env_map": grads["env_map"].cpu(),
                   "xys": grads["xys"].cpu()},
            stats={k: getattr(state.store, k).cpu()
                   for k in ("xys_grad_norm", "vis_counts", "max_2dsize")},
            info={k: int(v) for k, v in info.items()},
            active=int(refined.store.active.sum()))
    want, got = res[devices[0]], res[devices[-1]]
    errs = _heads_close(got["heads"], want["heads"], atol=2e-5)
    for k in ("loss", "step_loss"):
        errs[k] = abs(got[k] - want[k])
        if errs[k] > 2e-5:
            raise AssertionError(f"splatfacto reference: {k} differs by "
                                 f"{errs[k]}")
    for k, w in want["grads"].items():
        top = float(w.abs().max())
        err = float((got["grads"][k] - w).abs().max())
        if not top > 0 or err > 1e-4 * top:
            raise AssertionError(f"splatfacto reference: gradient {k} "
                                 f"differs by {err} (largest |g| {top})")
        errs[f"grad {k}"] = err / top
    g_top = float(want["grads"]["xys"].abs().max())
    for k, w in want["stats"].items():
        err = float((got["stats"][k] - w).abs().max())
        if err > (1e-4 * g_top if k == "xys_grad_norm" else 0.0):
            raise AssertionError(f"splatfacto reference: stat {k} differs "
                                 f"by {err}")
    if got["info"] != want["info"] or got["active"] != want["active"]:
        raise AssertionError(f"splatfacto reference: refine counts differ: "
                             f"{got['info']} vs {want['info']}")
    if float(want["heads"]["accumulation"].max()) <= 0.3:
        raise AssertionError("splatfacto reference renders almost nothing")
    return dict(max_err=errs, refine=want["info"])


def phase_deform4d(seed: int, slots: int = 2 ** 16, dev="cuda"):
    """The 4DGS deformation field (models.deform4d) at the configuration's
    widths (Deform4DConfig's defaults: 32 channels, scales 1, 2, 4, 43
    time cells, a 96-64 decoder) over `slots` centres: its forward and
    backward on `dev` against the CPU's plain path from the same inputs
    (dX, ds, dr and the centres', planes' and decoder's gradients, to
    float32 rounding and the planes' atomic adds), the times of both
    directions, and the three spans and the samples counter read under
    the recorder (non-null on the card)."""
    from street_gaussians_ns_tpu_torch.models import deform4d as d4
    from street_gaussians_ns_tpu_torch.utils import profiling

    t_start = time.perf_counter()
    cfg = d4.Deform4DConfig()
    g = torch.Generator().manual_seed(seed + 44)
    aabb = torch.tensor([[-20.0, -3.0, -120.0], [20.0, 12.0, 5.0]])
    field = d4.init_field(cfg, aabb, torch.tensor([0.0, 8.4]), g, "cpu")
    field["planes"] = field["planes"] + 0.05 * torch.randn(
        field["planes"].shape, generator=g)
    means = aabb[0] + torch.rand((slots, 3), generator=g) * (aabb[1] - aabb[0])
    params = SimpleNamespace(means=means, scales=torch.zeros(slots, 3),
                             quats=torch.zeros(slots, 4))
    cot = [torch.randn((slots, k), generator=g) for k in (3, 3, 4)]

    def run(device):
        f = {k: v.to(device) for k, v in field.items()}
        p = SimpleNamespace(**{k: getattr(params, k).to(device)
                               for k in ("means", "scales", "quats")})
        leaves = [p.means.requires_grad_(True),
                  f["planes"].requires_grad_(True),
                  f["decoder"].requires_grad_(True)]
        out = d4.deform(p, f, torch.tensor(3.3, device=device), cfg)
        outs = [out[0] - p.means, out[1], out[2]]
        grads = torch.autograd.grad(outs, leaves,
                                    [c.to(device) for c in cot])
        return [o.detach().cpu() for o in outs], [x.cpu() for x in grads]

    want_o, want_g = run("cpu")
    got_o, got_g = run(dev)
    errs = {}
    for name, x, y in zip(("dX", "ds", "dr"), got_o, want_o):
        errs[name] = float((x - y).abs().max()) / float(y.abs().max())
    for name, x, y in zip(("means", "planes", "decoder"), got_g, want_g):
        errs["grad_" + name] = float((x - y).abs().max()) / float(
            y.abs().max())
    ok = all(v < 1e-4 for v in errs.values())
    spans, ms = {}, {}
    if dev == "cuda":
        f = {k: v.to(dev) for k, v in field.items()}
        p = SimpleNamespace(means=params.means.to(dev).requires_grad_(True),
                            scales=params.scales.to(dev),
                            quats=params.quats.to(dev))
        leaves = [p.means, f["planes"].requires_grad_(True),
                  f["decoder"].requires_grad_(True)]
        t = torch.tensor(3.3, device=dev)
        c = [x.to(dev) for x in cot]

        def fwd():
            with torch.no_grad():
                return d4.deform(p, f, t, cfg)

        def both():
            torch.autograd.grad(d4.deform(p, f, t, cfg), leaves, c)
        ms = {"forward": time_ms(fwd, 5), "forward_backward": time_ms(both, 5)}
        profiling.reset()
        profiling.enable(True)
        try:
            both()
            snap = profiling.snapshot()
        finally:
            profiling.enable(False)
            profiling.reset()
        spans = {k: snap.get(k, {}).get("device_ms") for k in (
            "deform4d.field", "deform4d.decode", "deform4d.field_bwd")}
        spans["deform4d.samples"] = snap.get("deform4d.samples",
                                             {}).get("total")
        ok = ok and all(v for v in spans.values())
    emit("deform4d_path", ok=ok, slots=slots, rel_err=errs, ms=ms,
         spans=spans, seconds=time.perf_counter() - t_start)
    if not ok:
        raise AssertionError(f"deform4d_path: errors {errs}, spans {spans}")
    return errs


def phase_splatfacto(seed: int, size: Size = FLAGSHIP, dev="cuda"):
    """The single-model pipeline at full width: the flagship's background
    alone (size.bg gaussians, SH degree 3, Fourier dim 1, the sky cubemap)
    rendered by models.splatfacto.forward(training=False) for size.frames
    cameras, then 3 engine.train_step.train_step steps from TRAIN_STEP0
    and one refine_step; the counts set to 0 just before the frames and
    before the steps and read just after each. dev="cpu" rehearses it on
    the plain versions (no launch counts there)."""
    t0 = time.perf_counter()
    ref = splat_reference(seed) if dev == "cuda" else None
    cloud, env_np = splat_arrays(seed + 5, size.bg, size.env_res)
    cfg = splat_config(3, size.env_res)
    store = gaussian_store(cloud, dev)
    env = torch.from_numpy(env_np).to(dev)
    cams = cameras(size.frames, size.width, size.height, size.focal, dev)
    max_pairs, max_rowruns, need_p, need_r = splat_capacity(store, cams)
    rcfg = RenderConfig(max_pairs=max_pairs, max_rowruns=max_rowruns)
    setup_s = time.perf_counter() - t0
    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)

    def frame(cam):
        with warnings.catch_warnings():
            warnings.simplefilter("error", RuntimeWarning)
            with torch.no_grad():
                return splatfacto.forward(store.params, store.active, cam, 0,
                                          cfg, rcfg, env_map=env,
                                          training=False)

    frame(cams[0])                     # warm-up
    sync()
    reset_launches()
    times, outs = [], []
    for cam in cams:
        t = time.perf_counter()
        outputs, out = frame(cam)
        sync()
        times.append((time.perf_counter() - t) * 1e3)
        outs.append((outputs, out))
    eval_launches = read_launches()
    if dev == "cuda":
        check_launches("splatfacto_path eval", eval_launches, {
            "flat_scan": 3 * len(cams), "expand_ragged": 2 * len(cams),
            "pack_feat_cols": len(cams), "composite_fwd": len(cams),
            "composite_bwd": 0, "rank_rowsum": 0, "row_trim": len(cams),
            "sh_colors": len(cams), "sh_colors[bwd]": 0,
            "project": len(cams), "project[bwd]": 0})
    acc_max = []
    for outputs, out in outs:
        for h, v in outputs.items():
            if not bool(torch.isfinite(v).all()):
                raise AssertionError(f"splatfacto_path: head {h} is not "
                                     f"finite")
        rgb = outputs["rgb"]
        if (tuple(rgb.shape) != (size.height, size.width, 3)
                or float(rgb.min()) < 0.0 or float(rgb.max()) > 1.0):
            raise AssertionError("splatfacto_path: rgb shape or range")
        acc_max.append(float(outputs["accumulation"].max()))
        if acc_max[-1] <= 0.5:
            raise AssertionError(f"splatfacto_path: accumulation max "
                                 f"{acc_max[-1]}")
        if (int(out.bins.num_pairs) > max_pairs
                or int(out.bins.num_rowruns) > max_rowruns):
            raise AssertionError("splatfacto_path: capacity overflow")
    del outs
    frame_ms = float(np.median(times))

    gen = torch.Generator(device=dev).manual_seed(seed)
    state = dataclasses.replace(ts_mod.init_train_state(
        gaussian_store(cloud, dev, every=16), env.clone(), gen),
        step=TRAIN_STEP0)
    del cloud, store
    first = state
    batch = make_batch(seed, size.width, size.height, dev)
    cam = cams[0]
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        total, _, _, _, grads = ts_mod.loss_and_grads(
            state, cam, batch, cfg, rcfg,
            jitter=draw_pixel_jitter(cam, state.generator))
    if not math.isfinite(float(total)):
        raise AssertionError(f"splatfacto_path: loss {float(total)}")
    flat = {**grads["params"], "env_map": grads["env_map"]}
    has_grad = {}
    for k, g in flat.items():
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"splatfacto_path: gradient {k} is not "
                                 f"finite")
        has_grad[k] = bool(g.any())
    del grads, flat
    sync()
    reset_launches()
    step_ms, losses = [], []
    for _ in range(3):
        t = time.perf_counter()
        with warnings.catch_warnings():
            warnings.simplefilter("error", RuntimeWarning)
            state, metrics = ts_mod.train_step(state, cam, batch, cfg, rcfg)
        sync()
        step_ms.append((time.perf_counter() - t) * 1e3)
        losses.append(float(metrics["loss"]))
        if not math.isfinite(losses[-1]):
            raise AssertionError(f"splatfacto_path: loss {losses[-1]}")
        if (int(metrics["num_pairs"]) > rcfg.max_pairs
                or int(metrics["num_rowruns"]) > rcfg.rowrun_capacity):
            raise AssertionError("splatfacto_path: capacity overflow in "
                                 "training")
    train_launches = read_launches()
    if dev == "cuda":
        check_launches("splatfacto_path train", train_launches, {
            "flat_scan": 9, "expand_ragged": 6, "pack_feat_cols": 3,
            "composite_fwd": 3, "composite_bwd": 3, "rank_rowsum": 3,
            "row_trim": 3, "sh_colors": 6, "sh_colors[bwd]": 3, "adam": 3,
            "project": 6, "project[bwd]": 3})
    moved = {}
    for k in sts.GAUSSIAN_GROUPS:
        new = getattr(state.store.params, k)
        if not bool(torch.isfinite(new).all()):
            raise AssertionError(f"splatfacto_path: {k} is not finite")
        moved[k] = bool((new != getattr(first.store.params, k)).any())
    moved["env_map"] = bool((state.env_map != first.env_map).any())
    dead = [k for k, g in has_grad.items() if g and not moved[k]]
    if dead:
        raise AssertionError(f"splatfacto_path: groups with a gradient did "
                             f"not move: {dead}")
    if dev == "cuda":
        peak = torch.cuda.max_memory_allocated()
    t = time.perf_counter()
    refined, info = ts_mod.refine_step(state, cfg, NUM_TRAIN_DATA,
                                       max(cam.width, cam.height))
    sync()
    refine_ms = (time.perf_counter() - t) * 1e3
    info = {k: int(v) for k, v in info.items()}
    if info["gaussian_count"] != int(refined.store.active.sum()):
        raise AssertionError("splatfacto_path: the refine pass's count "
                             "disagrees with its active mask")
    if info["refine_splits_count"] + info["refine_dups_count"] <= 0:
        raise AssertionError("splatfacto_path: the refine pass densified "
                             "nothing")
    med = float(np.median(step_ms))
    emit("splatfacto_path", gaussians=int(first.store.capacity),
         gaussians_active=int(first.store.active.sum()), sh_degree=3,
         frames=len(cams), size=[size.width, size.height],
         max_pairs=max_pairs, max_rowruns=max_rowruns, needed_pairs=need_p,
         needed_rowruns=need_r, ms_per_frame=times,
         ms_per_frame_median=frame_ms,
         mpix_per_s=size.width * size.height / 1e6 / (frame_ms / 1e3),
         accumulation_max=acc_max, first_step=TRAIN_STEP0,
         ms_per_step=step_ms, ms_per_step_median=med, steps_per_s=1e3 / med,
         loss_per_step=losses, has_grad=has_grad, moved=moved,
         refine_ms=refine_ms, refine=info,
         max_memory_allocated=peak if dev == "cuda" else None,
         setup_seconds=setup_s, eval_launches=eval_launches,
         train_launches=train_launches, reference=ref)
    return {"eval": eval_launches, "train": train_launches}


# ---------------------------------------------------------------------------
# The camera pose optimizer.
# ---------------------------------------------------------------------------

CAMOPT_MODES = (("SO3xR3", "simple", False), ("SE3", "SE3", True))
CAMOPT_ROWS = (0, 3, 5)                # the steps' rows of 8 cameras


def _camopt_state(store_np: dict, cfg, step: int, num_cameras: int, dev,
                  seed: int, rot_seed: Optional[int] = None):
    """A train state of the scene with zero camera deltas (a fresh
    run's) and, with rot_seed, small random bbox rotation deltas."""
    arrays = train_arrays(store_np, step)
    arrays["camera_opt"] = np.zeros((num_cameras, 6), np.float32)
    if rot_seed is not None:
        arrays["store/delta_rot"] = 0.02 * np.random.default_rng(
            rot_seed).standard_normal(
                store_np["delta_rot"].shape).astype(np.float32)
    return train_state_from_numpy(arrays, cfg, device=dev, seed=seed)


def camopt_reference(seed: int, calls: int = 100,
                     devices=("cpu", "cuda")) -> dict:
    """The camera group's 100-call accumulation at a small size, on the
    card and on the CPU from the same scene and jitters: camera_opt stands
    still through call 99 and moves at call 100 (to -lr sign(sum of the
    gradients) on every entry, Adam's first step); the accumulator after
    call 99 agrees within 1e-2 of its largest entry and the moved deltas
    exactly where that sum is clear of zero (above 5e-2 of the largest
    of its column)."""
    store_np, tracks_np = make_scene(seed + 1, 600, 2, 80, 16, sh_degree=1)
    cfg = dataclasses.replace(scene_config(1, 16, 5),
                              camera_opt_mode="SO3xR3", num_cameras=4)
    rcfg = RenderConfig(max_pairs=1 << 14)
    jitters = np.random.default_rng(seed + 9).random(
        (calls, 2, 48, 64), dtype=np.float32)
    res = {}
    for dev in devices:
        tracks = tracks_from_numpy(tracks_np, device=dev)
        cam = Camera.make(60.0, 60.0, 32.0, 24.0,
                          np.eye(3, 4, dtype=np.float32), 64, 48, time=1.0,
                          device=dev)
        batch = make_batch(seed, 64, 48, dev)
        state = _camopt_state(store_np, cfg, 600, 4, dev, seed)
        for i in range(calls):
            if i == calls - 1:
                acc = state.opt["camera_opt"].acc.cpu()
                still = state.camera_opt.cpu()
            state, _ = sts.scene_train_step(
                state, tracks, cam, batch, cfg, rcfg, subset_accs=False,
                jitter=torch.from_numpy(jitters[i]).to(dev),
                camera_index=i % 4)
        res[dev] = dict(acc=acc, still=still, moved=state.camera_opt.cpu(),
                        calls=state.opt["camera_opt"].calls,
                        count=state.opt["camera_opt"].count)
    want, got = res[devices[0]], res[devices[-1]]
    lr = optimizers.schedule(optimizers.DEFAULT_GROUPS["camera_opt"],
                             600 + calls - 1)
    for r in res.values():
        if r["still"].any() or r["calls"] != calls or r["count"] != 1:
            raise AssertionError(f"camopt reference: the deltas moved "
                                 f"before call {calls} or the counts are "
                                 f"off ({r['calls']}, {r['count']})")
        if not bool((r["moved"].abs() > 0.5 * lr).all()):
            raise AssertionError("camopt reference: call 100 left a delta "
                                 "in place")
    top = float(want["acc"].abs().max())
    acc_err = float((got["acc"] - want["acc"]).abs().max())
    if not top > 0 or acc_err > 1e-2 * top:
        raise AssertionError(f"camopt reference: accumulators differ by "
                             f"{acc_err} (largest {top})")
    clear = want["acc"].abs() > 5e-2 * want["acc"].abs().amax(dim=0)
    moved_err = float((got["moved"] - want["moved"])[clear].abs().max())
    if moved_err > 1e-3 * lr:
        raise AssertionError(f"camopt reference: moved deltas differ by "
                             f"{moved_err}")
    return dict(calls=calls, lr=lr, acc_rel_err=acc_err / top,
                moved_max_err=moved_err, entries_compared=int(clear.sum()))


def phase_camopt(seed: int, tracks, cfg, rcfg, size: Size = FLAGSHIP,
                 train_ms: Optional[float] = None, dev="cuda"):
    """The flagship train state with the camera optimizer: "SO3xR3", then
    "SE3" with bbox_mode="SE3" and bbox_differentiable=True; 3 steps each
    on 3 cameras and rows CAMOPT_ROWS of 8 pose deltas, the counts set to
    0 before the steps and read after. The step time is printed beside
    train_path's (`train_ms`, the same call)."""
    ref = camopt_reference(seed) if dev == "cuda" else None
    store_np, _ = make_scene(seed, size.bg, size.objects, size.per_object,
                             size.env_res)
    cams = cameras(3, size.width, size.height, size.focal, dev)
    batch = make_batch(seed, size.width, size.height, dev)
    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    modes = {}
    launches = None
    for mode, bbox_mode, bbox_diff in CAMOPT_MODES:
        mcfg = dataclasses.replace(cfg, camera_opt_mode=mode, num_cameras=8,
                                   bbox_mode=bbox_mode,
                                   bbox_differentiable=bbox_diff)
        state = _camopt_state(store_np, mcfg, TRAIN_STEP0, 8, dev, seed,
                              rot_seed=seed + 2 if bbox_diff else None)
        with warnings.catch_warnings():
            warnings.simplefilter("error", RuntimeWarning)
            _, _, _, _, grads = sts.scene_loss_and_grads(
                state, tracks, cams[2], batch, mcfg, rcfg, subset_accs=False,
                jitter=draw_pixel_jitter(cams[2], state.generator),
                camera_index=CAMOPT_ROWS[2])
        g_cam, g_rot = grads["camera_opt"], grads["bbox"]["delta_rot"]
        for name, g in (("camera_opt", g_cam), ("delta_rot", g_rot)):
            if not bool(torch.isfinite(g).all()):
                raise AssertionError(f"camopt_path {mode}: the {name} "
                                     f"gradient is not finite")
        if not bool((g_cam[CAMOPT_ROWS[2]] != 0).all()):
            raise AssertionError(f"camopt_path {mode}: no pose gradient")
        if bbox_diff and not bool(g_rot.any()):
            raise AssertionError(f"camopt_path {mode}: no delta_rot "
                                 f"gradient with bbox_differentiable")
        grad_absmax = {"camera_opt": float(g_cam.abs().max()),
                       "delta_rot": float(g_rot.abs().max())}
        del grads
        sync()
        reset_launches()
        times, losses = [], []
        for cam, row in zip(cams, CAMOPT_ROWS):
            t = time.perf_counter()
            with warnings.catch_warnings():
                warnings.simplefilter("error", RuntimeWarning)
                state, metrics = sts.scene_train_step(
                    state, tracks, cam, batch, mcfg, rcfg, subset_accs=False,
                    camera_index=row)
            sync()
            times.append((time.perf_counter() - t) * 1e3)
            losses.append(float(metrics["loss"]))
            if not math.isfinite(losses[-1]):
                raise AssertionError(f"camopt_path {mode}: loss "
                                     f"{losses[-1]}")
            if int(metrics["num_pairs"]) > rcfg.max_pairs:
                raise AssertionError(f"camopt_path {mode}: capacity "
                                     f"overflow")
        launches = read_launches()
        if dev == "cuda":
            check_launches(f"camopt_path {mode}", launches, {
                "flat_scan": 9, "expand_ragged": 6, "pack_feat_cols": 3,
                "composite_fwd": 3, "composite_bwd": 3, "rank_rowsum": 3,
                "row_trim": 3, "sh_colors": 6, "sh_colors[bwd]": 3,
                "project": 6, "project[bwd]": 3})
        cam_opt = state.opt["camera_opt"]
        acc = cam_opt.acc
        stepped = torch.zeros(8, dtype=torch.bool)
        stepped[list(CAMOPT_ROWS)] = True
        row_nonzero = (acc != 0).all(dim=1).cpu()
        if (cam_opt.calls != 3 or cam_opt.count != 0
                or not bool(torch.isfinite(acc).all())
                or not bool(row_nonzero[stepped].all())
                or bool(acc.cpu()[~stepped].any())
                or bool(state.camera_opt.any())):
            raise AssertionError(f"camopt_path {mode}: calls "
                                 f"{cam_opt.calls}, count {cam_opt.count}, "
                                 f"accumulator rows {row_nonzero.tolist()}")
        modes[mode] = dict(bbox_mode=bbox_mode,
                           bbox_differentiable=bbox_diff, ms_per_step=times,
                           ms_per_step_median=float(np.median(times)),
                           loss_per_step=losses, grad_absmax=grad_absmax,
                           accumulator_absmax=float(acc.abs().max()),
                           calls=cam_opt.calls, launches=launches)
        del state
    split = (_camopt_split(store_np, tracks, cfg, rcfg, cams[0], batch, dev)
             if dev == "cuda" else None)
    emit("camopt_path", size=[size.width, size.height], rows=CAMOPT_ROWS,
         num_cameras=8, first_step=TRAIN_STEP0,
         train_path_ms_per_step_median=train_ms, modes=modes,
         split=split, reference_100_calls=ref)
    return launches


def _camopt_split(store_np, tracks, cfg, rcfg, cam, batch, dev,
                  rounds: int = 3):
    """Where the camera optimizer's step time goes: one step of each
    variant (camera mode / bbox mode / bbox_differentiable) from its own
    fresh state, `rounds` rounds in turns on the host's clock, then one
    step of each under torch.profiler: the host's operator calls, the
    device's busy ms and the pairs of a step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    variants = {"off": ("off", "simple", False),
                "SO3xR3": ("SO3xR3", "simple", False),
                "SE3": ("SE3", "simple", False),
                "SO3xR3+bbox SE3": ("SO3xR3", "SE3", True),
                "SE3+bbox SE3": ("SE3", "SE3", True)}
    runs = {}
    for name, (mode, bbox_mode, diff) in variants.items():
        vcfg = dataclasses.replace(cfg, camera_opt_mode=mode, num_cameras=8,
                                   bbox_mode=bbox_mode,
                                   bbox_differentiable=diff)
        state = _camopt_state(store_np, vcfg, TRAIN_STEP0, 8, dev, 0,
                              rot_seed=1 if diff else None)
        if mode == "off":
            state = dataclasses.replace(state, camera_opt=None, opt={
                k: v for k, v in state.opt.items() if k != "camera_opt"})
        runs[name] = (vcfg, state)

    def step(name):
        vcfg, state = runs[name]
        return sts.scene_train_step(state, tracks, cam, batch, vcfg, rcfg,
                                    subset_accs=False, camera_index=3)

    ms = {name: [] for name in variants}
    for name in variants:                  # warm-up
        step(name)
    for _ in range(rounds):
        for name in variants:
            torch.cuda.synchronize()
            t = time.perf_counter()
            step(name)
            torch.cuda.synchronize()
            ms[name].append((time.perf_counter() - t) * 1e3)
    out = {}
    for name in variants:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, metrics = step(name)
            torch.cuda.synchronize()
        calls = busy = 0
        for e in prof.key_averages():
            if e.key.startswith("aten::"):
                calls += e.count
            if e.device_type == DeviceType.CUDA:   # the kernels themselves
                us = getattr(e, "self_device_time_total", None)
                busy += (us if us is not None
                         else getattr(e, "self_cuda_time_total", 0.0))
        out[name] = dict(ms=ms[name], aten_calls=calls,
                         device_busy_ms=busy / 1e3,
                         num_pairs=int(metrics["num_pairs"]))
    return out


# ---------------------------------------------------------------------------
# The live viewer.
# ---------------------------------------------------------------------------

def _http(port: int, path: str, timeout: float = 300.0):
    """GET http://127.0.0.1:port/path -> (body, seconds)."""
    t = time.perf_counter()
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=timeout) as r:
        body = r.read()
    return body, time.perf_counter() - t


def _frame_path(c2w, t: float, res: str) -> str:
    return "/frame?" + urllib.parse.urlencode({
        "c2w": ",".join(repr(float(v)) for v in np.asarray(c2w).reshape(-1)),
        "time": repr(float(t)), "res": res})


def _serve_until(server, render_fn, client) -> None:
    """Run `client` on a thread while this thread services the server's
    requests (as serve_forever does), until the client is done; its
    exception, if any, is raised here."""
    err = []

    def run():
        try:
            client()
        except BaseException as e:     # handed to the servicing thread
            err.append(e)

    th = threading.Thread(target=run)
    th.start()
    while th.is_alive():
        if not server.service(render_fn):
            time.sleep(0.005)
    th.join()
    if err:
        raise err[0]


def phase_viewer(run: Path, dev="cuda"):
    """The viewer on cli_path's run directory. Standalone: eval_setup +
    attach_viewer(port=0) on 127.0.0.1, a client thread sending /, /init,
    /state and 8 /frame requests (4 low, 4 med, poses along the train
    cameras), this thread servicing them; every response a JPEG of the
    ladder's size, the renders bit for bit a direct forward_scene of the
    same camera, the counts set to 0 before the requests and read after,
    one frame's torch.profiler trace under chiprun_out/ holding kernel
    D's launches. Live: a Trainer on the same clip with viewer_port=0 and
    camera_opt_mode="SE3" runs 20 steps while a client sends 4 requests,
    each answered between two steps."""
    Image = pillow_image()
    cuda = dev == "cuda"
    t0 = time.perf_counter()
    trainer = eval_setup(run, device=dev)
    server = trainer_mod.attach_viewer(trainer, 0, host="127.0.0.1")
    server.update_stats(step=int(trainer.state.step), mode="checkpoint")
    setup_s = time.perf_counter() - t0
    scene = trainer.scene
    poses = [(scene.c2w[int(i)], float(scene.times[int(i)]))
             for i in scene.train_indices[:4]]
    requests = [(c2w, t, res) for res in ("low", "med") for c2w, t in poses]
    renders, device_ms = [], []

    def render_fn(c2w, t, w, h):
        start = torch.cuda.Event(enable_timing=True) if cuda else None
        end = torch.cuda.Event(enable_timing=True) if cuda else None
        if cuda:
            start.record()
        rgb = trainer._viewer_render(c2w, t, w, h)
        if cuda:
            end.record()
            end.synchronize()
            device_ms.append(start.elapsed_time(end))
        renders.append(((c2w, t, w, h), rgb))
        return rgb

    got = {}

    def client():
        got["page"] = _http(server.port, "/")[0]
        got["init"] = json.loads(_http(server.port, "/init")[0])
        got["state"] = json.loads(_http(server.port, "/state")[0])
        got["frames"] = [_http(server.port, _frame_path(c2w, t, res))
                         for c2w, t, res in requests]

    try:
        trainer._viewer_render(*requests[0][:2], *RES_LADDER["low"])  # warm
        if cuda:
            torch.cuda.synchronize()
        reset_launches()
        _serve_until(server, render_fn, client)
        launches = read_launches()
        state = json.loads(_http(server.port, "/state")[0])
    finally:
        server.close()
    fails = []
    if "render_error" in state:
        fails.append(f"render_error {state['render_error']}")
    if b"viewer" not in got["page"] or len(got["init"]["c2w"]) != 12:
        fails.append("the page or /init")
    for (c2w, t, res), (jpeg, _) in zip(requests, got["frames"]):
        img = np.asarray(Image.open(io.BytesIO(jpeg)))
        if img.shape != (RES_LADDER[res][1], RES_LADDER[res][0], 3):
            fails.append(f"frame {res} decodes to {img.shape}")
    if len(renders) != len(requests):
        fails.append(f"{len(renders)} renders for {len(requests)} requests")
    n = len(requests)
    if cuda:
        for name, per in (("flat_scan", 9), ("expand_ragged", 6),
                          ("pack_feat_cols", 3), ("composite_fwd", 3),
                          ("row_trim", 3), ("sh_colors", 1),
                          ("project", 3)):
            if launches[name] != per * n:
                fails.append(f"{name} launched {launches[name]} times for "
                             f"{n} frames of 3 renders")
    direct_equal = []
    for (c2w, t, w, h), rgb in (renders[0], renders[n // 2]):
        with torch.no_grad():
            out, _, _ = forward_scene(
                trainer.state.store, trainer.tracks,
                trainer.viewer_camera(c2w, t, w, h), trainer.state.step,
                trainer.config, trainer.render_config, training=False)
        want = (torch.clamp(out["rgb"], 0.0, 1.0) * 255).to(
            torch.uint8).cpu().numpy()
        direct_equal.append(bool(np.array_equal(rgb, want)))
    if not all(direct_equal):
        fails.append("a viewer frame differs from a direct forward_scene")

    # One viewer frame under torch.profiler, its Chrome trace kept.
    trace_dir = REPO / "chiprun_out" / "viewer_trace"
    with profiling.trace(trace_dir) as prof:
        trainer._viewer_render(*requests[0][:2], *RES_LADDER["low"])
    events = json.loads((trace_dir / "trace.json").read_text())["traceEvents"]
    d_events = [e for e in events if e.get("cat") == "kernel"
                and "composite_fwd_kernel" in e.get("name", "")]
    kernel_events = sum(1 for e in events if e.get("cat") == "kernel")
    if cuda and len(d_events) != 3:
        fails.append(f"the trace holds {len(d_events)} launches of kernel D "
                     f"({kernel_events} kernel events), expected 3")
    del prof, trainer
    standalone = dict(
        setup_s=setup_s, step=state.get("step"), mode=state.get("mode"),
        requests=[f"{res} {RES_LADDER[res][0]}x{RES_LADDER[res][1]}"
                  for _, _, res in requests],
        client_ms=[1e3 * s for _, s in got["frames"]],
        render_device_ms=device_ms, launches=launches,
        direct_forward_scene_equal=direct_equal,
        trace=_rel(trace_dir / "trace.json"),
        trace_kernel_events=kernel_events,
        trace_kernel_d_us=[e.get("dur") for e in d_events])

    # Live: the viewer inside a training run.
    data, model, tcfg, dm = load_run_config(run)
    model = dataclasses.replace(model, camera_opt_mode="SE3")
    live_steps = 20
    with tempfile.TemporaryDirectory(prefix="sgnt_live_") as out_dir:
        tcfg = dataclasses.replace(
            tcfg, output_dir=Path(out_dir), viewer_port=0, resume=False,
            max_num_iterations=live_steps, steps_per_save=10 ** 6,
            steps_per_eval_image=10 ** 6, steps_per_eval_all_images=10 ** 6)
        live = trainer_mod.Trainer(data, model, tcfg, dm, device=dev)
        served, answers = [], []
        render = live._viewer_render

        def recording(c2w, t, w, h):
            served.append(live.state.step)
            return render(c2w, t, w, h)

        live._viewer_render = recording
        i0 = int(live.scene.train_indices[0])

        def live_client():
            for k in range(4):
                jpeg, s = _http(live.viewer.port, _frame_path(
                    live.scene.c2w[i0], float(live.scene.times[i0]),
                    "low"))
                st = json.loads(_http(live.viewer.port, "/state")[0])
                answers.append((len(jpeg), s, st))

        th = threading.Thread(target=live_client)
        losses = []
        write = live.writer.write

        def keep(step, m, prefix="train"):
            if prefix == "train" and "loss" in m:
                losses.append(m["loss"])
            return write(step, m, prefix=prefix)

        live.writer.write = keep
        try:
            th.start()
            t = time.perf_counter()
            live.train()
            train_s = time.perf_counter() - t
            th.join(timeout=120)
        finally:
            live.viewer.close()
        if th.is_alive():
            fails.append("live: the client did not finish")
        cam = live.state.opt["camera_opt"]
        live_res = dict(
            steps=live.state.step, train_s=train_s, served_at_step=served,
            client_ms=[1e3 * s for _, s, _ in answers],
            state_steps=[st.get("step") for _, _, st in answers],
            losses=losses, camera_calls=cam.calls,
            camera_accumulator_absmax=float(cam.acc.abs().max()))
        if len(answers) != 4 or len(served) != 4:
            fails.append(f"live: {len(answers)} answers, {len(served)} "
                         f"renders for 4 requests")
        if len(set(served)) != len(served) or not all(
                1 <= s <= live_steps for s in served):
            fails.append(f"live: renders at steps {served} (one a step, "
                         f"between steps)")
        for _, _, st in answers:
            if "render_error" in st or st.get("step") not in (0.0, 10.0):
                fails.append(f"live: /state {st}")
        if live.state.step != live_steps or not np.isfinite(losses).all():
            fails.append(f"live: step {live.state.step}, losses {losses}")
        if cam.calls != live_steps or not float(cam.acc.abs().max()) > 0:
            fails.append(f"live: camera calls {cam.calls}")
        del live
    emit("viewer_path", standalone=standalone, live=live_res,
         failures=fails)
    if fails:
        raise AssertionError("viewer_path: " + "; ".join(fails))
    return launches



# ---------------------------------------------------------------------------
# bf16_path and mesh_path.
# ---------------------------------------------------------------------------

# The kernels every fused render launches (A-D, the row trim, I, the SH
# colour, J, and the projection, L), and with those a fused training
# step's (E, F).
RENDER_KERNELS = ("flat_scan", "expand_ragged", "pack_feat_cols",
                  "composite_fwd", "row_trim", "sh_colors", "project")
FUSED_KERNELS = RENDER_KERNELS + ("composite_bwd", "rank_rowsum")


def check_fused_kernels(phase: str, launches: dict) -> None:
    missing = [k for k in FUSED_KERNELS if launches.get(k, 0) <= 0]
    if missing:
        raise AssertionError(f"{phase}: {missing} never launched")


def phase_bf16(seed: int, tracks, cfg, rcfg, size: Size = FLAGSHIP):
    """RenderConfig(precision="bf16") at full width: the f32 and the bf16
    frame of one camera (rgb differences reported beside the JAX
    package's "sub-1e-2"), then, counted, 4 bf16 eval frames, 3 bf16
    training steps from TRAIN_STEP0 and a refine pass; the f32 step beside
    them (same state, same jitter). First the small scene in bf16 on the
    card against the CPU (render, then reference_train's step and refine
    at its tolerances). Returns the counts."""
    phase_reference(seed, precision="bf16", phase="reference_bf16")
    phase_reference_train(seed, precision="bf16",
                          phase="reference_train_bf16")
    store_np, _ = make_scene(seed, size.bg, size.objects, size.per_object,
                             size.env_res)
    store = store_from_numpy(store_np, cfg, device="cuda")
    cams = cameras(size.frames, size.width, size.height, size.focal, "cuda")
    r16 = dataclasses.replace(rcfg, precision="bf16")

    def frame(cam, rc):
        with warnings.catch_warnings():
            warnings.simplefilter("error", RuntimeWarning)
            return forward_scene(store, tracks, cam, 0, cfg, rc,
                                 eval_extras=True)[0]

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t) * 1e3

    frame(cams[0], r16)                    # warm-up
    f32, f32_ms = timed(lambda: frame(cams[0], rcfg))
    state = train_state_from_numpy(train_arrays(store_np, TRAIN_STEP0), cfg,
                                   device="cuda", seed=seed)
    del store_np
    batch = make_batch(seed, size.width, size.height, "cuda")
    jitter = draw_pixel_jitter(cams[0], torch.Generator(
        device="cuda").manual_seed(seed))

    def step(st, rc):
        with warnings.catch_warnings():
            warnings.simplefilter("error", RuntimeWarning)
            return sts.scene_train_step(st, tracks, cams[0], batch, cfg, rc,
                                        subset_accs=False, jitter=jitter)

    (_, m32), f32_step_ms = timed(lambda: step(state, rcfg))
    reset_launches()
    frames, frame_ms = [], []
    for cam in cams:
        out, ms = timed(lambda: frame(cam, r16))
        frames.append(out)
        frame_ms.append(ms)
    st, losses, step_ms = state, [], []
    for _ in range(3):
        (st, m), ms = timed(lambda: step(st, r16))
        losses.append(float(m["loss"]))
        step_ms.append(ms)
        if (int(m["num_pairs"]) > rcfg.max_pairs
                or int(m["num_rowruns"]) > rcfg.rowrun_capacity):
            raise AssertionError("bf16: render capacity overflow")
    (refined, info), refine_ms = timed(lambda: sts.scene_refine_step(
        st, cfg, NUM_TRAIN_DATA, max(size.width, size.height)))
    launches = read_launches()
    check_fused_kernels("bf16_path", launches)
    for out in frames:
        for k, v in out.items():
            if not bool(torch.isfinite(v).all()):
                raise AssertionError(f"bf16: head {k} is not finite")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"bf16: losses {losses}")
    d_rgb = (frames[0]["rgb"] - f32["rgb"]).abs()
    d_acc = (frames[0]["accumulation"] - f32["accumulation"]).abs()
    info = {k: int(v) for k, v in info.items()}
    if info["bg_refine_splits_count"] + info["bg_refine_dups_count"] <= 0:
        raise AssertionError("bf16: the refine pass densified nothing")
    emit("bf16_path", size=[size.width, size.height],
         rgb_vs_f32={"max": float(d_rgb.max()), "mean": float(d_rgb.mean())},
         accumulation_vs_f32_max=float(d_acc.max()),
         jax_docstring_rgb_bound="sub-1e-2 (street_gaussians_ns_tpu/ops/"
         "tiles.py:205-214; reported, not a limit)",
         ms_per_frame_bf16=frame_ms, ms_frame_f32=f32_ms,
         ms_per_step_bf16=step_ms, ms_step_f32=f32_step_ms,
         loss_per_step_bf16=losses, loss_step_f32=float(m32["loss"]),
         refine_ms=refine_ms, refine=info, launches=launches)
    return launches


# mesh_path (b)'s (1, 2) limits against the single device. The layer
# merge's lost done state put the full-width frame 8.27e-4 (rgb) and
# 9.14e-4 (accumulation) off, the loss 8.0e-6 off and the first step's
# gradients up to 0.133 of a group's largest off (the sky's: the merge
# composites past the point where the single device ends a pixel, so the
# sky's weight T differs; the JAX package's (1, 2) step is 0.19 off its
# own single-device step on a saturating scene, which
# tests/test_torch_parallel_model.py holds the port to; PERF.md section 6):
# a frame 1e-2 off, a loss 5e-5 off or a gradient 0.5 of its group's
# largest off (one counted twice, or not at all, is 1.0 off) is a fault of
# the merge, the windows or the collectives, not that deviation.
FRAME_GROSS = 1e-2
MESH12_LOSS_TOL = 5e-5
MESH12_GRAD_GROSS = 0.5


def mesh_build(seed: int, data: int = 2, size: Size = FLAGSHIP) -> dict:
    """The inputs of mesh_path's runs (the job's "build", made on every
    rank alike): the flagship train state at TRAIN_STEP0 with fresh Adam
    moments, `data` cameras and targets, one sky jitter per row."""
    store_np, tracks_np = make_scene(seed, size.bg, size.objects,
                                     size.per_object, size.env_res)
    cams = cameras(data, size.width, size.height, size.focal, "cpu")
    batches = [make_batch(seed + d, size.width, size.height, "cpu")
               for d in range(data)]
    g = torch.Generator().manual_seed(seed + 11)
    jitters = torch.stack([draw_pixel_jitter(c, g) for c in cams])
    return {"state": train_arrays(store_np, TRAIN_STEP0), "tracks": tracks_np,
            "cam_b": {k: torch.stack([getattr(c, k) for c in cams]).numpy()
                      for k in ("fx", "fy", "cx", "cy", "c2w", "time")},
            "batch_b": {k: torch.stack([b[k] for b in batches]).numpy()
                        for k in ("image", "semantic")},
            "jitters": jitters.numpy()[None], "width": size.width,
            "height": size.height, "step": TRAIN_STEP0}


def _single_reference(seed: int, cfg, runs, size: Size = FLAGSHIP):
    """The single-device loss, gradients (inactive rows zeroed), full frame
    and pair count of each (data row, render config) of `runs` on
    mesh_build's inputs (two rows), on the card."""
    built = mesh_build(seed, 2, size)
    tracks = tracks_from_numpy(built["tracks"], device="cuda")
    out = []
    for d, rcfg in runs:
        state = train_state_from_numpy(built["state"], cfg, device="cuda",
                                       seed=seed)
        cam = Camera(**{k: torch.from_numpy(np.asarray(v[d])).cuda()
                        for k, v in built["cam_b"].items()},
                     width=size.width, height=size.height)
        batch = {k: torch.from_numpy(v[d]).cuda()
                 for k, v in built["batch_b"].items()}
        jit = torch.from_numpy(built["jitters"][0, d]).cuda()
        total, _, outputs, rout, grads = sts.scene_loss_and_grads(
            state, tracks, cam, batch, cfg, rcfg, subset_accs=False,
            jitter=jit)
        g = sts.mask_inactive_grads(grads["gauss"], state.store)
        flat = {f"{n}/{k}": v.cpu() for n, gk in g.items()
                for k, v in gk.items()}
        flat["env_map"] = grads["env_map"].cpu()
        out.append({"loss": float(total), "grads": flat,
                    "rgb": outputs["rgb"].cpu(),
                    "accumulation": outputs["accumulation"].cpu(),
                    "num_pairs": int(rout.bins.num_pairs)})
    return out


def _mu_grads(arrays: dict) -> dict:
    """The gradients of a first Adam step from zero moments: mu / 0.1."""
    out = {}
    for name in sts.GAUSSIAN_GROUPS:
        for k in ("bg", "obj"):
            out[f"{name}/{k}"] = torch.from_numpy(
                arrays[f"opt/{name}/mu/{k}"]) / 0.1
    out["env_map"] = torch.from_numpy(arrays["opt/sky_sphere/mu"]) / 0.1
    return out


def _grad_errs(got: dict, want: dict, tol, phase: str) -> dict:
    """Each group's max |got - want| over its largest |want|; raises above
    tol (None: report only)."""
    errs = {}
    for k, w in want.items():
        top = float(w.abs().max())
        err = float((got[k] - w).abs().max())
        if tol is not None and top > 0 and err > tol * top:
            raise AssertionError(f"{phase}: gradient {k} differs by {err} "
                                 f"(largest |g| {top})")
        errs[k] = err / top if top > 0 else err
    return errs


def phase_mesh_unit(seed: int, cfg, rcfg, size: Size = FLAGSHIP):
    """mesh_path (a): a (1, 1) mesh on NCCL at world size 1, in this
    process: 3 sharded steps and a sharded refine pass against
    scene_train_step / scene_refine_step from the same state, jitter and
    generator. The first step's gradients (its Adam moments) at 1e-4 of
    each group's largest, the losses at 2e-5, the refine counts exact;
    whether the final states are equal bit for bit is printed."""
    from street_gaussians_ns_tpu_torch.parallel import mesh as pmesh
    from street_gaussians_ns_tpu_torch.parallel import trainer as ptrainer
    from street_gaussians_ns_tpu_torch.parallel.sharded import (
        make_sharded_train_step)
    from street_gaussians_ns_tpu_torch.engine.checkpoints import (
        state_to_numpy)

    pmesh.multihost_init(backend="nccl")
    mesh = pmesh.make_mesh(1, 1, device="cuda")
    built = mesh_build(seed, 1, size)
    tracks = tracks_from_numpy(built["tracks"], device="cuda")
    cam_b = {k: torch.from_numpy(v).cuda() for k, v in built["cam_b"].items()}
    batch_b = {k: torch.from_numpy(v).cuda()
               for k, v in built["batch_b"].items()}
    cam = Camera(**{k: v[0] for k, v in cam_b.items()}, width=size.width,
                 height=size.height)
    batch = {k: v[0] for k, v in batch_b.items()}
    jit = torch.from_numpy(built["jitters"][0]).cuda()
    runs = {}
    reset_launches()
    for kind in ("single", "mesh"):
        state = train_state_from_numpy(built["state"], cfg, device="cuda",
                                       seed=seed)
        fn = (make_sharded_train_step(mesh, cfg, rcfg, size.width,
                                      size.height,
                                      state.store.background.capacity,
                                      subset_accs=False)
              if kind == "mesh" else None)
        losses, first, ms = [], None, []
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            if kind == "mesh":
                state, m = fn(state, tracks, cam_b, batch_b, jitters=jit)
            else:
                state, m = sts.scene_train_step(state, tracks, cam, batch,
                                                cfg, rcfg, subset_accs=False,
                                                jitter=jit[0])
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
            losses.append(float(m["loss"]))
            if first is None:
                first = _mu_grads(state_to_numpy(state))
        if kind == "mesh":
            state, info = ptrainer.make_sharded_refine_step(
                mesh, cfg, NUM_TRAIN_DATA)(state, max(size.width,
                                                      size.height))
        else:
            state, info = sts.scene_refine_step(state, cfg, NUM_TRAIN_DATA,
                                                max(size.width, size.height))
        runs[kind] = dict(losses=losses, grads=first, ms=ms,
                          info={k: int(v) for k, v in info.items()},
                          state=state_to_numpy(state))
        if kind == "single":
            launches_single = read_launches()
            reset_launches()
    launches = read_launches()
    check_fused_kernels("mesh_path[(1,1)]", launches)
    a, b = runs["mesh"], runs["single"]
    loss_err = max(abs(x - y) for x, y in zip(a["losses"], b["losses"]))
    if loss_err > 2e-5:
        raise AssertionError(f"mesh (1,1): losses {a['losses']} vs "
                             f"{b['losses']}")
    errs = _grad_errs(a["grads"], b["grads"], 1e-4, "mesh (1,1)")
    if a["info"] != b["info"]:
        raise AssertionError(f"mesh (1,1): refine counts {a['info']} vs "
                             f"{b['info']}")
    bit_equal = all(np.array_equal(v, b["state"][k])
                    for k, v in a["state"].items())
    diff = {k: float(np.abs(v.astype(np.float64)
                            - b["state"][k].astype(np.float64)).max())
            for k, v in a["state"].items()
            if v.dtype.kind == "f" and not np.array_equal(v, b["state"][k])}
    emit("mesh_path_unit", mesh=[1, 1], backend="nccl", world=1,
         size=[size.width, size.height], losses=a["losses"],
         losses_single=b["losses"], loss_max_err=loss_err,
         grad_max_err_of_top=max(errs.values()), refine=a["info"],
         bit_equal_to_single_device=bit_equal,
         leaves_that_differ_max_abs=diff, ms_per_step=a["ms"],
         ms_per_step_single=b["ms"], launches=launches,
         launches_single=launches_single)
    return launches


def phase_mesh_shared(seed: int, cfg, rcfg, workdir: Path,
                      size: Size = FLAGSHIP):
    """mesh_path (b): two processes sharing the card through an
    explicitly named gloo backend, at full width, each building the
    flagship train state (mesh_build): the (2, 1) mesh's loss against the
    mean of the two single-device losses (2e-5) and its gradients (its
    first Adam moments) against their mean (1e-4 of each group's largest);
    the (1, 2) mesh in float32 and in bf16, each against the single
    device at its precision: the merged frame (rgb and accumulation; the
    layer merge's lost done state is reported against 2e-3, the finding,
    and fails above FRAME_GROSS), the loss (MESH12_LOSS_TOL), the first
    step's gradients (MESH12_GRAD_GROSS), the per-device pair counts
    (their sum exactly the single device's, max / mean <= 1.1). These
    measure correctness: two ranks on one card are not a scaling
    number."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    from torch_ranks import run_ranks

    def run(data, model, precision):
        return dict(data=data, model=model, steps=1, frames=True,
                    render_config=dataclasses.replace(rcfg,
                                                      precision=precision))

    mus = [f"opt/{n}/mu" for n in sts.GAUSSIAN_GROUPS] + [
        "opt/sky_sphere/mu"]
    t = time.perf_counter()
    ranks = run_ranks(dict(
        build=("chip_smoke", "mesh_build", {"seed": seed, "data": 2}),
        config=cfg, backend="gloo", device="cuda", subset_accs=False,
        seed=seed, state_keys=mus,
        runs=[run(2, 1, "f32"), run(1, 2, "f32"), run(1, 2, "bf16")]),
        2, workdir, timeout=900)
    wall_s = time.perf_counter() - t
    rcfg16 = dataclasses.replace(rcfg, precision="bf16")
    ref = _single_reference(seed, cfg, [(0, rcfg), (1, rcfg), (0, rcfg16)],
                            size)
    single = {"f32": ref[0], "bf16": ref[2]}
    (r21, r12, r12b) = ranks[0]["runs"]
    # (2, 1): the mean over the rows.
    loss = r21["metrics"][0]["loss"]
    loss_ref = (ref[0]["loss"] + ref[1]["loss"]) / 2
    if abs(loss - loss_ref) > 2e-5:
        raise AssertionError(f"mesh (2,1): loss {loss} vs {loss_ref}")
    g_ref = {k: (ref[0]["grads"][k] + ref[1]["grads"][k]) / 2
             for k in ref[0]["grads"]}
    errs21 = _grad_errs(_mu_grads(r21["state"]), g_ref, 1e-4, "mesh (2,1)")
    # (1, 2): row 0's merged frame, loss, gradients and pairs against the
    # single device's at the same precision.
    frame_err, loss12, grads12 = {}, {}, {}
    for name, r in (("f32", r12), ("bf16", r12b)):
        m, want = r["metrics"][0], single[name]
        frame_err[name] = {
            k: float(np.abs(m[f"frame_{k}"] - want[k].numpy()).max())
            for k in ("rgb", "accumulation")}
        loss12[name] = {"mesh": m["loss"], "single": want["loss"],
                        "abs_err": abs(m["loss"] - want["loss"])}
        grads12[name] = _grad_errs(_mu_grads(r["state"]), want["grads"],
                                   MESH12_GRAD_GROSS, f"mesh (1,2) {name}")
    over = {k: v for k, v in frame_err["f32"].items() if v > 2e-3}
    local = {name: [rk["runs"][i]["metrics"][0]["num_pairs_local"]
                    for rk in ranks]
             for i, name in ((1, "f32"), (2, "bf16"))}
    balance = {k: max(v) / (sum(v) / len(v)) for k, v in local.items()}
    for name in ("f32", "bf16"):
        gross = {k: v for k, v in frame_err[name].items() if v > FRAME_GROSS}
        if gross:
            raise AssertionError(f"mesh (1,2) {name}: the merged frame is "
                                 f"off the single device's by {gross}")
        if loss12[name]["abs_err"] > MESH12_LOSS_TOL:
            raise AssertionError(f"mesh (1,2) {name}: loss {loss12[name]}")
        if int(round(sum(local[name]))) != single[name]["num_pairs"]:
            raise AssertionError(
                f"mesh (1,2) {name}: pairs per device {local[name]} do not "
                f"sum to the single device's {single[name]['num_pairs']}")
        if balance[name] > 1.1:
            raise AssertionError(f"mesh (1,2) {name}: pair balance "
                                 f"max / mean {balance[name]}")
    launches = {}
    for rk in ranks:
        for k, v in rk["launches"].items():
            launches[k] = launches.get(k, 0) + v
    check_fused_kernels("mesh_path[gloo]", launches)
    emit("mesh_path_shared", backend="gloo", world=2,
         card_shared_by_ranks=True, size=[size.width, size.height],
         mesh_2x1={"loss": loss, "loss_single_mean": loss_ref,
                   "grad_max_err_of_top": max(errs21.values())},
         mesh_1x2_frame_max_abs=frame_err, frame_limit=2e-3,
         frame_over_limit=over, frame_fails_above=FRAME_GROSS,
         mesh_1x2_loss=loss12, loss_limit=MESH12_LOSS_TOL,
         mesh_1x2_grad_err_of_top=grads12, grad_limit=MESH12_GRAD_GROSS,
         pairs_per_device=local,
         pairs_single_device={k: v["num_pairs"] for k, v in single.items()},
         pair_balance_max_over_mean=balance,
         seconds_per_step={n: [rk["runs"][i]["seconds"][0] for rk in ranks]
                           for i, n in enumerate(("2x1", "1x2", "1x2_bf16"))},
         wall_seconds=wall_s, launches=launches,
         note="two ranks share one card through gloo: correctness, not "
              "scaling")
    if over:
        print(f"mesh_path finding: the (1,2) frame exceeds 2e-3: {over}",
              file=sys.stderr, flush=True)
    return launches


def phase_mesh_cli(run_dir: Path, clip_root: Path, steps: int = 20):
    """mesh_path (c): sgnt-torch-train --mesh-data 1 --mesh-model 1 (the
    sharded trainer on NCCL at world size 1) on cli_path's clip, 20 steps;
    its checkpoint restored by the single-device eval_setup."""
    reset_launches()
    t = time.perf_counter()
    trainer = train_cli.main([
        "--data", str(clip_root), "--trainer.output-dir", str(run_dir),
        "--trainer.max-num-iterations", str(steps),
        "--trainer.steps-per-save", str(steps),
        "--trainer.steps-per-eval-all-images", str(10 * steps),
        "--mesh-data", "1", "--mesh-model", "1"])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t
    launches = read_launches()
    check_fused_kernels("mesh_path[cli]", launches)
    ckpt = run_dir / "checkpoints" / f"step-{steps:09d}.ckpt.npz"
    if not ckpt.exists():
        raise AssertionError(f"mesh cli: no checkpoint {ckpt}")
    restored = eval_setup(run_dir, device="cuda")
    if restored.state.step != steps:
        raise AssertionError(f"mesh cli: restored step {restored.state.step}")
    with np.load(ckpt) as data:
        means = data["store/background/params/means"]
    same = np.array_equal(
        restored.state.store.background.params.means.cpu().numpy(), means)
    if not same:
        raise AssertionError("mesh cli: the restored means differ")
    rows = [json.loads(r) for r in
            (run_dir / "metrics.jsonl").read_text().splitlines()]
    losses = [r["train/loss"] for r in rows if "train/loss" in r]
    if not losses or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"mesh cli: losses {losses}")
    emit("mesh_path_cli", mesh=[1, 1], backend="nccl", steps=steps,
         train_seconds=train_s, losses=losses,
         restored_by="engine.setup.eval_setup (single device)",
         gaussians=int(restored.state.store.background.active.sum()),
         launches=launches)
    del trainer, restored
    return launches


VIEWER_STEPS = 20              # mesh_path_viewer's steps a run


def phase_mesh_viewer(clip_root: Path, workdir: Path, card: str,
                      steps: int = VIEWER_STEPS, dev="cuda",
                      train_flags: tuple = ()):
    """mesh_path_viewer: the live viewer of a multi-process run at full
    width. Two processes share the card through gloo named explicitly
    (tests/torch_ranks.run_viewer_ranks), each a ShardedTrainer(
    viewer_port=0) on cli_path's clip with the train CLI's defaults as a
    (1, 2) mesh, `steps` steps, while a client in this process asks for 4
    frames at 480x270 and 1 at 960x540 (each answered at a step of its
    own: rank 0 waits for the next request before each hand-off) and
    parks one more during the final step. Then `steps` steps with the
    viewer on and no client, and `steps` with it off, in the same
    processes. Checks: JPEGs of the ladder's sizes; only rank 0 started
    a server; every answered frame's uint8 rgb equal, bit for bit, to the
    single-device Trainer._viewer_render of the same state (gather_state
    at the same hand-off, which the harness makes every rank join); A-D
    and I counted in the frames, A-F and I in the steps; no render_error,
    no capacity overflow; both ranks exit 0 after the last-step request.
    Prints each request's
    latency on the client's clock, the gather's and the render's ms per
    frame, steps/s with the viewer on against off, the on run's per-step
    hand-off ms and each rank's peak memory, beside `card`. Correctness
    numbers of two ranks on one card, not scaling numbers. dev="cpu" with
    small `train_flags` rehearses it on the plain versions (no launch
    counts there)."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    from torch_ranks import run_viewer_ranks

    from street_gaussians_ns_tpu_torch.data.dataparser import (
        DataParserConfig, parse_scene)
    from street_gaussians_ns_tpu_torch.data.datamanager import (
        DataManagerConfig)
    from street_gaussians_ns_tpu_torch.utils.cli import dataclass_from_args

    args = train_cli.build_parser().parse_args([
        "--data", str(clip_root), "--trainer.output-dir",
        str(workdir / "run"), "--trainer.viewer-port", "0",
        "--trainer.steps-per-eval-image", str(10 ** 6),
        "--trainer.steps-per-eval-all-images", str(10 ** 6),
        *train_flags])
    configs = (dataclass_from_args(DataParserConfig, args),
               dataclass_from_args(SceneGraphConfig, args, "model."),
               dataclass_from_args(trainer_mod.TrainerConfig, args,
                                   "trainer."),
               dataclass_from_args(DataManagerConfig, args, "dm."))
    scene = parse_scene(configs[0], device="cpu")
    idx = [int(i) for i in scene.train_indices]
    poses = [(np.asarray(scene.c2w[idx[k % len(idx)]], np.float32),
              float(scene.times[idx[k % len(idx)]])) for k in range(5)]
    requests = [(*poses[k], "low") for k in range(4)] + [(*poses[4], "med")]
    final = (*poses[0], "low")
    job = dict(backend="gloo", device=dev, viewer=dict(
        configs=configs, mesh=(1, 2), steps=steps, final_request=True,
        reference=True, no_save=True, timing=steps))
    t = time.perf_counter()
    ranks, got = run_viewer_ranks(job, 2, workdir / "ranks", requests,
                                  final, timeout=900)
    wall_s = time.perf_counter() - t
    r0, r1 = ranks
    Image = pillow_image()
    answers = got["answers"] + [(*got["final"], None)]
    asked = requests + [final]
    fails = []
    for (c2w, tm, res), (code, jpeg, _, state) in zip(asked, answers):
        w, h = RES_LADDER[res]
        if code != 200:
            fails.append(f"{res} request answered {code}")
            continue
        shape = np.asarray(Image.open(io.BytesIO(jpeg))).shape
        if shape != (h, w, 3):
            fails.append(f"a {res} JPEG decodes to {shape}")
        if state is not None and "render_error" in state:
            fails.append(f"render_error {state['render_error']}")
    frames = r0["frames"]
    if len(frames) != len(asked):
        fails.append(f"{len(frames)} frames for {len(asked)} requests")
    equal = [bool(np.array_equal(f["rgb8"], f["reference"]))
             for f in frames]
    if not all(equal):
        fails.append(f"frames equal to the single-device render: {equal}")
    if frames and frames[-1]["step"] != steps:
        fails.append(f"the last-step request was answered at step "
                     f"{frames[-1]['step']}")
    if r0["servers"] != [0] or r1["servers"] or r1["port"] is not None:
        fails.append(f"servers {r0['servers']} / {r1['servers']}")
    missing = [k for k in RENDER_KERNELS
               if r0["frame_launches"].get(k, 0) <= 0]
    steps_launches = {k: r0["step_launches"].get(k, 0)
                      + r1["step_launches"].get(k, 0) for k in FUSED_KERNELS}
    missing += [k for k in FUSED_KERNELS if steps_launches[k] <= 0]
    if missing and dev == "cuda":
        fails.append(f"never launched: {missing}")
    overflow = r0["overflow"] + r1["overflow"]
    if overflow:
        fails.append(f"capacity overflow: {overflow[:2]}")
    if r0["late_request"] is not None:
        fails.append("a request after the last hand-off was answered")

    def rate(rank, phase):
        step_s = [s for p, s in rank["step_s"] if p == phase]
        hand_s = [s for p, _, s in rank["handoffs"] if p == phase]
        return len(step_s) / (sum(step_s) + sum(hand_s))

    idle = {f"rank{r['rank']}": [1e3 * s for p, served, s in r["handoffs"]
                                 if p == "on" and not served]
            for r in ranks}
    emit("mesh_path_viewer", card=card, mesh=[1, 2], backend="gloo",
         world=2, card_shared_by_ranks=True, clip=str(clip_root.name),
         size=[int(scene.width[0]), int(scene.height[0])], steps=steps,
         requests=[f"{res} {RES_LADDER[res][0]}x{RES_LADDER[res][1]}"
                   for _, _, res in asked],
         client_ms=[1e3 * a[2] for a in answers],
         answered_at_steps=[f["step"] for f in frames],
         gather_ms=r0["gather_ms"], render_ms=r0["render_ms"],
         gather_bytes=r0["gather_bytes"],
         frames_equal_single_device=equal,
         steps_per_s={"viewer_on": [rate(r, "on") for r in ranks],
                      "viewer_off": [rate(r, "off") for r in ranks],
                      "client_run": [rate(r, "client") for r in ranks]},
         handoff_ms_on_run=idle,
         peak_memory=[r.get("peak_memory") for r in ranks],
         late_request_s=r0["late_request_s"], wall_seconds=wall_s,
         frame_launches=r0["frame_launches"], step_launches=steps_launches,
         failures=fails,
         note="two ranks share one card through gloo: correctness, not "
              "scaling")
    if fails:
        raise AssertionError("mesh_path_viewer: " + "; ".join(fails))
    return r0["frame_launches"], steps_launches


# ---------------------------------------------------------------------------
# The offline preprocess, raw clip to trained scene.
# ---------------------------------------------------------------------------

# Waymo's five cameras in the order the clip writes them (FRONT first, so
# that transform2colmap gives FRONT COLMAP camera id 1), at Waymo's sizes.
WAYMO_CAMERAS = (("FRONT", 1920, 1280), ("FRONT_LEFT", 1920, 1280),
                 ("FRONT_RIGHT", 1920, 1280), ("SIDE_LEFT", 1920, 886),
                 ("SIDE_RIGHT", 1920, 886))
CAMERA_YAW_DEG = {"FRONT": 0.0, "FRONT_LEFT": 45.0, "FRONT_RIGHT": -45.0,
                  "SIDE_LEFT": 90.0, "SIDE_RIGHT": -90.0}
WAYMO_FOCAL = 2055.0               # px at 1920 wide, about Waymo FRONT's
WAYMO_DISTORTION = dict(k1=-0.03, k2=0.01, k3=0.0, k4=0.0, p1=5e-4,
                        p2=-3e-4)
CAR_LWH = (4.6, 2.0, 1.6)
EGO_SPEED = 10.0                   # m/s along the route
ROUTE_YAW = 0.3                    # the route's heading in the world frame


@dataclasses.dataclass(frozen=True)
class RawClip:
    """The raw clip preprocess_path writes in extract_waymo's layout, and
    how long it trains: 20 frames of a segment's ~200."""

    frames: int = 20
    cameras: tuple = WAYMO_CAMERAS
    sweep_points: int = 170_000    # one TOP sweep a frame
    moving: int = 6                # moving cars in every frame
    parked: int = 6
    returns: tuple = (800, 1200)   # a moving box's returns a sweep, [lo, hi]
    parked_returns: int = 300
    image_ext: str = "jpg"
    steps: int = 20
    train_flags: tuple = ()


RAW_CLIP = RawClip()


def _rotz(yaw: float) -> np.ndarray:
    c, s = math.cos(yaw), math.sin(yaw)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def raw_clip_boxes(clip: RawClip = RAW_CLIP):
    """Per frame, the cars' boxes as annotation.json holds them (world
    frame, wxyz, the moving cars first), and each frame's ego pose. The
    moving cars drive in four lanes beside the ego at 9-10.4 m/s, the
    parked ones stand at the kerbs; no box reaches the ground (the 1.1x
    box of extract_object_pts included) or another box."""
    route = _rotz(ROUTE_YAW)
    l, w, h = CAR_LWH
    frames = []
    for f in range(clip.frames):
        t = 0.1 * f
        ego = np.eye(4)
        ego[:3, :3] = route
        ego[:3, 3] = route @ np.array([EGO_SPEED * t, 0.0, 0.0])
        objs = []
        for i in range(clip.moving):
            lane = (-3.5, 3.5, -7.0, 7.0)[i % 4]
            x = 12.0 + 5.0 * i + (9.0 + 0.7 * (i % 3)) * t
            yaw = ROUTE_YAW + 0.02 * (i - 2.5)
            objs.append(dict(gid=f"moving{i}", is_moving=True, yaw=yaw,
                             center=route @ np.array([x, lane, h / 2 + 0.1])))
        for j in range(clip.parked):
            objs.append(dict(gid=f"parked{j}", is_moving=False,
                             yaw=ROUTE_YAW,
                             center=route @ np.array(
                                 [6.0 + 8.0 * j, (-10.0, 10.0)[j % 2],
                                  h / 2 + 0.1])))
        frames.append((ego, objs))
    return frames


def _box_points(rng, obj, n: int) -> np.ndarray:
    """n points inside the inner 0.9 of a box, world frame."""
    local = (rng.random_sample((n, 3)) - 0.5) * 0.9 * np.array(CAR_LWH)
    return local @ _rotz(obj["yaw"]).T + obj["center"]


def _camera_extrinsic(name: str) -> np.ndarray:
    """Camera -> vehicle in OpenCV axes, as extract_waymo turns a Waymo
    calibration (x forward, y left, z up) into one."""
    from street_gaussians_ns_tpu_torch.preprocess.extract_waymo import (
        OPENCV2WAYMO)
    yaw = math.radians(CAMERA_YAW_DEG[name])
    ext = np.eye(4)
    ext[:3, :3] = _rotz(yaw) @ OPENCV2WAYMO
    ext[:3, 3] = (1.5 * math.cos(yaw), 0.5 * math.sin(yaw), 2.0)
    return ext


def _paint_cars(img: np.ndarray, c2w_cv: np.ndarray, K: np.ndarray,
                objs: list) -> None:
    """Each car whose corners lie in front of the camera, far to near, as
    its image box: a coloured body over a dark lower third."""
    w2c = np.linalg.inv(c2w_cv)
    h, w = img.shape[:2]
    l, bw, bh = CAR_LWH
    corners = np.array([[sx * l / 2, sy * bw / 2, sz * bh / 2]
                        for sx in (-1, 1) for sy in (-1, 1)
                        for sz in (-1, 1)])
    drawn = []
    for k, obj in enumerate(objs):
        pts = corners @ _rotz(obj["yaw"]).T + obj["center"]
        cam = pts @ w2c[:3, :3].T + w2c[:3, 3]
        if (cam[:, 2] < 0.5).any():
            continue
        uv = cam[:, :2] / cam[:, 2:] * K[[0, 1], [0, 1]] + K[:2, 2]
        u0, v0 = np.floor(uv.min(0)).astype(int)
        u1, v1 = np.ceil(uv.max(0)).astype(int)
        u0, u1 = max(u0, 0), min(u1, w)
        v0, v1 = max(v0, 0), min(v1, h)
        if u0 < u1 and v0 < v1:
            drawn.append((cam[:, 2].mean(), k, u0, u1, v0, v1))
    for _, k, u0, u1, v0, v1 in sorted(drawn, reverse=True):
        split = v0 + 2 * (v1 - v0) // 3
        img[v0:split, u0:u1] = (170, 40 + 20 * (k % 6), 40)
        img[split:v1, u0:u1] = (35, 35, 40)


def write_raw_clip(root: Path, seed: int, clip: RawClip = RAW_CLIP) -> dict:
    """A clip as preprocess/extract_waymo.py writes one (:86-150), made
    with numpy from seed: images/<CAMERA>/<ts>.<ext> (a bright smooth sky
    over a dark road, the cars painted in), lidars/lidar_TOP/<ts>.pcd
    (ground, facades, and each car's returns, in the vehicle frame),
    transform.json (camera frames, frame-major with FRONT first, poses by
    extract_waymo.blender_pose; lidar_frames with the ego poses) and
    annotation.json. Returns what it wrote: the returns of each moving
    box a sweep (F, moving), the images, and the seconds it took."""
    from street_gaussians_ns_tpu_torch.data.pcd_io import write_pcd
    from street_gaussians_ns_tpu_torch.preprocess.extract_waymo import (
        blender_pose)

    Image = pillow_image()
    t0 = time.perf_counter()
    rng = np.random.RandomState(seed)
    lo, hi = clip.returns
    boxes = raw_clip_boxes(clip)
    bases = {}
    for name, w, h in clip.cameras:
        cy = h / 2
        v = np.arange(h, dtype=np.float64)[:, None, None]
        sky = 230.0 - 40.0 * v / cy + rng.randint(0, 3, (h, w, 3))
        road = 55.0 + rng.randint(0, 25, (h, w, 3))
        bases[name] = np.where(v < cy, sky, road).astype(np.uint8)
    frames_meta, lidar_meta, anno_frames = [], [], []
    returns = np.zeros((clip.frames, clip.moving), np.int64)
    image_s = 0.0
    for f, (ego, objs) in enumerate(boxes):
        ts = CLIP_TS0 + CLIP_DT_US * f
        t = time.perf_counter()
        for name, w, h in clip.cameras:
            focal = WAYMO_FOCAL * w / 1920
            K = np.array([[focal, 0, w / 2], [0, focal, h / 2], [0, 0, 1]])
            ext = _camera_extrinsic(name)
            img = bases[name].copy()
            _paint_cars(img, ego @ ext, K, objs)
            path = root / "images" / name / f"{ts}.{clip.image_ext}"
            path.parent.mkdir(parents=True, exist_ok=True)
            Image.fromarray(img).save(path)
            frames_meta.append({
                "file_path": path.relative_to(root).as_posix(),
                "fl_x": focal, "fl_y": focal, "cx": w / 2, "cy": h / 2,
                "w": w, "h": h, "camera_model": "OPENCV", "camera": name,
                "timestamp": ts / 1e6, **WAYMO_DISTORTION,
                "transform_matrix": blender_pose(ego, ext).tolist()})
        image_s += time.perf_counter() - t

        parts = []
        for i in range(clip.moving):
            returns[f, i] = rng.randint(lo, hi + 1)
            parts.append(_box_points(rng, objs[i], int(returns[f, i])))
        for obj in objs[clip.moving:]:
            parts.append(_box_points(rng, obj, clip.parked_returns))
        rest = clip.sweep_points - sum(len(p) for p in parts)
        n_ground = rest * 7 // 10
        r = 4.0 + 56.0 * np.sqrt(rng.random_sample(n_ground))
        a = rng.random_sample(n_ground) * 2 * np.pi
        ground = np.stack([r * np.cos(a), r * np.sin(a),
                           np.zeros(n_ground)], 1) @ ego[:3, :3].T \
            + ego[:3, 3] * np.array([1.0, 1.0, 0.0])
        n_wall = rest - n_ground
        wall = np.stack([EGO_SPEED * 0.1 * f - 30.0
                         + 110.0 * rng.random_sample(n_wall),
                         np.where(rng.random_sample(n_wall) < 0.5, -14.0,
                                  14.0),
                         12.0 * rng.random_sample(n_wall)], 1)
        wall = wall @ _rotz(ROUTE_YAW).T
        world = np.concatenate(parts + [ground, wall])
        world = world[rng.permutation(len(world))]
        vehicle = (world - ego[:3, 3]) @ ego[:3, :3]
        pcd = root / "lidars" / "lidar_TOP" / f"{ts}.pcd"
        pcd.parent.mkdir(parents=True, exist_ok=True)
        write_pcd(pcd, vehicle.astype(np.float32))
        lidar_meta.append({"file_path": pcd.relative_to(root).as_posix(),
                           "lidar": "lidar_TOP", "timestamp": ts / 1e6,
                           "transform_matrix": ego.tolist()})
        anno_frames.append({"timestamp": ts / 1e6, "objects": [
            {"type": "car", "gid": o["gid"],
             "translation": o["center"].tolist(), "size": list(CAR_LWH),
             "rotation": [math.cos(o["yaw"] / 2), 0.0, 0.0,
                          math.sin(o["yaw"] / 2)],
             "is_moving": o["is_moving"]} for o in objs]})
    with open(root / "transform.json", "w") as fh:
        json.dump({"frames": frames_meta, "lidar_frames": lidar_meta}, fh)
    with open(root / "annotation.json", "w") as fh:
        json.dump({"frames": anno_frames}, fh)
    return {"returns": returns, "images": len(frames_meta),
            "image_s": image_s, "seconds": time.perf_counter() - t0}


def data_process(root: Path, dev: str) -> dict:
    """The port's tools on the clip at root through their main(argv), as
    street_gaussians_ns_tpu_torch/scripts/data_process.sh chains them, the
    device tools on `dev`. No colmap on PATH: run_colmap's RuntimeError is
    kept and the known-pose origin model becomes sparse/0. Returns
    {tool: [seconds, what it wrote]} (the card's work of each waited for)
    and the run_colmap outcome."""
    from street_gaussians_ns_tpu_torch.preprocess import (
        colmap_pts_combine, extract_object_pts, masks_generate,
        pcd2colmap_points3d, run_colmap, segs_generate, transform2colmap)

    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    data, sparse = str(root), root / "colmap" / "sparse" / "0"
    out = {}

    def timed(name, fn, argv):
        t = time.perf_counter()
        n = fn(argv)
        sync()
        out[name] = [time.perf_counter() - t, n]

    timed("segs_generate", segs_generate.main,
          ["--data", data, "--mode", "naive", "--device", dev])
    timed("masks_generate", masks_generate.main,
          ["--data", data, "--dilate", "25", "--device", dev])
    timed("transform2colmap", transform2colmap.main,
          ["--data", data, "--output-dir", str(root / "colmap" / "origin")])
    if shutil.which("colmap") is None:
        try:
            run_colmap.main(["--data", data])
            colmap = "run_colmap ran"
        except RuntimeError as e:
            colmap = f"run_colmap raised RuntimeError: {e}"
    else:
        colmap = "a colmap binary is on PATH; SfM is not run at this size"
    shutil.copytree(root / "colmap" / "origin", sparse, dirs_exist_ok=True)
    timed("pcd2colmap_points3d", pcd2colmap_points3d.main,
          ["--data", data, "--output", str(sparse / "points3D_lidar.txt"),
           "--device", dev])
    timed("colmap_pts_combine", colmap_pts_combine.main,
          ["--colmap-dir", str(sparse), "--lidar-points",
           "points3D_lidar.txt"])
    timed("extract_object_pts", extract_object_pts.main,
          ["--data", data, "--device", dev])
    return out, colmap


def _read_lidar_rows(path: Path):
    rows = np.loadtxt(path, ndmin=2)
    return rows[:, 0].astype(np.int64), rows[:, 1:4], rows[:, 4:7]


def decode_differences(root: Path) -> dict:
    """Per JPEG under root/images (camera/file), the pixels whose Pillow
    decode (what segs and pcd2colmap read) differs from OpenCV's (what
    the masks tool reads, as the reference does)."""
    from street_gaussians_ns_tpu_torch.preprocess import masks_generate
    from street_gaussians_ns_tpu_torch.preprocess.pcd2colmap_points3d import (
        load_rgb)

    out = {}
    for path in sorted((root / "images").rglob("*.jpg")):
        a = load_rgb(path, "cpu")
        b = masks_generate.decode_rgb(path, "cpu")
        out[path.relative_to(root / "images").as_posix()] = (
            int((a != b).any(-1).sum()) if a.shape == b.shape
            else f"shapes {tuple(a.shape)} / {tuple(b.shape)}")
    return out


def compare_preprocess(card: Path, cpu: Path) -> dict:
    """Mismatch counts between the device tools' outputs of two clips:
    segs and masks byte for byte; points3D_lidar.txt by ids and colours
    exactly and xyz within 1e-9 of each point's norm; the object plys by
    gids, rows and colours exactly and xyz within one float32 ulp."""
    out = {}
    for d in ("segs", "masks"):
        files, other = ({p.relative_to(r / d) for p in (r / d).rglob("*.png")}
                        for r in (card, cpu))
        out[d] = len(files ^ other) + sum(
            (card / d / f).read_bytes() != (cpu / d / f).read_bytes()
            for f in files & other)
        out[d + "_files"] = len(files)
    rel = Path("colmap/sparse/0/points3D_lidar.txt")
    ia, xa, ca = _read_lidar_rows(card / rel)
    ib, xb, cb = _read_lidar_rows(cpu / rel)
    if len(ia) != len(ib):
        out["lidar_rows"] = abs(len(ia) - len(ib))
    else:
        tol = 1e-9 * np.linalg.norm(xb, axis=1)
        out["lidar_ids"] = int((ia != ib).sum())
        out["lidar_colors"] = int((ca != cb).any(1).sum())
        out["lidar_xyz"] = int((np.abs(xa - xb).max(1) > tol).sum())
    objs = Path("aggregate_lidar/dynamic_objects")
    ga = sorted(p.stem for p in (card / objs).glob("*.ply"))
    gb = sorted(p.stem for p in (cpu / objs).glob("*.ply"))
    out["ply_gids"] = len(set(ga) ^ set(gb))
    out["ply_rows"] = out["ply_colors"] = out["ply_xyz"] = 0
    for g in set(ga) & set(gb):
        a, b = (read_ply(r / objs / f"{g}.ply") for r in (card, cpu))
        if len(a["x"]) != len(b["x"]):
            out["ply_rows"] += 1
            continue
        out["ply_colors"] += int(sum((a[c] != b[c]).sum()
                                     for c in ("red", "green", "blue")))
        for c in "xyz":
            ulp = np.spacing(np.maximum(np.abs(a[c]), np.abs(b[c])))
            out["ply_xyz"] += int((np.abs(a[c].astype(np.float64) - b[c])
                                   > ulp).sum())
    return out


def phase_preprocess(seed: int, workdir: Path, clip: RawClip = RAW_CLIP,
                     dev="cuda", card: Optional[str] = None):
    """The offline preprocess of the port on a raw clip, then its trainer
    and eval: write_raw_clip into workdir/raw and a copy into
    workdir/raw_cpu; data_process on `dev` and on the CPU copy, every
    device tool's output held against the CPU's (compare_preprocess);
    then scripts.train.main on FRONT alone (camera id 1) with the
    combined seeds for clip.steps steps and scripts.eval.main, the counts
    set to 0 before each. Checks: the outputs equal, 10,000 seeds a
    sweep, one ply per moving car holding its returns, as many tracks as
    moving cars, a finite loss, kernels A-F and I launched in training
    and A-D and I in eval, no capacity overflow. `card` (nvidia-smi's name and power
    limit) is printed beside the times. Returns the launch counts of
    both."""
    cuda = dev == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    root, copy = Path(workdir) / "raw", Path(workdir) / "raw_cpu"
    run = Path(workdir) / "raw_run"
    made = write_raw_clip(root, seed + 202, clip)
    shutil.copytree(root, copy)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    on_card, colmap = data_process(root, dev)
    print(f"preprocess_path: {colmap}; colmap/origin is used as "
          "colmap/sparse/0", flush=True)
    peak_tools = torch.cuda.max_memory_allocated() if cuda else None
    on_cpu, _ = data_process(copy, "cpu")
    mismatches = compare_preprocess(root, copy)
    decodes = decode_differences(root)

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        reset_launches()
        t = time.perf_counter()
        trainer = train_cli.main([
            "--data", str(root), "--filter-camera-id", "1",
            "--init-points-filename", "points3D_withlidar.txt",
            "--trainer.output-dir", str(run),
            "--trainer.max-num-iterations", str(clip.steps),
            "--device", dev, *clip.train_flags])
        sync()
        train_s = time.perf_counter() - t
        train_launches = read_launches()
        reset_launches()
        t = time.perf_counter()
        evaluated = eval_cli.main(["--load-dir", str(run), "--device", dev])
        sync()
        eval_s = time.perf_counter() - t
        eval_launches = read_launches()
    peak = torch.cuda.max_memory_allocated() if cuda else None
    overflow = [str(w.message) for w in caught
                if "capacity overflow" in str(w.message)]
    rows = [json.loads(r) for r in
            (run / "metrics.jsonl").read_text().splitlines()]
    steps = [r for r in rows if "train/loss" in r]
    losses = [r["train/loss"] for r in steps]
    seeds = len(trainer.scene.points_xyz)
    tracks = trainer.scene.annotations.num_objects
    plys = {p.stem: len(read_ply(p)["x"]) for p in
            (root / "aggregate_lidar" / "dynamic_objects").glob("*.ply")}
    want_plys = {f"moving{i}": int(made["returns"][:, i].sum())
                 for i in range(clip.moving)}

    fails = [f"{k}: {v} mismatches" for k, v in mismatches.items()
             if not k.endswith("_files") and v]
    n_images = made["images"]
    if mismatches["segs_files"] != n_images or \
            mismatches["masks_files"] != n_images:
        fails.append(f"segs / masks written {mismatches} for {n_images} "
                     "images")
    # Every point outside the moving boxes, at most 10,000 a sweep.
    want_seeds = int(np.minimum(
        10_000, clip.sweep_points - made["returns"].sum(1)).sum())
    if on_card["pcd2colmap_points3d"][1] != want_seeds or \
            seeds != want_seeds:
        fails.append(f"seed points: {on_card['pcd2colmap_points3d'][1]} "
                     f"written, {seeds} parsed, {want_seeds} wanted")
    if plys != want_plys:
        fails.append(f"object plys {plys}, returns {want_plys}")
    if tracks != clip.moving:
        fails.append(f"{tracks} tracks for {clip.moving} moving cars")
    if not losses or not np.isfinite(losses).all():
        fails.append(f"losses {losses}")
    if cuda:
        for phase, launches, names in (
                ("training", train_launches, FUSED_KERNELS),
                ("eval", eval_launches, RENDER_KERNELS)):
            fails += [f"{phase} launched no {k}" for k in names
                      if launches.get(k, 0) <= 0]
    if overflow:
        fails.append(f"capacity overflow: {overflow[:2]}")
    res = evaluated["results"]
    sps = [r["train/steps_per_sec"] for r in steps]
    emit("preprocess_path", card=card, frames=clip.frames,
         cameras=[list(c) for c in clip.cameras],
         sweep_points=clip.sweep_points, moving=clip.moving,
         parked=clip.parked, returns_per_box=list(clip.returns),
         clip_s=made["seconds"], clip_image_s=made["image_s"],
         tools_card=on_card, tools_cpu=on_cpu,
         run_colmap=colmap, mismatches=mismatches,
         jpeg_decode_pixels_differing=decodes,
         image_libraries=_image_libraries(), seed_points=seeds,
         colmap_offset_m=float(np.linalg.norm(
             trainer.scene.applied_translation_in_colmap)),
         tracks=tracks, object_points=plys,
         train_s=train_s, steps=clip.steps, steps_per_s_rows=sps,
         loss_rows=losses, construction_s=trainer.setup_seconds,
         eval_s=eval_s, eval_results=res,
         max_memory_allocated_tools=peak_tools,
         max_memory_allocated=peak, train_launches=train_launches,
         eval_launches=eval_launches, failures=fails)
    if fails:
        raise AssertionError("preprocess_path: " + "; ".join(fails))
    del trainer
    return train_launches, eval_launches


# ---------------------------------------------------------------------------
# The training schedule through sgnt-train.
# ---------------------------------------------------------------------------

# The compressed schedule schedule_path passes on the command line, on the
# base, background and object-template configs alike (the SH ramp reads
# base, the refine passes background and object_template).
SCHEDULE = dict(warmup_length=100, refine_every=100, reset_alpha_every=5,
                sh_degree_interval=200, stop_screen_size_at=600,
                stop_split_at=900)
# 500,000 seeds. On this clip the culls outpace the densification (the
# scene shrinks) and the trained scene needs fewer pairs than the initial
# one, so the flags start the store and the pair capacity just above what
# the first steps need: the first densify meets a full store (608 free
# background slots) and the capacity check at step 0 doubles max_pairs.
SCHEDULE_CLIP = Clip(points=500_000, steps=1000, save_every=1000,
                     train_flags=("--trainer.background-capacity", "500608",
                                  "--no-trainer.presize-pairs",
                                  "--trainer.max-pairs", "12000000"))
KERNEL_WRAPPERS = ((scan, "cumsum_flat"), (expand, "expand_ragged"),
                   (composite, "pack_feat_cols"),
                   (composite, "composite_fwd"),
                   (composite, "composite_bwd"),
                   (composite, "rank_rowsum"))


def schedule_flags(schedule: dict = SCHEDULE) -> tuple:
    """The schedule as sgnt-train's dotted flags, for the three configs."""
    flags = []
    for part in ("base", "background", "object-template"):
        for k, v in schedule.items():
            flags += [f"--model.{part}.{k.replace('_', '-')}", str(v)]
    return tuple(flags)


def schedule_events(schedule: dict, steps: int, num_train: int) -> dict:
    """The steps at which each event of the schedule fires, from the
    reference's rules: a refine after step s when s % refine_every == 0,
    at step s, doing anything past warmup_length; it densifies when s <
    stop_split_at and s % reset_interval > num_train + refine_every,
    resets the opacities when s < stop_split_at and s % reset_interval ==
    refine_every, and culls once more at the first refine at or after
    stop_split_at; the SH degree steps up every sh_degree_interval; a step
    renders three times past stop_split_at."""
    every = schedule["refine_every"]
    interval = schedule["reset_alpha_every"] * every
    stop = schedule["stop_split_at"]
    refines = [s for s in range(0, steps, every)
               if s > schedule["warmup_length"]]
    return {
        "densify": [s for s in refines
                    if s < stop and s % interval > num_train + every],
        "reset": [s for s in refines if s < stop and s % interval == every],
        "final_cull": [s for s in refines if stop <= s < stop + every],
        "sh_degree": {s: s // schedule["sh_degree_interval"]
                      for s in range(schedule["sh_degree_interval"],
                                     min(steps, 4 * schedule[
                                         "sh_degree_interval"]),
                                     schedule["sh_degree_interval"])},
        "three_renders": [s for s in range(steps) if s > stop],
    }


def _sh_degree_seen(state) -> int:
    """The highest SH degree whose features_rest columns have a first
    moment: the degree the steps so far have trained."""
    mu = state.opt["features_rest"].mu["bg"]
    seen = 0
    for d in range(1, 4):
        cols = mu[:, d * d - 1:(d + 1) * (d + 1) - 1]
        if cols.shape[1] and bool(cols.any()):
            seen = d
    return seen


def _state_finite(state) -> list:
    """The names of the state's parameter groups and Adam moments that
    hold a value that is not finite."""
    bad = []
    for name, st in state.opt.items():
        for kind in ("mu", "nu"):
            leaf = getattr(st, kind)
            for k, t_ in (leaf.items() if isinstance(leaf, dict)
                          else [("", leaf)]):
                if not bool(torch.isfinite(t_).all()):
                    bad.append(f"opt/{name}/{kind}/{k}")
    for name in sts.GAUSSIAN_GROUPS:
        for k, t_ in sts._gaussian_group_params(state.store, name).items():
            if not bool(torch.isfinite(t_).all()):
                bad.append(f"{name}/{k}")
    for name in ("env_map",) + sts.BBOX_PARAMS:
        if not bool(torch.isfinite(getattr(state.store, name)).all()):
            bad.append(name)
    return bad


def refine_on_cpu_differs(before, after, info, noise, config, num_train,
                          max_hw) -> list:
    """The refine pass the card ran from `before` with `noise`, run again
    by the plain PyTorch of the CPU: counts, masks, statistics and moments
    must be exact, parameters within rtol 1e-6 / atol 1e-6. Returns what
    differs."""
    host = train_state_from_numpy(state_to_numpy(before), config,
                                  device="cpu")
    want, want_info = sts.scene_refine_step(
        host, config, num_train, max_hw,
        noise={k: (v.cpu() if v is not None else None)
               for k, v in noise.items()})
    bad = [f"info {k}: card {int(info[k])} cpu {int(v)}"
           for k, v in want_info.items() if int(info[k]) != int(v)]
    got, ref = state_to_numpy(after), state_to_numpy(want)
    for k, v in ref.items():
        g = got[k]
        if "/params/" in k or k == "store/env_map":
            if not np.allclose(g, v, rtol=1e-6, atol=1e-6):
                bad.append(f"{k}: max abs {float(np.abs(g - v).max())}")
        elif not np.array_equal(g, v):
            bad.append(f"{k} differs")
    return bad


def hold_to_plain(calls) -> dict:
    """Each of kernels A-F on the captured calls of one step against its
    plain version on the card, at phase_kernels' tolerances (A, B, C
    exact; D accum and T atol 2e-5 with n_contrib equal on every pixel;
    E rtol 1e-4 + atol 1e-5 of the largest |g| on the tiles the plain
    version replays, its rank row exact; F rtol 1e-4 + atol 1e-5 of the
    largest |sum|). Returns each kernel's largest error and the step's
    pair counts; raises on a disagreement."""
    err = {}
    for (x,), _ in calls["cumsum_flat"]:
        e = max(_max_err(scan.cumsum_flat(x), scan.cumsum_flat_plain(x)),
                _max_err(scan.cummax_flat(x), scan.cummax_flat_plain(x)))
        err["flat_scan"] = max(err.get("flat_scan", 0.0), e)
    for (src, starts, ends, out_len), _ in calls["expand_ragged"]:
        e = _max_err(expand.expand_ragged(src, starts, ends, out_len),
                     expand.expand_ragged_plain(src, starts, ends, out_len))
        err["expand_ragged"] = max(err.get("expand_ragged", 0.0), e)
    (feats, max_pairs), _ = calls["pack_feat_cols"][0]
    err["pack_feat_cols"] = _max_err(
        composite.pack_feat_cols(feats, max_pairs),
        composite.pack_feat_cols_plain(feats, max_pairs))
    for name in ("flat_scan", "expand_ragged", "pack_feat_cols"):
        if err[name] != 0.0:
            raise AssertionError(f"{name} differs from its plain version "
                                 f"by {err[name]} (must be exact)")
    (feat, ts, tc, ntx, nc), _ = calls["composite_fwd"][0]
    evals = torch.zeros((2 + ts.numel(),), dtype=torch.int64,
                        device=feat.device)
    got = composite.composite_fwd(feat, ts, tc, ntx, nc, evals=evals)
    want = composite.composite_fwd_plain(feat, ts, tc, ntx, nc)
    err["composite_fwd"] = max(_max_err(got[0], want[0]),
                               _max_err(got[1], want[1]))
    n_bad = int((got[2] != want[2]).sum())
    if err["composite_fwd"] > 2e-5 or n_bad:
        raise AssertionError(f"composite_fwd: max abs error "
                             f"{err['composite_fwd']} (atol 2e-5), "
                             f"n_contrib differs on {n_bad} pixels")
    fwd_evals, fwd_need = (int(v) for v in evals[:2].tolist())
    bwd_args, _ = calls["composite_bwd"][0]
    feat, ts, tc, ntx, nc, g_accum, g_t, tfin, ncon, accum = bwd_args
    nvis = composite.visited_counts(ncon, tc)
    shallow = nvis <= E_PLAIN_DEPTH
    tc_cmp = torch.where(shallow, tc, torch.zeros_like(tc))
    cmp_args = (feat, ts, tc_cmp, ntx, nc, g_accum, g_t, tfin, ncon, accum)
    got = composite.composite_bwd(*cmp_args)
    want = composite.composite_bwd_plain(
        *cmp_args[:-1], torch.sum(g_accum * accum, dim=-1))
    top = float(want[:, :10].abs().max())
    err["composite_bwd"] = _max_err(got[:, :10], want[:, :10])
    rel = float(((got[:, :10] - want[:, :10]).abs()
                 / (1e-4 * want[:, :10].abs() + 1e-5 * top)).max())
    if (not top > 0 or rel > 1.0
            or not torch.equal(got[:, 10:], want[:, 10:])):
        raise AssertionError(f"composite_bwd: max abs error "
                             f"{err['composite_bwd']} at largest |g| {top}")
    (rows11, rank_s, n_out), _ = calls["rank_rowsum"][0]
    got = segreduce.rank_rowsum(rows11, rank_s, n_out)
    want = segreduce.rank_rowsum_plain(rows11, rank_s, n_out)
    ftop = float(want.abs().max())
    err["rank_rowsum"] = _max_err(got, want)
    if not ftop > 0 or float(((got - want).abs() / (
            1e-4 * want.abs() + 1e-5 * ftop)).max()) > 1.0:
        raise AssertionError(f"rank_rowsum: max abs error "
                             f"{err['rank_rowsum']} at largest |sum| {ftop}")
    return {"max_abs_err": err, "tiles": ts.numel(),
            "max_tile_count": int(tc.max()), "fwd_pairs_needed": fwd_need,
            "fwd_pixel_pair_evals": fwd_evals,
            "plain_compared_tiles": int(shallow.sum()),
            **step_shares(calls["composite_bwd"][0])}


def step_shares(bwd_call) -> dict:
    """Pairs in the stream, visited and contributing shares of one
    captured backward (kernel E's counters)."""
    bwd_args, _ = bwd_call
    tc = bwd_args[2]
    evals = torch.zeros((3,), dtype=torch.int64, device=tc.device)
    composite.composite_bwd(*bwd_args, evals=evals)
    n_eval, n_vis, n_contrib = (int(v) for v in evals.tolist())
    pairs = int(tc.sum())
    return {"pairs_in_stream": pairs, "bwd_pairs_visited": n_vis,
            "bwd_pixel_pair_evals": n_eval,
            "bwd_contributing_evals": n_contrib,
            "visited_share": n_vis / max(pairs, 1),
            "contributing_share": n_contrib / max(n_eval, 1)}


class ScheduleObserver:
    """Watches a Trainer's loop from outside while active: each iteration's
    time and step, its renders (the step function's subset_accs), the SH
    degree trained at the steps in `sh_steps`, every refine pass (its
    counts, host and device ms, the gaussians after it, whether it zeroed
    the opacities' moments, every group finite), every capacity growth,
    every warning with its step, and loss and PSNR every 100 steps. At
    the refines in `cpu_checks` the pass is run again on the CPU from the
    same state and noise (refine_on_cpu_differs)."""

    def __init__(self, caught: list, sh_steps, cpu_checks):
        T = trainer_mod.Trainer
        self.caught, self.sh_steps = caught, set(sh_steps)
        self.cpu_checks = dict(cpu_checks)
        self.step = None
        self.rows, self.refines, self.growth, self.warned = [], [], [], []
        self.checks = []           # (step, max_pairs, max_rowruns) after
        #                            each capacity check
        self.samples, self.sh_seen, self.cpu_refine = [], {}, {}
        self.subset = None
        self.noise = None
        self.patches = [(T, "_iteration", self._iteration),
                        (T, "_step_fn", self._step_fn),
                        (T, "_refine", self._refine),
                        (T, "_maybe_grow_pairs", self._grow),
                        (sts, "draw_refine_noise", self._draw_noise)]
        self.orig = {name: getattr(owner, name)
                     for owner, name, _ in self.patches}

    def __enter__(self):
        for owner, name, fn in self.patches:
            # A function, so that a Trainer's attribute binds it.
            setattr(owner, name, (lambda f: lambda *a, **kw: f(*a, **kw))(fn))
        return self

    def __exit__(self, *exc):
        for owner, name, _ in self.patches:
            setattr(owner, name, self.orig[name])

    def _draw_noise(self, state, config):
        self.noise = self.orig["draw_refine_noise"](state, config)
        return self.noise

    def _step_fn(self, trainer, step):
        fn = self.orig["_step_fn"](trainer, step)
        self.subset = fn.keywords["subset_accs"]
        return fn

    def _iteration(self, trainer, step):
        self.step = step
        n_warned = len(self.caught)
        t = time.perf_counter()
        metrics = self.orig["_iteration"](trainer, step)
        if step % 100 == 0:
            self.samples.append({"step": step,
                                 "loss": float(metrics["loss"]),
                                 "psnr": float(metrics["psnr"]),
                                 "num_pairs": int(metrics["num_pairs"]),
                                 "max_pairs":
                                     trainer.render_config.max_pairs})
        self.rows.append((step, time.perf_counter() - t,
                          3 if self.subset else 1))
        if step in self.sh_steps:
            self.sh_seen[step] = _sh_degree_seen(trainer.state)
        for w in self.caught[n_warned:]:
            self.warned.append((step, str(w.message)))
        return metrics

    def _refine(self, trainer, max_hw):
        check = self.cpu_checks.get(self.step)
        before = trainer.state
        cuda = trainer.device.type == "cuda"
        if cuda:
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        t = time.perf_counter()
        state, info = self.orig["_refine"](trainer, max_hw)
        if cuda:
            end.record()
            torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t) * 1e3
        st = state.store
        op = state.opt["opacities"]
        reset = not any(bool(v.any()) for v in (op.mu["bg"], op.mu["obj"],
                                                op.nu["bg"], op.nu["obj"]))
        info = {k: int(v) for k, v in info.items()}
        parts = [p for p in ("bg", "obj") if f"{p}_gaussian_count" in info]
        row = {"step": self.step, "info": info, "host_ms": host_ms,
               "device_ms": start.elapsed_time(end) if cuda else None,
               "reset": reset,
               "candidates": sum(info[f"{p}_refine_splits_count"]
                                 + info[f"{p}_refine_dups_count"]
                                 for p in parts),
               "culls": sum(info[f"{p}_refine_culls_count"] for p in parts),
               "children_dropped": sum(info[f"{p}_children_dropped"]
                                       for p in parts),
               "background": int(st.background.active.sum()),
               "objects": [int(v) for v in st.objects.active.sum(dim=1)],
               "not_finite": _state_finite(state)}
        self.refines.append(row)
        if check is not None:
            self.cpu_refine[check] = {"step": self.step, "differs":
                                      refine_on_cpu_differs(
                                          before, state, info, self.noise,
                                          trainer.config, trainer.dm.num_train,
                                          max_hw)}
        return state, info

    def _grow(self, trainer, metrics):
        rc = trainer.render_config
        old = (rc.max_pairs, rc.max_rowruns)
        grew = self.orig["_maybe_grow_pairs"](trainer, metrics)
        rc = trainer.render_config
        if grew:
            self.growth.append({"step": self.step, "old": list(old),
                                "new": [rc.max_pairs, rc.max_rowruns]})
        self.checks.append((self.step, rc.max_pairs, rc.max_rowruns))
        return grew


OVERFLOW_RE = re.compile(r"render capacity overflow: (\d+) pairs for "
                         r"max_pairs=(\d+), (\d+) row runs for "
                         r"max_rowruns=(\d+)")


def persistent_overflows(warned, checks) -> list:
    """The overflows that outlived the capacity check that follows them:
    after the first check at or after the overflow's step, the capacities
    must hold its pair and row-run counts."""
    bad = []
    for step, msg in warned:
        m = OVERFLOW_RE.search(msg)
        if m is None:
            continue
        pairs, rowruns = int(m.group(1)), int(m.group(3))
        after = [c for c in checks if c[0] >= step]
        if not after:
            bad.append(f"step {step}: {pairs} pairs / {rowruns} runs, no "
                       f"check after it")
        elif pairs > after[0][1] or rowruns > after[0][2]:
            bad.append(f"step {step}: {pairs} pairs / {rowruns} runs, the "
                       f"check at {after[0][0]} left {after[0][1:]}")
    return bad


def phase_schedule(seed: int, workdir: Path, random_bwd=None,
                   clip: Clip = SCHEDULE_CLIP, schedule: dict = SCHEDULE,
                   card: str = "", dev="cuda"):
    """sgnt-train through the whole compressed schedule (SCHEDULE, on the
    command line) on a full-width clip of clip.points seeds: the first
    densifying refine, the culls, the opacity reset, the SH ramp to degree
    3, the final cull past stop_split_at, three renders a step past it,
    the pair capacity growing and a store that fills (clip.train_flags).
    Then sgnt-eval on the run. Checks: (1) every event at the step the
    schedule gives (schedule_events); (2) every parameter group and Adam
    moment finite at every refine; (3) no pair or row-run overflow left
    standing by the capacity check after it; (4) the first densifying
    refine and the reset refine again on the CPU from the same state and
    noise, exact but for parameters within 1e-6; (5) kernels A-F of one
    train step at the final state against their plain versions; (6) the
    final loss below the first, no render_error; and the capacity grew
    and the first densify dropped children for want of slots. The launch
    counts are set to 0 just before training and read just after.
    `random_bwd`: a captured backward of random weights, whose pair counts
    and shares are printed beside the final step's. Returns the counts."""
    cuda = dev == "cuda"
    root, run = Path(workdir) / "clip", Path(workdir) / "run"
    made = write_clip(root, seed + 202, clip, dev)
    num_train = math.ceil(clip.frames * 0.9)
    events = schedule_events(schedule, clip.steps, num_train)
    sh_steps = sorted({s + d for s in events["sh_degree"] for d in (-1, 0)})
    cpu_checks = {events["densify"][0]: "first densify",
                  events["reset"][0]: "reset"}
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with ScheduleObserver(caught, sh_steps, cpu_checks) as obs:
            reset_launches()
            t = time.perf_counter()
            trainer = train_cli.main([
                "--data", str(root), "--trainer.output-dir", str(run),
                "--trainer.max-num-iterations", str(clip.steps),
                "--trainer.steps-per-save", str(clip.save_every),
                "--device", dev, *schedule_flags(schedule),
                *clip.train_flags])
            if cuda:
                torch.cuda.synchronize()
            train_s = time.perf_counter() - t
            launches = read_launches()
        peak = torch.cuda.max_memory_allocated() if cuda else None
        t = time.perf_counter()
        evaluated = eval_cli.main(["--load-dir", str(run), "--device", dev])
        eval_s = time.perf_counter() - t
    state, cfg, rcfg = trainer.state, trainer.config, trainer.render_config

    # One train step at the final state, its kernel calls captured.
    cam, batch = trainer.dm.next_train(clip.steps)
    batch = trainer._device_batch(batch)
    recs = [Recorder(m, n) for m, n in KERNEL_WRAPPERS]
    for r in recs:
        r.__enter__()
    try:
        sts.scene_loss_and_grads(state, trainer.tracks, cam, batch, cfg,
                                 rcfg, subset_accs=False,
                                 jitter=draw_pixel_jitter(cam,
                                                          state.generator))
    finally:
        for r in recs:
            r.__exit__()
    final_calls = {r.name: r.calls for r in recs}
    held = hold_to_plain(final_calls) if cuda else None
    del final_calls, recs
    random_step = step_shares(random_bwd) if random_bwd is not None else None

    fails = []
    refines = {r["step"]: r for r in obs.refines}
    run_refines = [s for s in refines if s > schedule["warmup_length"]]
    # A densifying refine finds split or dup candidates (whether or not
    # their children find a slot); the final cull culls and finds none.
    seen = {
        "densify": [s for s in run_refines if refines[s]["candidates"] > 0],
        "reset": [s for s in run_refines if refines[s]["reset"]],
        "final_cull": [s for s in run_refines
                       if s >= schedule["stop_split_at"]
                       and refines[s]["candidates"] == 0
                       and refines[s]["culls"] > 0],
        "sh_degree": {s: obs.sh_seen.get(s) for s in events["sh_degree"]},
        "three_renders": [s for s, _, n in obs.rows if n == 3],
    }
    sh_before = {s: obs.sh_seen.get(s - 1) for s in events["sh_degree"]}
    for k, want in events.items():
        if seen[k] != want:
            fails.append(f"event {k}: at {seen[k]}, the schedule says {want}")
    if any(sh_before[s] != d - 1 for s, d in events["sh_degree"].items()):
        fails.append(f"SH degree before its steps {sh_before}")
    refine_steps = sorted(refines)
    if refine_steps != list(range(0, clip.steps, schedule["refine_every"])):
        fails.append(f"refines at {refine_steps}")
    for s, r in refines.items():
        if r["not_finite"]:
            fails.append(f"refine {s}: not finite {r['not_finite'][:4]}")
    overflows = [(s, m) for s, m in obs.warned if "capacity overflow" in m]
    fails += persistent_overflows(overflows, obs.checks)
    other = [(s, m) for s, m in obs.warned if "capacity overflow" not in m]
    for name, res in obs.cpu_refine.items():
        if res["differs"]:
            fails.append(f"{name} refine at {res['step']}: card and CPU "
                         f"differ: {res['differs'][:4]}")
    if set(obs.cpu_refine) != set(cpu_checks.values()):
        fails.append(f"CPU refines run: {sorted(obs.cpu_refine)}")
    if not obs.growth:
        fails.append("the pair capacity never grew")
    if not refines[events["densify"][0]]["children_dropped"]:
        fails.append("the first densify found a slot for every child")
    rows = [json.loads(r) for r in
            (run / "metrics.jsonl").read_text().splitlines()]
    losses = [r["train/loss"] for r in rows if "train/loss" in r]
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        fails.append(f"loss {losses[0]} -> {losses[-1]}")
    if any("render_error" in r for r in rows):
        fails.append("a render_error was logged")
    for name in FUSED_KERNELS:
        if cuda and launches.get(name, 0) == 0:
            fails.append(f"training launched no {name}")
    res = evaluated["results"]
    if not math.isfinite(res.get("psnr", math.nan)):
        fails.append(f"eval results {res}")

    def stretch(lo, hi):
        sel = [(dt, n) for s, dt, n in obs.rows if lo <= s < hi]
        return {"steps": len(sel), "seconds": sum(dt for dt, _ in sel),
                "steps_per_s": len(sel) / max(sum(dt for dt, _ in sel),
                                              1e-9)}
    first = events["densify"][0]
    stop = schedule["stop_split_at"]
    for r in obs.refines:
        emit("schedule_path[refine]", card=card, step=r["step"],
             counts=r["info"], background=r["background"],
             objects=r["objects"], reset=r["reset"], host_ms=r["host_ms"],
             device_ms=r["device_ms"])
    emit("schedule_path", card=card, points=clip.points,
         objects=clip.objects, object_points=clip.obj_points,
         size=[clip.size.width, clip.size.height], steps=clip.steps,
         schedule=schedule, train_flags=list(clip.train_flags),
         num_train=num_train, clip=made,
         events_expected=events, events_seen=seen,
         sh_degree_before=sh_before,
         construction_s=trainer.setup_seconds, train_s=train_s,
         stretches={"before_densification": stretch(0, first),
                    "densifying": stretch(first, stop + 1),
                    "past_stop_split_at": stretch(stop + 1, clip.steps)},
         refine_host_ms=[r["host_ms"] for r in obs.refines],
         refine_device_ms=[r["device_ms"] for r in obs.refines],
         growth=obs.growth, overflow_warnings=overflows,
         other_warnings=other[:5], samples=obs.samples,
         cpu_refine=obs.cpu_refine, eval_results=res, eval_s=eval_s,
         final_step=held, random_weight_step=random_step,
         max_memory_allocated=peak, launches=launches, failures=fails)
    if fails:
        raise AssertionError("schedule_path: " + "; ".join(fails))
    del trainer, state
    return launches


def capture(store, tracks, cfg, rcfg, cam):
    """Inputs of every kernel in one full-width render (the full render of
    forward_scene on `cam`)."""
    flat, active, _ = compose(store, tracks, cam.time, config=cfg)
    with Recorder(sh_kernel, "sh_colors_cuda") as sh_rec:
        rgbs = sh_colors(flat["means"], flat["features_dc_t"],
                         flat["features_rest"], cam, 0, cfg.base,
                         training=False)
    op = torch.sigmoid(flat["opacities"][:, 0])
    op = torch.where(active, op, torch.zeros_like(op))
    recs = [Recorder(scan, "cumsum_flat"), Recorder(expand, "expand_ragged"),
            Recorder(composite, "pack_feat_cols"),
            Recorder(composite, "composite_fwd"),
            Recorder(tiles, "_row_trim_counts"),
            Recorder(project_kernel, "project_cuda")]
    for r in recs:
        r.__enter__()
    try:
        render(flat["means"], torch.exp(flat["scales"]), flat["quats"], op,
               rgbs, cam, rcfg, training=False, active=active)
    finally:
        for r in recs:
            r.__exit__()
    calls = {r.name: r.calls for r in recs}
    calls["row_trim"] = calls.pop("_row_trim_counts")
    calls["project"] = calls.pop("project_cuda")
    calls["sh_colors"] = sh_rec.calls
    return calls


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


def rows_race_check(fn, x, repeats: int = SCAN_REPEATS) -> None:
    """Kernel H's tiles hand their totals on through global memory:
    `repeats` launches alternating between two streams (each with a
    scratch of its own) must all give the first launch's bits. Each
    result is compared on its own stream and dropped, so at most a few
    are alive at once."""
    want = fn(x)
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    torch.cuda.synchronize()
    bad = [torch.zeros((), dtype=torch.int64, device=x.device)
           for _ in streams]
    for i in range(repeats):
        with torch.cuda.stream(streams[i % 2]):
            got = fn(x)
            bad[i % 2] += (got.view(torch.int32)
                           != want.view(torch.int32)).any()
            del got
    torch.cuda.synchronize()
    n_bad = int(sum(b.item() for b in bad))
    if n_bad:
        raise AssertionError(f"scan_rows: {n_bad} of {repeats} launches on "
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


def second_windows(fwd_call, bwd_call):
    """The t_in launches of kernels D and E, which no route of the port
    makes: the captured whole-image launches split at half of each tile's
    pairs, as the JAX package's depth-sliced route splits them. The first
    window's forward (mark_done) hands its signed T on as the second
    window's t_in; the tiles with every pixel done there get no pairs.
    The backward's second window replays its own forward on the train
    step's stream and takes the image's cotangents."""
    def split(feat, ts, tc, ntx, nc):
        lead = tc // 2
        _, t_prev, _ = composite.composite_fwd(feat, ts, lead, ntx, nc,
                                               mark_done=True)
        done = t_prev.amax(dim=1) <= composite.T_EPS
        return ts + lead, torch.where(done, 0, tc - lead), t_prev

    (feat, ts, tc, ntx, nc), _ = fwd_call
    ts2, tc2, t_prev = split(feat, ts, tc, ntx, nc)
    fwd = ((feat, ts2, tc2, ntx, nc), dict(t_in=t_prev, mark_done=True))
    (feat, ts, tc, ntx, nc, g_accum, g_t, *_), _ = bwd_call
    ts2, tc2, t_prev = split(feat, ts, tc, ntx, nc)
    accum, t_signed, ncon = composite.composite_fwd(
        feat, ts2, tc2, ntx, nc, t_in=t_prev, mark_done=True)
    bwd = ((feat, ts2, tc2, ntx, nc, g_accum, g_t, t_signed.abs(), ncon,
            accum), dict(t_in=t_prev.abs()))
    return fwd, bwd


def rank_segments(rows11, rank_s, n_out):
    """Kernel G's arguments from kernel F's: the ten gradient rows in depth
    rank order, one segment per rank (the JAX package's shared-bins route
    sums the same per-rank runs, over every pair in expansion order)."""
    ranks = torch.arange(n_out, dtype=rank_s.dtype, device=rank_s.device)
    starts = torch.searchsorted(rank_s, ranks).to(torch.int32)
    ends = torch.searchsorted(rank_s, ranks, right=True).to(torch.int32)
    return rows11[:10].contiguous(), starts, ends


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


def _trim_row(calls, launches: int, train_launches: int, reps: int):
    """Kernel I on the arguments the eval frame's render and the train
    step's render handed it (strided views of the depth-sorted table, its
    tile boxes and q): first, last and count equal to the plain trim's,
    one device launch a call, its time, the plain trim's and its bound."""
    ms = plain = queued_ms = nbytes = 0.0
    shapes, per_call = [], []
    names = ("conics", "xys", "box", "tile_size", "max_h", "q")
    for key in ("row_trim", "row_trim[train]"):
        for a, kw in calls[key]:
            bound_args = dict(zip(names, a), **kw)
            args = tuple(bound_args[k] for k in names)
            conics, xys, box, tile_size, max_h, q = args
            got = tiles._row_trim_counts(*args)
            want = tiles._row_trim_counts_plain(*args)
            for name, g, w in zip(("first", "last", "count"), got, want):
                if not torch.equal(g, w):
                    raise AssertionError(
                        f"row_trim ({key}): {name} differs from the plain "
                        f"trim at {int((g != w).sum())} gaussians (must be "
                        f"exact)")
            if not all(torch.equal(a, b) for a, b in zip(
                    got, tiles._row_trim_counts(*args))):
                raise AssertionError("row_trim: two launches differ")
            n = conics.shape[0]
            per_call.append(_cuda.captured_launches(
                tiles.TRIM_KERNEL, lambda: tiles._row_trim_counts(*args)))
            one = time_ms(lambda: tiles._row_trim_counts(*args), reps)
            one_q = time_ms_queued(lambda: tiles._row_trim_counts(*args),
                                   reps)
            one_plain = time_ms(
                lambda: tiles._row_trim_counts_plain(*args), reps)
            ms += one
            queued_ms += one_q
            plain += one_plain
            # Read: the conic 12, the centre 8, the box 16, q 4; written:
            # first, last, count 12.
            nbytes += 52 * n
            shapes.append(dict(path=key, n=n, max_h=max_h,
                               tile_size=tile_size, ms=one,
                               ms_behind_a_busy_card=one_q,
                               plain_ms=one_plain,
                               pairs=int(want[2].sum()),
                               box_rows=int((box[:, 3] - box[:, 2]).clamp(
                                   0, max_h).sum())))
    if (not calls["row_trim"] or not calls["row_trim[train]"]
            or any(k != 1 for k in per_call)):
        raise AssertionError(f"row_trim: {len(calls['row_trim'])} eval and "
                             f"{len(calls['row_trim[train]'])} train calls "
                             f"made {per_call} device launches, expected "
                             f"calls from both, 1 launch each")
    b, by = bound(nbytes)
    return dict(name="row_trim", route="cuda",
                source=_rel(_cuda.CSRC / tiles.TRIM_KERNEL.source),
                replaces=tiles.TRIM_KERNEL.replaces,
                launches=launches,
                launches_on_train_path=train_launches,
                max_abs_err=0.0,
                tolerance="first, last and count exact; two launches "
                          "bit-equal",
                ms=ms, ms_behind_a_busy_card=queued_ms, plain_ms=plain,
                bound_ms=b, bound_by=by, library_ms=None,
                device_launches_per_call=per_call, shapes=shapes)


def _sh_row(calls, launches: dict, train_launches: dict, reps: int):
    """Kernel J on the arguments the eval frame and the train step handed
    it (compose's flat centres, DC and rest, the camera centre, the active
    degree): colours equal to the k-order formulation bit for bit and to
    the plain path's einsum within 2e-6; gradients (of a seeded random
    cotangent) equal to autograd's through the k-order formulation bit for
    bit and through the plain path wherever its sum is on the kernel's side
    of the clamp; one device launch a call each way; forward and backward
    times (also behind a busy card), the plain path's, the einsum's alone,
    and the bytes bounds."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    from sh_cases import k_order

    def same(a, b):
        return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())

    tot = dict(ms=0.0, bwd_ms=0.0, queued_ms=0.0, bwd_queued_ms=0.0,
               plain_ms=0.0, plain_bwd_ms=0.0, einsum_ms=0.0,
               einsum_bwd_ms=0.0, fwd_bytes=0.0, bwd_bytes=0.0)
    err, straddle = 0.0, 0
    shapes, per_call = [], []
    for key in ("sh_colors", "sh_colors[train]"):
        for (means, dc, rest, center, degree), _ in calls[key]:
            dc, rest, center = dc.detach(), rest.detach(), center.detach()
            n, k = means.shape[0], rest.shape[1] + 1
            cam = SimpleNamespace(c2w=torch.cat(
                [torch.zeros((3, 3), device=means.device), center[:, None]],
                1))
            leaves = [t.clone().requires_grad_(True)
                      for t in (dc, rest) * 3]
            got = sh_kernel.sh_colors_cuda(means, *leaves[0:2], center,
                                           degree)
            ordered = k_order(means, *leaves[2:4], center, degree)
            plain = splatfacto._sh_colors_plain(means, *leaves[4:6], cam,
                                                degree)
            if not same(got, ordered):
                raise AssertionError(f"sh_colors ({key}): colours differ "
                                     f"from the k-order formulation")
            fin = torch.isfinite(plain)
            e = _max_err(got[fin].detach(), plain[fin].detach())
            if e > 2e-6 or not torch.equal(torch.isnan(got),
                                           torch.isnan(plain)):
                raise AssertionError(f"sh_colors ({key}): colours {e} from "
                                     f"the plain path's (atol 2e-6)")
            err = max(err, e)
            g = torch.randn((n, 3), device=means.device, generator=(
                torch.Generator(device=means.device).manual_seed(n)))
            g_k = torch.autograd.grad(got, leaves[0:2], g)
            g_o = torch.autograd.grad(ordered, leaves[2:4], g)
            g_p = torch.autograd.grad(plain, leaves[4:6], g,
                                      retain_graph=True)
            pre = k_order(means, dc, rest, center, degree, clamp=False)
            coeffs = torch.cat([dc[:, None], rest], 1)
            d = means - center
            d = d / torch.clamp(torch.linalg.vector_norm(
                d, dim=-1, keepdim=True), min=1e-12)
            basis = sh_basis(d, sh_kernel.sh_degree_of(k)) * (
                torch.arange(k, device=d.device) < (degree + 1) ** 2).float()
            pre_plain = torch.einsum("nk,nkc->nc", basis, coeffs) + 0.5
            side = (pre >= 0) == (pre_plain >= 0)
            straddle += int((~side).sum())
            if not (same(g_k[0], g_o[0]) and same(g_k[1], g_o[1])
                    and same(g_k[0][side], g_p[0][side])
                    and same(g_k[1].transpose(0, 1)[:, side],
                             g_p[1].transpose(0, 1)[:, side])):
                raise AssertionError(f"sh_colors ({key}): gradients differ "
                                     f"from autograd's")
            _, mask = sh_kernel.sh_fwd(means, dc, rest, center, degree, True)
            fwd = lambda: sh_kernel.sh_fwd(means, dc, rest, center, degree,
                                           True)
            bwd = lambda: sh_kernel.sh_bwd(means, center, k, degree, mask, g)
            per_call.append([_cuda.captured_launches(sh_kernel.SH_KERNEL, f)
                             for f in (fwd, bwd)])
            one = dict(ms=time_ms(fwd, reps), bwd_ms=time_ms(bwd, reps),
                       queued_ms=time_ms_queued(fwd, reps),
                       bwd_queued_ms=time_ms_queued(bwd, reps),
                       plain_ms=time_ms(lambda: splatfacto._sh_colors_plain(
                           means, dc, rest, cam, degree), reps),
                       plain_bwd_ms=time_ms(lambda: torch.autograd.grad(
                           plain, leaves[4:6], g, retain_graph=True), reps))
            cf = coeffs.clone().requires_grad_(True)
            ein = torch.einsum("nk,nkc->nc", basis, cf)
            one["einsum_ms"] = time_ms(
                lambda: torch.einsum("nk,nkc->nc", basis, coeffs), reps)
            one["einsum_bwd_ms"] = time_ms(lambda: torch.autograd.grad(
                ein, cf, g, retain_graph=True), reps)
            # Forward: centre 12, DC 12, rest 12 (K - 1) read; rgb 12 and
            # the mask 1 written. Backward: centre 12, gradient 12, mask 1
            # read; d_dc 12 and d_rest 12 (K - 1) written.
            one["fwd_bytes"] = n * (12 * (k + 2) + 1)
            one["bwd_bytes"] = n * (12 * (k + 2) + 1)
            for name, v in one.items():
                tot[name] += v
            shapes.append(dict(path=key, n=n, k=k, active_degree=degree,
                               channels_straddling_the_clamp=int(
                                   (~side).sum()), **one))
            del leaves, got, ordered, plain, g_p, ein, cf
    if (not calls["sh_colors"] or not calls["sh_colors[train]"]
            or any(c != [1, 1] for c in per_call)):
        raise AssertionError(f"sh_colors: {len(calls['sh_colors'])} eval and "
                             f"{len(calls['sh_colors[train]'])} train calls "
                             f"made {per_call} device launches, expected "
                             f"calls from both, 1 launch each way")
    b, by = bound(tot["fwd_bytes"])
    bb, bby = bound(tot["bwd_bytes"])
    return dict(name="sh_colors", route="cuda",
                source=_rel(_cuda.CSRC / sh_kernel.SH_KERNEL.source),
                replaces=sh_kernel.SH_KERNEL.replaces,
                launches=launches["sh_colors"],
                launches_on_train_path=train_launches["sh_colors"],
                backward_launches_on_train_path=train_launches.get(
                    "sh_colors[bwd]", 0),
                max_abs_err=err,
                tolerance="colours bit-equal to the k-order formulation, "
                          "within 2e-6 of the einsum; gradients bit-equal "
                          "to autograd's through the k-order formulation, "
                          "and through the einsum where its sum is on the "
                          "same side of the clamp",
                channels_straddling_the_clamp=straddle,
                ms=tot["ms"], bwd_ms=tot["bwd_ms"],
                ms_behind_a_busy_card=tot["queued_ms"],
                bwd_ms_behind_a_busy_card=tot["bwd_queued_ms"],
                plain_ms=tot["plain_ms"], plain_bwd_ms=tot["plain_bwd_ms"],
                einsum_ms=tot["einsum_ms"],
                einsum_bwd_ms=tot["einsum_bwd_ms"],
                bound_ms=b, bound_by=by, bwd_bound_ms=bb, bwd_bound_by=bby,
                library_ms=None, device_launches_per_call=per_call,
                shapes=shapes)


def _waymo3_adam(seed: int) -> list:
    """Kernel K's stepping groups at scene_graph_waymo3's leaf shapes
    (benchmark/configs/scene_graph_waymo3.json: 2^22 background slots, one
    in 4 inactive, 12 vehicles x 2^15 slots with Fourier dim 5, SH degree
    3, the 6 x 1024 x 1024 sky, bbox deltas over 86 frames), at step 3601
    with random moments: [(AdamGroup, gradients)] as the step hands them to
    optimizers._step_kernel."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rand(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    n_bg, n_obj, cap = 2 ** 22, 12, 2 ** 15
    rows = {"means": (3,), "scales": (3,), "quats": (4,),
            "features_dc": (1, 3), "features_rest": (15, 3),
            "opacities": (1,)}
    bg_act = torch.rand(n_bg, generator=gen, device="cuda") > 0.25
    obj_act = torch.rand((n_obj, cap), generator=gen, device="cuda") > 0.05
    step = 3601
    out = []

    def group(name, params, active=None):
        cfg = optimizers.DEFAULT_GROUPS[name]
        state = optimizers.AdamState(
            mu=optimizers.tree_map(lambda p: rand(*p.shape, scale=1e-3),
                                   params),
            nu=optimizers.tree_map(lambda p: rand(*p.shape,
                                                  scale=1e-3) ** 2, params),
            count=step - 1)
        grads = optimizers.tree_map(lambda p: rand(*p.shape, scale=0.1),
                                    params)
        out.append((optimizers.AdamGroup(grads, state, params,
                                         optimizers.schedule(cfg, step), cfg,
                                         active), grads))

    for name, tail in rows.items():
        obj_tail = (5, 3) if name == "features_dc" else tail
        group(name, {"bg": rand(n_bg, *tail), "obj": rand(n_obj, cap,
                                                          *obj_tail)},
              {"bg": bg_act, "obj": obj_act})
    group("sky_sphere", rand(6, 1024, 1024, 3))
    group("bbox_opt", {"delta_center": rand(86, n_obj, 3),
                       "delta_yaw": rand(86, n_obj),
                       "delta_rot": rand(86, n_obj, 3)})
    return out


def _adam_row(calls, train_launches: dict, reps: int, seed: int):
    """Kernel K on the train step's own Adam groups (the flagship's 16
    leaves) and on scene_graph_waymo3's leaf set: p', m', v' equal to the
    plain version's (optimizers._step_plain) on the card bit for bit, one
    device launch a call, its time (also behind a busy card), the plain
    version's, torch.optim.Adam(fused=True)'s over the same leaves with the
    masked gradients (the yardstick; the port never calls it), and the
    bytes bound: 28 a float and one mask byte a row."""
    def same(a, b):
        return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())

    def leaves(tree):
        return optimizers._leaves(tree)

    sets = [("train_step", list(args[0]))
            for args, _ in calls["adam[train]"]]
    sets.append(("scene_graph_waymo3", _waymo3_adam(seed)))
    shapes, per_call, tot = [], [], dict(ms=0.0, queued_ms=0.0,
                                         plain_ms=0.0, library_ms=0.0,
                                         bytes=0.0)
    for label, stepping in sets:
        got = optimizers._step_kernel(stepping)
        want = optimizers._step_plain(stepping)
        for (gp, gs), (wp, ws), (group, _) in zip(got, want, stepping):
            pairs = list(zip(leaves(gp), leaves(wp))) + list(zip(
                leaves(gs.mu), leaves(ws.mu))) + list(zip(leaves(gs.nu),
                                                          leaves(ws.nu)))
            if not all(same(a, b) for a, b in pairs):
                raise AssertionError(f"adam ({label}): a leaf of "
                                     f"{group.config} differs from the "
                                     f"plain version")
        del got, want
        run = lambda: optimizers._step_kernel(stepping)  # noqa: E731
        per_call.append(_cuda.captured_launches(adam_kernel.ADAM_KERNEL,
                                                run))
        floats = mask_bytes = 0
        params, groups = [], []
        for group, grads in stepping:
            acts = (leaves(group.active) if group.active is not None
                    else [None] * len(leaves(group.params)))
            ps = []
            for p, g, a in zip(leaves(group.params), leaves(grads), acts):
                floats += p.numel()
                mask_bytes += a.numel() if a is not None else 0
                q = p.clone()
                q.grad = optimizers.mask_rows(g, a).contiguous()
                ps.append(q)
            cfg = group.config
            groups.append(dict(params=ps, lr=group.lr,
                               betas=(cfg.b1, cfg.b2), eps=cfg.eps))
            params += ps
        fused = torch.optim.Adam(groups, fused=True)
        one = dict(ms=time_ms(run, reps), queued_ms=time_ms_queued(run, reps),
                   plain_ms=time_ms(lambda: optimizers._step_plain(stepping),
                                    reps),
                   library_ms=time_ms(fused.step, reps),
                   bytes=28 * floats + mask_bytes)
        del fused, params, groups
        for k, v in one.items():
            tot[k] += v
        b, _ = bound(one["bytes"])
        shapes.append(dict(path=label, leaves=sum(
            len(leaves(g.params)) for g, _ in stepping), floats=floats,
            mask_bytes=mask_bytes, bound_ms=b, **one))
    if not calls["adam[train]"] or any(n != 1 for n in per_call):
        raise AssertionError(f"adam: {len(calls['adam[train]'])} train "
                             f"calls made {per_call} device launches, "
                             f"expected calls, 1 launch each")
    b, by = bound(tot["bytes"])
    return dict(name="adam", route="cuda",
                source=_rel(_cuda.CSRC / adam_kernel.ADAM_KERNEL.source),
                replaces=adam_kernel.ADAM_KERNEL.replaces,
                launches=0, launches_on_train_path=train_launches["adam"],
                max_abs_err=0.0,
                tolerance="p', m', v' bit-equal to the plain version on "
                          "the card",
                ms=tot["ms"], ms_behind_a_busy_card=tot["queued_ms"],
                plain_ms=tot["plain_ms"], bound_ms=b, bound_by=by,
                library_ms=tot["library_ms"],
                library="torch.optim.Adam(fused=True), masked gradients "
                        "made outside",
                device_launches_per_call=per_call, shapes=shapes)


def _project_bwd_checks(a: dict, view: bool, got):
    """Kernel L's backward `got` (d_means, d_scales, d_quats, d_viewmat or
    None) on one captured call's arguments `a`, held three ways:

    - bit for bit to its specification, the closed form
      ops.project._project_vjp_plain run on the card in float32 (the view
      matrix's 12 sums, which the kernel adds in float64 over its blocks
      and the closed form in float32 by torch.sum, within 1e-6 of their
      largest entry);
    - the closed form in float64 against autograd through the plain
      version in float64, element by element: rtol 1e-9 and atol 1e-12 of
      the gradient's largest element (both add the same float64 terms in
      other orders; at 4.6 M slots they lie within 1e-15 of it);
    - the kernel's float32 error from that float64 gradient no larger than
      twice autograd's own in float32, plus 1e-9 of the largest element.

    Returns (one record a gradient, the largest |kernel - closed form| over
    the view matrix's largest entry, autograd's float32 backward as a
    callable on its kept graph, for timing). The
    records carry each gradient's median nonzero |g| over its largest, so
    that the atols are read beside the typical value they sit under (most
    slots of a step touch no pixel and get exact zeros)."""
    from street_gaussians_ns_tpu_torch.core.projection import _project_plain

    a = {k: v.detach() if isinstance(v, torch.Tensor) else v
         for k, v in a.items()}
    geo = ("means", "scales", "quats", "viewmat", "fx", "fy", "cx", "cy")
    cots = ("g_xys", "g_depths", "g_conics", "g_comp")
    frame = (a["width"], a["height"])
    spec = project_kernel._project_vjp_plain(
        *(a[k] for k in geo), *frame, a["clip_thresh"],
        *(a.get(k) for k in cots))

    def autograd(dtype):
        x = {k: a[k].to(dtype) for k in geo}
        leaves = [x[k].clone().requires_grad_(True)
                  for k in ("means", "scales", "quats")]
        vm = x["viewmat"].clone().requires_grad_(view)
        pp = _project_plain(*leaves, vm, *(x[k] for k in geo[4:]), *frame,
                            16, a["clip_thresh"], dtype=dtype)
        outs = [(o, a[k].to(dtype)) for o, k in zip(
            (pp.xys, pp.depths, pp.conics, pp.comp), cots)
            if a.get(k) is not None]
        return lambda: torch.autograd.grad(  # noqa: E731
            [o for o, _ in outs], leaves + ([vm] if view else []),
            [g for _, g in outs], retain_graph=True)

    plain_bwd = autograd(torch.float32)
    auto, truth = plain_bwd(), autograd(torch.float64)()
    spec64 = project_kernel._project_vjp_plain(
        *(a[k].double() for k in geo), *frame, a["clip_thresh"],
        *(a[k].double() if a.get(k) is not None else None for k in cots))
    names = ("means", "scales", "quats") + (("viewmat",) if view else ())
    records, view_err = [], 0.0
    for i, name in enumerate(names):
        k, s, w, t, s64 = got[i], spec[i], auto[i], truth[i], spec64[i]
        fin = torch.isfinite(t)
        top = float(t[fin].abs().max()) if bool(fin.any()) else 0.0
        live = t[fin & (t != 0)].abs()
        med = float(live.median()) / top if live.numel() else 0.0
        same = (k == s) | (torch.isnan(k) & torch.isnan(s))
        differ = int((~same).sum())
        if name == "viewmat":
            d = float((k - s).abs().max())
            view_err = max(view_err, d / top if top else d)
            if d > 1e-6 * top:
                raise AssertionError(f"project (backward): the view "
                                     f"matrix's sums {d} from the closed "
                                     f"form's (largest {top})")
        elif differ:
            raise AssertionError(f"project (backward): {differ} elements of "
                                 f"{name} differ from the closed form's on "
                                 f"the card")
        d64 = (s64 - t).abs()
        bad = fin & (d64 > 1e-9 * t.abs() + 1e-12 * top)
        if bool(bad.any()) or not torch.equal(torch.isnan(s64),
                                              torch.isnan(t)):
            raise AssertionError(f"project (backward): the closed form's "
                                 f"{name} in float64 lies "
                                 f"{float(d64[fin].max())} from autograd's "
                                 f"(largest {top})")
        ok = fin & torch.isfinite(k) & torch.isfinite(w)
        e_k = float((k.double() - t)[ok].abs().max()) if bool(
            ok.any()) else 0.0
        e_a = float((w.double() - t)[ok].abs().max()) if bool(
            ok.any()) else 0.0
        if e_k > 2 * e_a + 1e-9 * top:
            raise AssertionError(f"project (backward): {name}'s float32 "
                                 f"error {e_k} over twice autograd's {e_a} "
                                 f"(largest {top})")
        records.append(dict(
            grad=name, largest=top, nonzero=int(live.numel()),
            median_nonzero_over_largest=med,
            elements_differing_from_closed_form=differ,
            closed_form_f64_err_over_largest=(
                float(d64[fin].max()) / top if top else 0.0),
            kernel_f32_err_over_largest=e_k / top if top else 0.0,
            autograd_f32_err_over_largest=e_a / top if top else 0.0))
    return records, view_err, plain_bwd


def _rel(path) -> str:
    return str(Path(path).resolve().relative_to(REPO))


def _project_row(calls, launches: dict, train_launches: dict, reps: int):
    """Kernel L on the arguments the eval frame's three renders and the
    train step's render handed it (compose's flat set, the exponentiated
    scales, the opacities, the mask and, in training, the centre offset),
    and its backward on the step's own cotangents: the forward bit-equal to
    the plain version's (core.projection._project_plain, the mask and the
    offset applied as the CPU path applies them); the backward checked by
    `_project_bwd_checks`; one device launch a call each way; forward and
    backward times (also behind a busy card), the plain path's both ways,
    and the bytes bounds (forward: centre 12, scales 12, quaternion 16, opacity 4, mask
    1 and offset 8 where given read, 52 written; backward: the 40 of the
    geometry and the cotangents given read, 40 written)."""
    import dataclasses as dc

    from street_gaussians_ns_tpu_torch.core.projection import _project_plain

    names = ("means", "scales", "quats", "viewmat", "fx", "fy", "cx", "cy",
             "width", "height", "tile_size", "clip_thresh", "opacities",
             "active", "xys_offset")

    def plain_fwd(a):
        p = _project_plain(*(a[k] for k in names[:13]))
        if a["active"] is not None:
            p = dc.replace(p, radii=torch.where(a["active"], p.radii, 0),
                           num_tiles_hit=torch.where(a["active"],
                                                     p.num_tiles_hit, 0))
        if a["xys_offset"] is not None:
            p = dc.replace(p, xys=p.xys + a["xys_offset"])
        return p

    def same(a, b):
        return bool(((a == b) | (torch.isnan(a.float())
                                 & torch.isnan(b.float()))).all())

    tot = dict(ms=0.0, queued_ms=0.0, plain_ms=0.0, bwd_ms=0.0,
               bwd_queued_ms=0.0, plain_bwd_ms=0.0, fwd_bytes=0.0,
               bwd_bytes=0.0)
    shapes, per_call, err, bwd_checks = [], [], 0.0, []
    for key in ("project", "project[train]"):
        for args, kw in calls[key]:
            a = dict(zip(names, args), **kw)
            a = {k: (v.detach() if isinstance(v, torch.Tensor) else v)
                 for k, v in a.items()}
            fwd_args = tuple(a[k] for k in names)
            fwd = lambda: project_kernel.project_fwd(*fwd_args)  # noqa: E731
            got, want = fwd(), plain_fwd(a)
            for f in ("xys", "depths", "radii", "conics", "comp",
                      "num_tiles_hit", "tile_box"):
                if not same(getattr(got, f), getattr(want, f)):
                    raise AssertionError(f"project ({key}): {f} differs from "
                                         f"the plain version's")
            n = a["means"].shape[0]
            per_call.append(_cuda.captured_launches(
                project_kernel.PROJECT_KERNEL, fwd))
            one = dict(ms=time_ms(fwd, reps),
                       queued_ms=time_ms_queued(fwd, reps),
                       plain_ms=time_ms(lambda: plain_fwd(a), reps))
            one["fwd_bytes"] = n * (44 + 52 + (a["active"] is not None)
                                    + 8 * (a["xys_offset"] is not None))
            for k, v in one.items():
                tot[k] += v
            shapes.append(dict(path=key, n=n, width=a["width"],
                               height=a["height"],
                               visible=int((got.radii > 0).sum()), **one))
    for args, kw in calls["project[bwd]"]:
        bnames = ("means", "scales", "quats", "viewmat", "fx", "fy", "cx",
                  "cy", "width", "height", "clip_thresh", "g_xys",
                  "g_depths", "g_conics", "g_comp")
        a = dict(zip(bnames, args), **kw)
        view = bool(a.pop("view_grad", False))
        bargs = tuple(a.get(k) for k in bnames)
        bwd = lambda: project_kernel.project_bwd(  # noqa: E731
            *bargs, view_grad=view)
        checks, e, auto = _project_bwd_checks(a, view, bwd())
        err = max(err, e)
        bwd_checks.append(checks)
        n = a["means"].shape[0]
        per_call.append(_cuda.captured_launches(
            project_kernel.PROJECT_KERNEL, bwd))
        one = dict(bwd_ms=time_ms(bwd, reps),
                   bwd_queued_ms=time_ms_queued(bwd, reps),
                   plain_bwd_ms=time_ms(auto, reps))
        one["bwd_bytes"] = n * (40 + 40 + sum(
            4 * g.shape[1] if g.dim() == 2 else 4
            for g in map(a.get, ("g_xys", "g_depths", "g_conics", "g_comp"))
            if g is not None))
        for k, v in one.items():
            tot[k] += v
        shapes.append(dict(path="project[bwd]", n=n, view_grad=view, **one))
        del auto
    if (not calls["project"] or not calls["project[train]"]
            or not calls["project[bwd]"] or any(c != 1 for c in per_call)):
        raise AssertionError(f"project: {len(calls['project'])} eval, "
                             f"{len(calls['project[train]'])} train and "
                             f"{len(calls['project[bwd]'])} backward calls "
                             f"made {per_call} device launches, expected "
                             f"calls of each, 1 launch each")
    b, by = bound(tot["fwd_bytes"])
    bb, bby = bound(tot["bwd_bytes"])
    return dict(name="project", route="cuda",
                source=_rel(_cuda.CSRC
                            / project_kernel.PROJECT_KERNEL.source),
                replaces=project_kernel.PROJECT_KERNEL.replaces,
                launches=launches["project"],
                launches_on_train_path=train_launches["project"],
                backward_launches_on_train_path=train_launches.get(
                    "project[bwd]", 0),
                max_abs_err=err,
                tolerance="forward bit-equal to the plain version; "
                          "backward bit-equal to the closed form "
                          "ops.project._project_vjp_plain on the card (the "
                          "view matrix's block sums within 1e-6 of its "
                          "largest entry; max_abs_err: the largest "
                          "difference over that entry), the closed form "
                          "within 1e-9 relative, 1e-12 of each gradient's "
                          "largest element, of autograd's in float64, and "
                          "the kernel's float32 error no more than twice "
                          "autograd's plus 1e-9 of that element",
                backward_checks=bwd_checks,
                ms=tot["ms"], bwd_ms=tot["bwd_ms"],
                ms_behind_a_busy_card=tot["queued_ms"],
                bwd_ms_behind_a_busy_card=tot["bwd_queued_ms"],
                plain_ms=tot["plain_ms"], plain_bwd_ms=tot["plain_bwd_ms"],
                bound_ms=b, bound_by=by, bwd_bound_ms=bb, bwd_bound_by=bby,
                library_ms=None, device_launches_per_call=per_call,
                shapes=shapes)


def phase_kernels(calls, launches, train_launches, scan_launches,
                  reps: int = REPS):
    """calls: the captured arguments of every kernel; launches: of the
    eval frames; train_launches, scan_launches: of the paths that first
    drove kernels E and F, and kernel H."""
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
    # The library formulation: the JAX package's off-TPU pack
    # (composite_pallas.py:1497-1502), a stack of the 16 columns (zeros
    # past the live ones, made outside the clock) and one transposing copy.
    cols16 = list(feats) + [torch.zeros_like(feats[0])] * (16 - len(feats))
    rows_true = max_pairs // 128
    lib = time_ms(lambda: torch.stack(cols16, dim=-1).reshape(
        rows_true, 128, 16).transpose(1, 2).contiguous(), reps)
    del cols16
    b, by = bound(4 * (len(feats) * max_pairs + got.numel()))
    rows.append(dict(name="pack_feat_cols", route="cuda",
                     source=_rel(_cuda.CSRC / composite.PACK_KERNEL.source),
                     replaces=composite.PACK_KERNEL.replaces,
                     launches=launches["pack_feat_cols"], max_abs_err=err,
                     tolerance="exact", ms=ms, plain_ms=plain, bound_ms=b,
                     bound_by=by, library_ms=lib,
                     library="torch.stack of the 16 columns, then "
                             ".reshape(rows, 128, 16).transpose(1, 2)"
                             ".contiguous() (composite_pallas.py:1497-1502)",
                     shapes=[len(feats), max_pairs, list(got.shape)]))

    # D and E: the compositors, whole-image launches of the fused path.
    rows.append(_fwd_row("composite_fwd", calls["composite_fwd"][0],
                         launches["composite_fwd"], reps, tile0_check=True))
    rows.append(_bwd_row("composite_bwd", calls["composite_bwd"][0],
                         train_launches["composite_bwd"], reps,
                         tile0_check=True))

    # D and E continuing a transmittance: the second window of the same
    # launches. No route of the port makes these launches.
    fwd_t_in, bwd_t_in = second_windows(calls["composite_fwd"][0],
                                        calls["composite_bwd"][0])
    rows.append(_fwd_row("composite_fwd[t_in]", fwd_t_in, 0, reps,
                         tile0_check=True))
    rows.append(_bwd_row("composite_bwd[t_in]", bwd_t_in, 0, reps))
    del fwd_t_in, bwd_t_in

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

    # G: segmented row sum, which no route of the port calls, on the same
    # gradient rows cut into one segment per rank.
    rows_cm, starts, ends = rank_segments(rows11, rank_s, n_out)
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
    per_call = _cuda.captured_launches(
        segreduce.SEG_KERNEL,
        lambda: segreduce.segment_rowsum(rows_cm, starts, ends))
    if per_call != 1:
        raise AssertionError(f"segment_rowsum: a call made {per_call} "
                             f"device launches, expected 1")
    ms = time_ms(lambda: segreduce.segment_rowsum(rows_cm, starts, ends),
                 reps)
    queued = time_ms_queued(lambda: segreduce.segment_rowsum(
        rows_cm, starts, ends), reps)
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

    def index_add():
        return torch.zeros((rows_cm.shape[0], n_seg), dtype=torch.float32,
                           device=vals.device).index_add_(1, seg_ids, vals)
    lib = time_ms(index_add, reps)
    lib_queued = time_ms_queued(index_add, reps)
    b, by = bound(4 * (rows_cm.shape[0] * covered + 2 * n_seg
                       + rows_cm.shape[0] * n_seg))
    rows.append(dict(name="segment_rowsum", route="cuda",
                     source=_rel(_cuda.CSRC / segreduce.SEG_KERNEL.source),
                     replaces=segreduce.SEG_KERNEL.replaces,
                     launches=0, max_abs_err=err,
                     tolerance="rtol 1e-4 + atol 1e-5 of the largest |sum|; "
                               "two launches bit-equal",
                     largest_sum=top, ms=ms, plain_ms=plain, bound_ms=b,
                     bound_by=by, library_ms=lib,
                     library="torch.Tensor.index_add_ (segment ids prepared "
                             "outside the timing)",
                     device_launches_per_call=[per_call],
                     ms_behind_a_busy_card=queued,
                     library_ms_behind_a_busy_card=lib_queued,
                     shapes=[list(rows_cm.shape), n_seg],
                     covered_pairs=covered, longest_run=int(lens.max()),
                     runs_over_32=int((lens > 32).sum()),
                     empty_runs=int((lens == 0).sum())))
    del rows_cm, starts, ends, seg_ids, vals

    # H: row scans at the three shapes of the JAX package's
    # micro-benchmark. int32 exact; the float32 sum at rtol 1e-5 of the
    # column's largest running magnitude (its association differs from
    # torch.cumsum's).
    ms = plain = lib = nbytes = err = queued_ms = 0.0
    shapes, per_call = [], []
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
        if x.dtype == torch.float32 and op == "add":
            rows_race_check(fn, x)
        n_dev = _cuda.captured_launches(scan.ROWS_KERNEL, lambda: fn(x))
        per_call.append(n_dev)
        one = time_ms(lambda: fn(x), reps)
        one_q = time_ms_queued(lambda: fn(x), reps)
        queued_ms += one_q
        ms += one
        plain += one_plain
        lib += one_plain      # the plain version is the library call
        nbytes += 2 * 4 * x.numel()
        shapes.append(dict(shape=list(x.shape), dtype=str(x.dtype), op=op,
                           ms=one, ms_behind_a_busy_card=one_q,
                           device_launches_per_call=n_dev,
                           library_ms=one_plain,
                           plain_float32_abs_err=(
                               plain_err if x.dtype == torch.float32
                               else None),
                           bound_ms=2 * 4 * x.numel() / HBM_BYTES_PER_S
                           * 1e3))
    if any(n != 1 for n in per_call):
        raise AssertionError(f"scan_rows: a call made {per_call} device "
                             f"launches, expected 1 each")
    b, by = bound(nbytes)
    rows.append(dict(name="scan_rows", route="cuda",
                     source=_rel(_cuda.CSRC / scan.ROWS_KERNEL.source),
                     replaces=scan.ROWS_KERNEL.replaces,
                     launches=scan_launches["scan_rows"], max_abs_err=err,
                     tolerance="int32 exact; float32 sum rtol 1e-5 of the "
                               "column's largest, against the plain version "
                               "in float64; two launches bit-equal",
                     ms=ms, ms_behind_a_busy_card=queued_ms,
                     device_launches_per_call=per_call,
                     repeats_on_two_streams_equal=SCAN_REPEATS,
                     plain_ms=plain, bound_ms=b, bound_by=by,
                     library_ms=lib,
                     library="torch.cummax / torch.cumsum along dim 0",
                     on_render_path=False, shapes=shapes))

    rows.append(_trim_row(calls, launches["row_trim"],
                          train_launches["row_trim"], reps))
    rows.append(_sh_row(calls, launches, train_launches, reps))
    rows.append(_adam_row(calls, train_launches, reps, seed=0))
    rows.append(_project_row(calls, launches, train_launches, reps))
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
    state, batch, train_launches, train_ms = phase_train(
        args.seed, tracks, cfg, rcfg, cam0)
    phase_profile("train_profile", lambda: sts.scene_train_step(
        state, tracks, cam0, batch, cfg, rcfg, subset_accs=False))
    train_calls, jitter, res = capture_train(state, tracks, cfg, rcfg, cam0,
                                             batch)
    phase_train_stages(state, tracks, cfg, rcfg, cam0, batch, train_calls,
                       jitter, res)
    del res
    calls.update(train_calls)
    del state
    scan_calls, scan_launches = phase_row_scans(args.seed)
    calls.update(scan_calls)
    new_paths = {}
    splat = phase_splatfacto(args.seed)
    new_paths["splatfacto_path[eval]"] = splat["eval"]
    new_paths["splatfacto_path[train]"] = splat["train"]
    phase_deform4d(args.seed)
    new_paths["camopt_path[SE3]"] = phase_camopt(args.seed, tracks, cfg,
                                                 rcfg, train_ms=train_ms)
    new_paths["bf16_path"] = phase_bf16(args.seed, tracks, cfg, rcfg)
    new_paths["mesh_path[(1,1) nccl]"] = phase_mesh_unit(args.seed, cfg,
                                                         rcfg)
    with tempfile.TemporaryDirectory(prefix="sgnt_mesh_") as tmp:
        new_paths["mesh_path[(2,1) (1,2) gloo, 2 ranks]"] = \
            phase_mesh_shared(args.seed, cfg, rcfg, Path(tmp))
    with tempfile.TemporaryDirectory(prefix="sgnt_cli_") as tmp:
        run = phase_cli(args.seed, Path(tmp))
        new_paths["viewer_path"] = phase_viewer(run)
        new_paths["mesh_path[cli]"] = phase_mesh_cli(Path(tmp) / "mesh_run",
                                                     Path(tmp) / "clip")
        (new_paths["mesh_path_viewer[frames]"],
         new_paths["mesh_path_viewer[steps]"]) = phase_mesh_viewer(
            Path(tmp) / "clip", Path(tmp) / "mesh_viewer", smi)
    with tempfile.TemporaryDirectory(prefix="sgnt_raw_") as tmp:
        (new_paths["preprocess_path[train]"],
         new_paths["preprocess_path[eval]"]) = phase_preprocess(
            args.seed, Path(tmp), card=smi)
    with tempfile.TemporaryDirectory(prefix="sgnt_schedule_") as tmp:
        new_paths["schedule_path"] = phase_schedule(
            args.seed, Path(tmp), calls["composite_bwd"][0], card=smi)
    rows = phase_kernels(calls, launches, train_launches, scan_launches)
    for r in rows:
        r["card"] = smi
        r["launches_on_later_paths"] = {
            path: counts.get(r["name"], 0)
            for path, counts in new_paths.items()}
    emit("earlier_times", quoted_from="PERF.md section 6",
         measured_in_this_run=False, ms=EARLIER_MS)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
