"""Training runtime: the host loop around the scene-graph step (counterpart
of street_gaussians_ns_tpu/engine/trainer.py).

Per step: the next train batch, `scene_train_step` (forward, losses,
backward through the fused rasterizer, 9-group Adam, densification
statistics); every refine_every steps `scene_refine_step`; an eval image
every steps_per_eval_image, the whole eval split every
steps_per_eval_all_images and at the end; a checkpoint every
steps_per_save and at the end. The single-model pipeline is the scene
graph with zero objects.

The device is an argument of `Trainer` (default "cuda"), not a config
field, so config.json keeps the JAX schema but for the render route;
asking for "cuda" without a card raises. The port renders through its one fused kernel route, so the
JAX package's field that picks a render route has no counterpart here (a
config.json that names a route loads and renders through the fused one);
`render_precision="auto"` resolves to "f32", as it does off a TPU.
Randomness comes from one `torch.Generator` on the device seeded with
`TrainerConfig.seed`: the store's init noise first, then the sky
jitter and the split noise of training, so its numbers differ from the JAX
package's by design (parity tests hand the JAX draws to `build_stores` and
to the step).

With `pvg` (a models.pvg.PVGConfig) the trainer trains the Periodic
Vibration Gaussian model instead (models.pvg): one temporal cloud built
as the zero-object scene graph's background (its tau uniform over the
train split's times), the sky of `config.base`, no boxes
(the clip's annotations are not read); its state is the single-cloud
`engine.train_step.TrainState` and its step `engine.train_step.
train_step` (10 Adam leaves), refined with `config.background` and the
position-aware gamma of the train cameras' extent. Everything around the
step is the scene graph's: the datamanager, the sampler, the refine
cadence, the pair presize and capacity checks, checkpoints and eval.

With `deform4d` (a models.deform4d.Deform4DConfig) it trains 4D Gaussian
Splatting the same way: the zero-object scene graph's background as the
canonical cloud, the sky, and a fresh deformation field (`TrainState.
field`: its box the seed cloud's bounds, its time span the clip's),
stepped by `engine.train_step.train_step` at each image's time (9 Adam
leaves) and refined with `config.background`, the field left as it is.

With `camera_opt_mode != "off"` each train camera has a (6,) pose delta
(models.camera_opt), trained with gradient accumulation over 100 steps.
With `viewer_port` set, the live viewer (utils.viewer) serves its render
requests on the training thread between steps (`_service_viewer`, which
a multi-process trainer replaces). `render_precision="bf16"`
renders and trains with the bf16-rounded feature columns of the JAX
package's TPU mode (ops.tiles._depth_sort_cols).
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..core.cameras import Camera, viewmat_from_c2w
from ..core.projection import project
from ..data.datamanager import DataManagerConfig, FullImageDatamanager
from ..data.dataparser import DataParserConfig, ParsedScene, parse_scene
from ..models import deform4d as deform4d_model
from ..models import pvg as pvg_model
from ..models.camera_opt import CameraOptConfig, init_camera_opt
from ..models.deform4d import Deform4DConfig
from ..models.gaussians import GaussianStore, draw_init_noise, init_gaussians
from ..models.pvg import PVGConfig
from ..models.scene_graph import (SceneGraphConfig, compose, empty_tracks,
                                  forward_scene, init_scene_graph_store)
from ..models.splatfacto import init_env_map
from ..ops.render import RenderConfig
from ..ops.ssim import psnr, ssim
from ..ops.tiles import count_pairs
from ..utils.profiling import span
from ..utils.writer import MetricsWriter
from . import train_step as single_step
from .checkpoints import (checkpoint_extra, latest_checkpoint,
                          restore_checkpoint, save_checkpoint)
from .scene_train_step import (init_scene_train_state, scene_refine_step,
                               scene_train_step)
from .setup import save_run_config

SAMPLER_PREFIX = "dm/"     # checkpoint keys of the datamanager's sampler


@dataclasses.dataclass
class TrainerConfig:
    """The JAX package's TrainerConfig: the same fields and defaults but
    the render route's."""

    max_num_iterations: int = 30000
    steps_per_save: int = 2000
    steps_per_eval_image: int = 500
    steps_per_eval_all_images: int = 30000
    background_capacity: int = 2 ** 20
    object_capacity: int = 2 ** 15
    max_pairs: int = 2 ** 22
    # Pre-size pair/rowrun capacities from an exact counting probe over a
    # few train cameras (ops.tiles.count_pairs): initial capacity =
    # next_pow2(presize_headroom x probed max). False starts at max_pairs.
    presize_pairs: bool = True
    presize_headroom: float = 2.0
    seed: int = 42
    output_dir: Path = Path("outputs/run")
    resume: bool = True
    render_precision: str = "auto"  # "auto" -> "f32" off a TPU
    viewer_port: Optional[int] = None   # live viewer; None = off


def resolve_device(device) -> torch.device:
    """torch.device(device); raises when a CUDA device is asked for and
    there is no card (no silent CPU run)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} asked for, but torch.cuda.is_available() "
            f"is False; pass device='cpu' (--device cpu) to run on the CPU")
    return dev


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


@torch.no_grad()
def scene_pair_counts(store, tracks, camera, config: SceneGraphConfig,
                      tile_size: int = 16):
    """Exact, capacity-free (num_pairs, num_rowruns) for one composed
    scene view (ops.tiles.count_pairs over the compose -> project ->
    inactive-mask pipeline of the train step), as 0-d int64 tensors."""
    flat, active, _ = compose(store, tracks, camera.time, config=config)
    op = torch.sigmoid(flat["opacities"][:, 0])
    opac = torch.where(active, op, torch.zeros_like(op))
    proj = project(flat["means"], torch.exp(flat["scales"]), flat["quats"],
                   viewmat_from_c2w(camera.c2w), camera.fx, camera.fy,
                   camera.cx, camera.cy, camera.width, camera.height,
                   tile_size=tile_size, opacities=opac, active=active)
    return count_pairs(proj, camera.width, camera.height, tile_size,
                       opacities=opac)


def _init_count(n_points: Optional[int], capacity: int,
                num_random: int) -> int:
    """Gaussians init_gaussians fills for a seed cloud of n_points (None:
    a random cloud of num_random)."""
    return min(n_points if n_points is not None else num_random, capacity)


def draw_store_noise(scene: ParsedScene, config: SceneGraphConfig,
                     trainer: TrainerConfig, generator: torch.Generator,
                     device="cuda", temporal: bool = False) -> dict:
    """The uniform draws of build_stores from `generator`: {"bg": ...,
    "obj": [one per tracked object]}, each models.gaussians.
    draw_init_noise's dict (a temporal background's with "tau")."""
    bgc = config.background
    n_bg = _init_count(
        None if bgc.random_init or scene.points_xyz is None
        else len(scene.points_xyz),
        trainer.background_capacity, bgc.num_random)
    bg = draw_init_noise(n_bg, generator, device, temporal=temporal)
    db = scene.annotations
    obj = []
    if db is not None:
        for gid in db.track_ids:
            n = _init_count(len(db.seed_points[gid][0]),
                            trainer.object_capacity, 0)
            obj.append(draw_init_noise(n, generator, device))
    return {"bg": bg, "obj": obj}


def build_stores(scene: ParsedScene, config: SceneGraphConfig,
                 trainer: TrainerConfig, noise: dict, device="cuda",
                 temporal: Optional[tuple] = None):
    """Background store from the SfM/LiDAR seeds, stacked object stores
    from each track's aggregated LiDAR (scene_graph populate_modules
    :49-96), and the tracks. `noise`: see draw_store_noise. `temporal`:
    (t0, t1, lifespan) of a temporal background (models.gaussians.
    init_gaussians)."""
    bgc = config.background
    bg = init_gaussians(
        trainer.background_capacity,
        scene.points_xyz if not bgc.random_init else None,
        scene.points_rgb if not bgc.random_init else None,
        sh_degree=config.base.sh_degree,
        fourier_dim=bgc.fourier_features_dim,
        num_random=bgc.num_random, random_scale=bgc.random_scale,
        noise=noise["bg"], temporal=temporal, device=device)

    db = scene.annotations
    if db is None or db.num_objects == 0:
        # The zero-object scene graph: an empty leading object axis.
        obj = _map_store(bg, lambda x: x[None][:0])
        tracks = (scene.tracks if scene.tracks is not None
                  else empty_tracks(device=device))
        return bg, obj, tracks

    stores = []
    for i, gid in enumerate(db.track_ids):
        xyz, rgb = db.seed_points[gid]
        stores.append(init_gaussians(
            trainer.object_capacity, xyz, rgb,
            sh_degree=config.base.sh_degree,
            fourier_dim=config.object_template.fourier_features_dim,
            noise=noise["obj"][i], device=device))
    return bg, _stack_stores(stores), scene.tracks


def _map_store(store: GaussianStore, fn) -> GaussianStore:
    return GaussianStore(
        params=dataclasses.replace(store.params, **{
            k: fn(v) for k, v in store.params.as_dict().items()}),
        active=fn(store.active), xys_grad_norm=fn(store.xys_grad_norm),
        vis_counts=fn(store.vis_counts), max_2dsize=fn(store.max_2dsize))


def attach_viewer(trainer: "Trainer", port: int, host: str = "0.0.0.0"):
    """Start the live HTTP viewer (utils.viewer) seeded from the first
    train camera; port 0 takes a free one (ViewerServer.port)."""
    from ..utils.viewer import ViewerServer

    server = ViewerServer(port=port, host=host)
    scene = trainer.scene
    i0 = int(scene.train_indices[0]) if len(scene.train_indices) else 0
    server.set_init(scene.c2w[i0], float(scene.times[i0]),
                    extras={"frames": int(scene.num_frames)})
    return server


def _stack_stores(stores) -> GaussianStore:
    """Stores -> one store with a leading (O,) axis on every leaf."""
    first = stores[0]
    params = {k: torch.stack([s.params.as_dict()[k] for s in stores])
              for k in first.params.as_dict()}
    return GaussianStore(
        params=dataclasses.replace(first.params, **params),
        **{k: torch.stack([getattr(s, k) for s in stores])
           for k in ("active", "xys_grad_norm", "vis_counts", "max_2dsize")})


class Trainer:
    # A trainer that is one rank of several (parallel.trainer) sets these
    # before __init__: only the primary writes the run directory and
    # serves the viewer; the others log into <output_dir>/<log_dir_name>/.
    primary = True
    log_dir_name = ""

    def __init__(
        self,
        data_config: DataParserConfig,
        scene_config: SceneGraphConfig = SceneGraphConfig(),
        trainer_config: TrainerConfig = TrainerConfig(),
        dm_config: DataManagerConfig = DataManagerConfig(),
        device="cuda",
        pvg: Optional[PVGConfig] = None,
        deform4d: Optional[Deform4DConfig] = None,
    ):
        self.device = resolve_device(device)
        # The PVG model's or the 4DGS model's config, None for the scene
        # graph; either trains one cloud (`single_cloud`).
        self.pvg = pvg
        self.deform4d = deform4d
        if pvg is not None and deform4d is not None:
            raise ValueError("one model at a time: pvg or deform4d")
        if self.single_cloud and scene_config.camera_opt_mode != "off":
            raise ValueError("the camera optimizer trains with the scene "
                             "graph only")
        precision = trainer_config.render_precision
        if precision == "auto":
            precision = "f32"
        self.data_config = data_config
        self.config = scene_config
        self.tc = trainer_config
        # Host seconds of each construction stage (read by chip_smoke.py).
        self.setup_seconds = {}
        out = Path(trainer_config.output_dir)
        self.writer = MetricsWriter(out if self.primary
                                    else out / self.log_dir_name)
        if self.primary:
            save_run_config(out, data_config, scene_config, trainer_config,
                            dm_config, pvg=pvg, deform4d=deform4d)

        self.writer.log(f"parsing scene {data_config.data}")
        with self._timed("parse"):
            self.scene = parse_scene(data_config, device=self.device)
        with self._timed("frame_cache"):
            self.dm = FullImageDatamanager(self.scene, dm_config,
                                           device=self.device)
        n_obj = (0 if self.scene.annotations is None or self.single_cloud
                 else self.scene.annotations.num_objects)
        self.writer.log(f"{self.dm.num_train} train / {self.dm.num_eval} "
                        f"eval frames, {n_obj} objects")

        with self._timed("build_stores"):
            generator = torch.Generator(device=self.device)
            generator.manual_seed(trainer_config.seed)
            self._cam_row = {}
            if self.pvg is not None:
                self.state, self.tracks = self._build_pvg(generator)
            elif self.deform4d is not None:
                self.state, self.tracks = self._build_deform4d(generator)
            else:
                self.state, self.tracks = self._build_scene_graph(generator)
        self.start_step = 0

        self.ckpt_dir = Path(trainer_config.output_dir) / "checkpoints"
        if trainer_config.resume:
            latest = latest_checkpoint(self.ckpt_dir)
            if latest is not None:
                self.state = restore_checkpoint(latest, self.state)
                sampler = checkpoint_extra(latest, SAMPLER_PREFIX)
                if sampler:
                    self.dm.set_sampler_state(sampler)
                self.start_step = self.state.step
                self.writer.log(f"resumed from {latest} @ {self.start_step}")

        self.render_config = RenderConfig(max_pairs=trainer_config.max_pairs,
                                          precision=precision)
        if trainer_config.presize_pairs:
            with self._timed("presize"):
                self._presize_pairs()
        # Running max of the pair / row-run counts between the 10-step
        # capacity checks (see _maybe_grow_pairs), kept on the device.
        self._pair_max = None
        self._rowrun_max = None
        self._last_hw = None

        self.viewer = None
        if trainer_config.viewer_port is not None and self.primary:
            self.viewer = attach_viewer(self, trainer_config.viewer_port)
            self.writer.log(f"viewer: http://localhost:{self.viewer.port}/")

    def _build_scene_graph(self, generator: torch.Generator):
        """The scene graph's train state and tracks: the stores from the
        clip's seeds and annotations, the camera optimizer's deltas."""
        cfg, tc = self.config, self.tc
        noise = draw_store_noise(self.scene, cfg, tc, generator, self.device)
        bg, obj, tracks = build_stores(self.scene, cfg, tc, noise,
                                       self.device)
        store = init_scene_graph_store(bg, obj, tracks, cfg, self.device)
        # The camera optimizer: one (6,) delta per train camera.
        camera_opt = None
        if cfg.camera_opt_mode != "off":
            camera_opt = init_camera_opt(CameraOptConfig(
                mode=cfg.camera_opt_mode,
                num_cameras=max(self.dm.num_train, 1)), self.device)
            self._cam_row = {int(g): i for i, g in
                             enumerate(self.scene.train_indices)}
        return (init_scene_train_state(store, generator,
                                       camera_opt=camera_opt), tracks)

    def _build_pvg(self, generator: torch.Generator):
        """PVG's train state: the zero-object scene graph's background made
        temporal (life peaks uniform over the train split's times, every
        lifespan that span), the sky; and the train cameras' extent for the
        position-aware densification."""
        scene = dataclasses.replace(self.scene, annotations=None, tracks=None)
        cfg, tc = self.config, self.tc
        idx = np.asarray(scene.train_indices, np.int64)
        times = scene.times[idx] if len(idx) else np.zeros(1, np.float32)
        t0, t1 = float(times.min()), float(times.max())
        life = max(t1 - t0, 1e-3)
        noise = draw_store_noise(scene, cfg, tc, generator, self.device,
                                 temporal=True)
        bg, _, tracks = build_stores(scene, cfg, tc, noise, self.device,
                                     temporal=(t0, t1, life))
        env = (init_env_map(cfg.base, self.device)
               if cfg.base.use_sky_sphere else None)
        centre, radius = pvg_model.scene_extent(
            scene.c2w[idx][:, :3, 3] if len(idx) else np.zeros((1, 3)))
        # On the device once: a copy from the host at each refine would
        # wait for the card.
        self._extent = (torch.as_tensor(centre, device=self.device), radius)
        return single_step.init_train_state(bg, env, generator), tracks

    def _build_deform4d(self, generator: torch.Generator):
        """4DGS's train state: the zero-object scene graph's background as
        the canonical cloud, the sky, and a fresh deformation field whose
        box is the seed cloud's bounds and whose time span is the clip's
        (models.deform4d.init_field, drawn after the cloud's noise)."""
        scene = dataclasses.replace(self.scene, annotations=None, tracks=None)
        cfg, tc = self.config, self.tc
        noise = draw_store_noise(scene, cfg, tc, generator, self.device)
        bg, _, tracks = build_stores(scene, cfg, tc, noise, self.device)
        env = (init_env_map(cfg.base, self.device)
               if cfg.base.use_sky_sphere else None)
        seeds = bg.params.means[bg.active]
        lo, hi = ((seeds.amin(0), seeds.amax(0)) if len(seeds) else
                  (-torch.ones(3, device=self.device),
                   torch.ones(3, device=self.device)))
        aabb = torch.stack([lo, torch.maximum(hi, lo + 1e-3)])
        times = np.asarray(scene.times, np.float32)
        t0 = float(times.min()) if len(times) else 0.0
        t1 = float(times.max()) if len(times) else t0
        t1 = t1 if t1 > t0 else t0 + 1.0     # one time: any span maps it
        field = deform4d_model.init_field(self.deform4d, aabb, [t0, t1],
                                          generator, self.device)
        return single_step.init_train_state(bg, env, generator,
                                            field=field), tracks

    @property
    def single_cloud(self) -> bool:
        """Whether the trainer trains one cloud (PVG, 4DGS) through
        engine.train_step rather than the scene graph."""
        return self.pvg is not None or self.deform4d is not None

    @contextlib.contextmanager
    def _timed(self, name: str):
        """Host seconds of a construction stage, the device's work
        included, into setup_seconds[name]."""
        t0 = time.perf_counter()
        yield
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.setup_seconds[name] = time.perf_counter() - t0

    def _presize_pairs(self):
        """Exact pair / row-run counts for a spread of train cameras
        (scene_pair_counts, no pair-shaped buffers), then max_pairs /
        max_rowruns = next_pow2(headroom x probed max). Growth past that
        rides _maybe_grow_pairs' doubling. The cameras come from the
        fixed train indices: the probe consumes no epoch samples."""
        n = self.dm.num_train
        if n == 0:
            return
        idxs = list(range(0, n, max(n // 4, 1)))
        max_p, max_r = 0, 0
        for i in idxs:
            p, r = self._pair_counts(self.dm.train_camera(i))
            max_p = max(max_p, int(p))
            max_r = max(max_r, int(r))
        if max_p == 0:
            return
        head = self.tc.presize_headroom
        new_cap = _next_pow2(max(int(max_p * head), 1024))
        new_rcap = max(_next_pow2(max(int(max_r * head), 512)), new_cap // 4)
        self.render_config = dataclasses.replace(
            self.render_config, max_pairs=new_cap, max_rowruns=new_rcap)
        self.writer.log(
            f"pre-sized pair capacity: probed {max_p} pairs / {max_r} "
            f"rowruns over {len(idxs)} cameras -> max_pairs={new_cap}, "
            f"max_rowruns={new_rcap}")

    def _pair_counts(self, camera):
        """Exact (num_pairs, num_rowruns) of the state's view of camera."""
        tile = self.render_config.tile_size
        if self.pvg is not None:
            return pvg_model.pair_counts(self.state.store, camera, self.pvg,
                                         tile)
        if self.deform4d is not None:
            return deform4d_model.pair_counts(
                self.state.store, self.state.field, camera, self.state.step,
                self.deform4d, tile)
        return scene_pair_counts(self.state.store, self.tracks, camera,
                                 self.config, tile)

    def _step_fn(self, step: int):
        """The step for this step number. The entropy loss (and with it
        the object / background accumulation renders) is live only past
        the background's stop_split_at: before it the step renders once
        (subset_accs=False) instead of three times."""
        subset_accs = (self.config.object_acc_entropy_loss_mult > 0
                       and step > self.config.background.stop_split_at)
        return functools.partial(scene_train_step, config=self.config,
                                 render_config=self.render_config,
                                 subset_accs=subset_accs)

    def _device_batch(self, batch):
        """The step's target on the device: each image copied from pageable
        host memory, which waits for the card."""
        out = {}
        for k in ("image", "mask", "semantic"):
            if k in batch:
                with span("trainer.target_copy", sync=True):
                    out[k] = torch.as_tensor(batch[k]).to(self.device)
        return out

    def _maybe_grow_pairs(self, metrics) -> bool:
        """Pair-capacity schedule: when the running max of the true pair
        count OR of the true row-run count since the last check passes
        0.9 of its capacity, double that capacity until it fits (gsplat
        never drops pairs, so neither may we). Both counts are
        capacity-independent, so overflow is seen in the step it happens
        (rasterize also warns then). Returns True if capacity grew."""
        m = _scalars({  # both counts in one read from the device
            "num_pairs": (self._pair_max if self._pair_max is not None
                          else metrics.get("num_pairs", 0)),
            "num_rowruns": (self._rowrun_max if self._rowrun_max is not None
                            else metrics.get("num_rowruns", 0))})
        num_pairs, num_rowruns = int(m["num_pairs"]), int(m["num_rowruns"])
        self._pair_max = None
        self._rowrun_max = None
        cap = self.render_config.max_pairs
        rcap = self.render_config.max_rowruns or cap // 2
        if num_pairs <= 0.9 * cap and num_rowruns <= 0.9 * rcap:
            return False
        new_cap = cap
        while num_pairs > 0.9 * new_cap:
            new_cap *= 2
        new_rcap = rcap
        while num_rowruns > 0.9 * new_rcap:
            new_rcap *= 2
        new_rcap = max(new_rcap, new_cap // 2)
        self.render_config = dataclasses.replace(
            self.render_config, max_pairs=new_cap, max_rowruns=new_rcap)
        self.writer.log(
            f"pair capacity grown {cap} -> {new_cap} "
            f"(step saw {num_pairs} pairs)")
        return True

    def _run_step(self, step: int):
        """One training step: fetch data, run the step."""
        with span("trainer.draw"):
            camera, batch = self.dm.next_train(step)
        target = self._device_batch(batch)
        self._last_hw = (camera.height, camera.width)
        if self.single_cloud:
            self.state, metrics = single_step.train_step(
                self.state, camera, target, self.config.base,
                self.render_config, pvg=self.pvg, deform4d=self.deform4d)
            return metrics
        fn = self._step_fn(step)
        kw = {}
        if self.state.camera_opt is not None:
            kw["camera_index"] = self._cam_row.get(
                batch.get("frame_idx", -1), 0)
        self.state, metrics = fn(self.state, self.tracks, camera, target,
                                 **kw)
        return metrics

    def _track_max(self, metrics):
        if "num_pairs" in metrics:
            self._pair_max = (metrics["num_pairs"] if self._pair_max is None
                              else torch.maximum(self._pair_max,
                                                 metrics["num_pairs"]))
        if "num_rowruns" in metrics:
            self._rowrun_max = (
                metrics["num_rowruns"] if self._rowrun_max is None
                else torch.maximum(self._rowrun_max, metrics["num_rowruns"]))

    def _iteration(self, step: int):
        """One iteration of the loop: the train step, the running max of
        the pair counts, the refine pass after every refine_every-th step
        and, every 10 steps, the capacity check. Returns the step's
        metrics, the refine's counts merged in.

        The refine follows step s when s % refine_every == 0, and refines
        at s (scene_refine_step reads state.step - 1), as the reference's
        callback runs after iteration s at step s. The JAX loop refines
        after (s + 1) % refine_every == 0 at s, so its s % reset_interval
        never equals refine_every and its opacity reset never fires
        (ROADMAP, defects of the reference)."""
        metrics = self._run_step(step)
        self._track_max(metrics)
        if step % self.config.background.refine_every == 0:
            with span("trainer.refine"):
                self.state, info = self._refine(max(*self._last_hw))
            metrics.update(info)
        if step % 10 == 0:
            with span("trainer.capacity_check", sync=True):
                self._maybe_grow_pairs(metrics)
        return metrics

    def train(self, num_iterations: Optional[int] = None):
        total = num_iterations or self.tc.max_num_iterations
        t_last = time.time()
        for step in range(self.start_step, total):
            metrics = self._iteration(step)
            if step % 10 == 0:
                with span("trainer.log_scalars", sync=True):
                    m = _scalars(metrics)
                dt = time.time() - t_last
                t_last = time.time()
                m["steps_per_sec"] = (10 if step else 1) / max(dt, 1e-9)
                self.writer.write(step, m)
                if self.viewer is not None:
                    self.viewer.update_stats(step=step, **{
                        k: m[k] for k in ("loss", "psnr", "gaussian_count",
                                          "steps_per_sec") if k in m})
                if step % 100 == 0:
                    self.writer.log(
                        f"step {step}: loss={m.get('loss', 0):.4f} "
                        f"psnr={m.get('psnr', 0):.2f} "
                        f"N={int(m.get('gaussian_count', 0))} "
                        f"({m['steps_per_sec']:.2f} it/s)")
            # Viewer renders run on this thread, between steps: they
            # serialize with training on one stream, never race it.
            self._service_viewer()
            if (step + 1) % self.tc.steps_per_eval_image == 0:
                self.eval_image(step)
            if ((step + 1) % self.tc.steps_per_eval_all_images == 0
                    or step + 1 == total):
                self.eval_all_images(step)
            if (step + 1) % self.tc.steps_per_save == 0 or step + 1 == total:
                path = self.save(step + 1)
                self.writer.log(f"saved {path}")
        return self.state

    def _refine(self, max_hw: int):
        if self.single_cloud:
            scale = (pvg_model.densify_scale(self.state.store.params.means,
                                             *self._extent)
                     if self.pvg is not None else None)
            return single_step.refine_step(
                self.state, self.config.background, self.dm.num_train,
                max_hw, densify_scale=scale)
        return scene_refine_step(self.state, self.config, self.dm.num_train,
                                 max_hw)

    def full_state(self):
        """The whole train state (a sharded trainer gathers its shards)."""
        return self.state

    def save(self, step: int) -> Path:
        """Checkpoint the state and the datamanager's sampler."""
        return self._save_state(self.state, step)

    def _save_state(self, state, step: int) -> Path:
        extra = {SAMPLER_PREFIX + k: v
                 for k, v in self.dm.sampler_state().items()}
        return save_checkpoint(self.ckpt_dir, step, state, extra=extra)

    def viewer_camera(self, c2w, t: float, width: int, height: int):
        """A viewer camera: train camera 0's intrinsics scaled to
        width x height, at pose c2w ((3, 4) OpenGL) and time t."""
        scene = self.scene
        i0 = int(scene.train_indices[0]) if len(scene.train_indices) else 0
        sx = width / float(scene.width[i0])
        sy = height / float(scene.height[i0])
        return Camera.make(scene.fx[i0] * sx, scene.fy[i0] * sy,
                           scene.cx[i0] * sx, scene.cy[i0] * sy,
                           np.asarray(c2w, np.float32), width, height,
                           time=t, device=self.device)

    def _service_viewer(self) -> bool:
        """The loop's hand-off after every step: answer the viewer's
        parked request, if any (a multi-process trainer overrides it).
        Returns whether a request was answered."""
        if self.viewer is None:
            return False
        return self.viewer.service(self._viewer_render)

    @torch.no_grad()
    def render_view(self, camera, state=None, eval_extras: bool = False):
        """The eval render of `state` (the whole state when None) at
        camera, at the trainer's render config: forward_scene(training=
        False, eval_extras) for the scene graph, models.pvg.forward for
        PVG and models.deform4d.forward for 4DGS (their heads: rgb,
        accumulation, depth, sky). Returns the outputs dict."""
        state = self.full_state() if state is None else state
        if self.pvg is not None:
            store = state.store
            return pvg_model.forward(
                store.params, store.active, camera, state.step,
                self.config.base, self.pvg, self.render_config,
                env_map=state.env_map, training=False)[0]
        if self.deform4d is not None:
            store = state.store
            return deform4d_model.forward(
                store.params, store.active, state.field, camera, state.step,
                self.config.base, self.deform4d, self.render_config,
                env_map=state.env_map, training=False)[0]
        return forward_scene(state.store, self.tracks, camera, state.step,
                             self.config, self.render_config, training=False,
                             eval_extras=eval_extras)[0]

    def viewer_rgb(self, store, step, c2w, t: float, width: int,
                   height: int) -> torch.Tensor:
        """The float rgb of a viewer frame of `store` (the state's other
        leaves the trainer's): render_view of viewer_camera, clamped to
        [0, 1], (H, W, 3) on the device."""
        state = dataclasses.replace(self.state, store=store, step=step)
        outputs = self.render_view(self.viewer_camera(c2w, t, width, height),
                                   state)
        return torch.clamp(outputs["rgb"], 0.0, 1.0)

    def _viewer_render(self, c2w: np.ndarray, t: float, width: int,
                       height: int) -> np.ndarray:
        """A viewer frame of the whole state: viewer_rgb as uint8 (H, W, 3)
        on the host."""
        state = self.full_state()
        return viewer_uint8(self.viewer_rgb(state.store, state.step, c2w, t,
                                            width, height))

    def _eval_one(self, camera, batch, state=None):
        state = self.full_state() if state is None else state
        with torch.no_grad():
            outputs = self.render_view(camera, state)
            gt = torch.as_tensor(batch["image"]).to(self.device)
            return {k: float(v) for k, v in (
                ("psnr", psnr(outputs["rgb"], gt)),
                ("ssim", ssim(gt, outputs["rgb"])))}

    def eval_image(self, step: int):
        camera, batch = self.dm.next_eval(step)
        if camera is None:
            return {}
        m = self._eval_one(camera, batch)
        self.writer.write(step, m, prefix="eval")
        self.writer.log(f"eval @ {step}: psnr={m['psnr']:.2f} "
                        f"ssim={m['ssim']:.4f}")
        return m

    def eval_all_images(self, step: int):
        """Full eval over the eval split (the reference's
        steps_per_eval_all_images cadence, sgn_config.py:24-27)."""
        if self.dm.num_eval == 0:
            return {}
        state = self.full_state()
        rows = [self._eval_one(camera, batch, state)
                for camera, batch in self.dm.fixed_indices_eval()]
        m = {f"all_{k}": float(np.mean([r[k] for r in rows]))
             for k in rows[0]}
        m["all_images"] = len(rows)
        self.writer.write(step, m, prefix="eval")
        self.writer.log(
            f"full eval @ {step} ({len(rows)} images): "
            f"psnr={m['all_psnr']:.2f} ssim={m['all_ssim']:.4f}")
        return m


def viewer_uint8(rgb: torch.Tensor) -> np.ndarray:
    """A clamped float frame as the viewer's uint8 (H, W, 3) on the host
    (truncated, as the JAX viewer's astype)."""
    return (rgb * 255).to(torch.uint8).cpu().numpy()


def _scalars(metrics: dict) -> dict:
    """The 0-d entries of a step's metrics as floats, read from the device
    in one copy."""
    names = [k for k, v in metrics.items()
             if not isinstance(v, torch.Tensor) or v.dim() == 0]
    tensors = [metrics[k] for k in names if isinstance(metrics[k],
                                                        torch.Tensor)]
    values = iter(torch.stack([t.to(torch.float64) for t in tensors]).tolist()
                  if tensors else [])
    return {k: (next(values) if isinstance(metrics[k], torch.Tensor)
                else float(metrics[k])) for k in names}
