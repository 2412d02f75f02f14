"""Scene-graph model: background Gaussians + per-vehicle rigid-posed
Gaussians + sky cubemap (counterpart of
street_gaussians_ns_tpu/models/scene_graph.py).

The scene is data: a background store plus one object store with a
leading object axis. Boxes are interpolated at the camera time (SLERP /
lerp between tracked frames), the objects are posed into the world and
everything is flattened into one splat set for the renderer.
`forward_scene` renders for evaluation and for training (jittered sky
rays, the screen-space gradient hook, no final clamp) and
`scene_loss_dict` adds the accumulation entropy loss to the base losses.
The bbox optimizer's modes: "off", "simple" (delta center + delta yaw) and
"SO3xR3" / "SE3" (the exp map of a 6-dof tangent, models.camera_opt).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..core import quaternions as quat
from ..core.cameras import Camera
from ..ops.render import RenderConfig, render
from .camera_opt import exp_map_SE3, exp_map_SO3xR3
from .fourier import fourier_dc
from .gaussians import GaussianStore
from .splatfacto import (SplatfactoConfig, init_env_map, loss_dict,
                         sh_colors, sky_color)


@dataclasses.dataclass(frozen=True)
class SceneGraphConfig:
    """Same fields and defaults as the JAX package's SceneGraphConfig."""

    base: SplatfactoConfig = SplatfactoConfig(use_sky_sphere=True,
                                              sh_degree=3)
    background: SplatfactoConfig = SplatfactoConfig(
        cull_alpha_thresh=0.02, cull_scale_thresh=0.2, warmup_length=500,
        refine_every=100, reset_alpha_every=30, stop_split_at=25000,
        fourier_features_dim=1, use_sky_sphere=False)
    object_template: SplatfactoConfig = SplatfactoConfig(
        cull_alpha_thresh=0.005, cull_scale_thresh=0.2,
        densify_grad_thresh=0.0002, warmup_length=500, refine_every=100,
        reset_alpha_every=30, stop_split_at=25000, fourier_features_dim=5,
        num_random=10000, use_sky_sphere=False)
    object_acc_entropy_loss_mult: float = 0.001
    bbox_mode: str = "simple"           # "off" | "simple" | "SO3xR3" | "SE3"
    bbox_differentiable: bool = False
    camera_opt_mode: str = "off"
    num_cameras: int = 0


@dataclasses.dataclass(frozen=True)
class ObjectTracks:
    """Tracked-box database: F annotated frames x O objects."""

    times: torch.Tensor      # (F,) sorted, same clock as Camera.time
    centers: torch.Tensor    # (F, O, 3) world
    quats: torch.Tensor      # (F, O, 4) wxyz object -> world
    valid: torch.Tensor      # (F, O) bool
    sizes: torch.Tensor      # (O, 3)
    obj_first: torch.Tensor  # (O,) first annotated frame index (float)
    obj_last: torch.Tensor   # (O,) last annotated frame index (float)

    @property
    def num_frames(self) -> int:
        return self.times.shape[0]

    @property
    def num_objects(self) -> int:
        return self.centers.shape[1]


def empty_tracks(num_objects: int = 0, num_frames: int = 0,
                 device="cuda") -> ObjectTracks:
    f32 = dict(dtype=torch.float32, device=device)
    return ObjectTracks(
        times=torch.zeros((num_frames,), **f32),
        centers=torch.zeros((num_frames, num_objects, 3), **f32),
        quats=torch.tensor([1.0, 0, 0, 0], **f32).repeat(
            num_frames, num_objects, 1),
        valid=torch.zeros((num_frames, num_objects), dtype=torch.bool,
                          device=device),
        sizes=torch.ones((num_objects, 3), **f32),
        obj_first=torch.zeros((num_objects,), **f32),
        obj_last=torch.ones((num_objects,), **f32),
    )


@dataclasses.dataclass(frozen=True)
class BoxesAtT:
    centers: torch.Tensor   # (O, 3)
    quats: torch.Tensor     # (O, 4) object -> world
    visible: torch.Tensor   # (O,) bool
    t_norm: torch.Tensor    # (O,) normalized track time for the Fourier DC


def interpolate_boxes(tracks: ObjectTracks, t: torch.Tensor,
                      delta_center: Optional[torch.Tensor] = None,
                      delta_yaw: Optional[torch.Tensor] = None,
                      mode: str = "simple",
                      delta_rot: Optional[torch.Tensor] = None,
                      differentiable: bool = False) -> BoxesAtT:
    """Boxes at camera time t: the exact frame when t matches one, else
    SLERP/lerp between the bracketing frames, visible where both are
    valid; none visible outside the tracked time range, or when the
    tracks have no frame at all.

    The bbox optimizer's deltas apply at exact annotated frames only.
    "simple" adds delta_center and post-multiplies a yaw quaternion;
    "SO3xR3" / "SE3" build a correction from the exp map of the tangent
    [delta_center | delta_rot], add its translation to the center (not
    rotated) and premultiply the rotation. Unless `differentiable`, the
    deltas are detached (the reference applies its correction detached,
    so no gradient reaches them)."""
    if mode not in ("off", "simple", "SO3xR3", "SE3"):
        raise ValueError(f"unknown bbox_mode {mode!r}")
    F = tracks.num_frames
    times = tracks.times
    if F == 0:
        # No annotated frame (a clip without tracked objects): no box is
        # visible, so compose renders the background and the sky alone.
        # The JAX package indexes the empty arrays here and raises.
        O = tracks.num_objects
        f32 = dict(dtype=torch.float32, device=times.device)
        return BoxesAtT(
            centers=torch.zeros((O, 3), **f32),
            quats=torch.tensor([1.0, 0.0, 0.0, 0.0], **f32).repeat(O, 1),
            visible=torch.zeros((O,), dtype=torch.bool, device=times.device),
            t_norm=torch.ones((O,), **f32))
    t = torch.as_tensor(t, dtype=torch.float32, device=times.device)
    i1 = torch.clamp(torch.searchsorted(times, t.reshape(1)), 0, F - 1)[0]
    i0 = torch.clamp(i1 - 1, 0, F - 1)
    t0, t1 = times[i0], times[i1]
    exact1 = t == t1
    denom = torch.where(t1 > t0, t1 - t0, torch.ones_like(t1))
    w = torch.where(exact1, torch.ones_like(t),
                    torch.clamp((t - t0) / denom, 0.0, 1.0))
    in_range = (t >= times[0]) & (t <= times[-1])

    c0, c1 = tracks.centers[i0], tracks.centers[i1]
    centers = c0 * (1.0 - w) + c1 * w
    quats = quat.slerp(tracks.quats[i0], tracks.quats[i1], w)
    v0, v1 = tracks.valid[i0], tracks.valid[i1]
    visible = torch.where(w <= 0.0, v0, torch.where(w >= 1.0, v1, v0 & v1))
    visible = visible & in_range

    frame_pos = i0.to(torch.float32) + w
    span = tracks.obj_last - tracks.obj_first
    t_norm = torch.where(
        span > 0, (frame_pos - tracks.obj_first) / torch.clamp(span, min=1e-6),
        torch.ones_like(span))

    if delta_center is not None and mode != "off":
        fi = torch.where(exact1, i1, i0)
        gate = ((exact1 | (w <= 0.0))).to(torch.float32)
        dc = delta_center[fi]
        if not differentiable:
            dc = dc.detach()
        if mode in ("SO3xR3", "SE3") and delta_rot is not None:
            dr = delta_rot[fi]
            if not differentiable:
                dr = dr.detach()
            tangent = torch.cat([dc, dr], dim=-1) * gate[..., None]
            corr = (exp_map_SO3xR3(tangent) if mode == "SO3xR3"
                    else exp_map_SE3(tangent))             # (O, 3, 4)
            centers = centers + corr[..., :3, 3]
            quats = quat.multiply(quat.from_rotmat(corr[..., :3, :3]),
                                  quats)
        else:
            dy = (delta_yaw[fi] if delta_yaw is not None
                  else torch.zeros(centers.shape[:-1], dtype=torch.float32,
                                   device=times.device))
            if not differentiable:
                dy = dy.detach()
            centers = centers + gate[..., None] * dc
            dyaw = dy * gate
            zero = torch.zeros_like(dyaw)
            dq = torch.stack([torch.cos(dyaw), zero, zero, torch.sin(dyaw)],
                             dim=-1)
            quats = quat.multiply(quats, dq)
    return BoxesAtT(centers=centers, quats=quats, visible=visible,
                    t_norm=t_norm)


@dataclasses.dataclass(frozen=True)
class SceneGraphStore:
    background: GaussianStore
    objects: GaussianStore               # leaves have a leading (O,) axis
    env_map: Optional[torch.Tensor]      # (6, R, R, 3) or None
    delta_center: torch.Tensor           # (F, O, 3)
    delta_yaw: torch.Tensor              # (F, O)
    delta_rot: torch.Tensor              # (F, O, 3)

    @property
    def num_objects(self) -> int:
        return self.objects.active.shape[0]


def init_scene_graph_store(background: GaussianStore,
                           object_stores: GaussianStore,
                           tracks: ObjectTracks, config: SceneGraphConfig,
                           device="cuda") -> SceneGraphStore:
    """A scene graph from a background store and the stacked object stores
    (leaves (O, CAP_o, ...)): the sky cubemap at 0.5 when the base config
    has one, and zero bbox-optimizer deltas per (frame, object)."""
    env = (init_env_map(config.base, device)
           if config.base.use_sky_sphere else None)
    F, O = tracks.num_frames, tracks.num_objects
    f32 = dict(dtype=torch.float32, device=device)
    return SceneGraphStore(
        background=background, objects=object_stores, env_map=env,
        delta_center=torch.zeros((F, O, 3), **f32),
        delta_yaw=torch.zeros((F, O), **f32),
        delta_rot=torch.zeros((F, O, 3), **f32))


def object2world(means: torch.Tensor, quats_g: torch.Tensor,
                 boxes: BoxesAtT):
    """Rigid object -> world transform of per-object gaussians (O, C, ...):
    means R^T + t, quaternions premultiplied by the box orientation."""
    R = quat.to_rotmat(quat.normalize(boxes.quats))       # (O, 3, 3)
    means_w = torch.einsum("oij,ocj->oci", R, means) + boxes.centers[:, None]
    quats_w = quat.multiply(boxes.quats[:, None, :], quats_g)
    return means_w, quats_w


def compose(store: SceneGraphStore, tracks: ObjectTracks, time: torch.Tensor,
            config: Optional[SceneGraphConfig] = None):
    """Flatten background + posed objects into one splat set.

    Returns (flat parameter dict, active (N,), boxes); the layout is
    [background (CAP_bg), object 0 (CAP_o), object 1, ...]."""
    bg = store.background
    obj = store.objects
    mode = config.bbox_mode if config is not None else "simple"
    diff = config.bbox_differentiable if config is not None else False
    boxes = interpolate_boxes(
        tracks, time,
        delta_center=store.delta_center if store.delta_center.numel() else None,
        delta_yaw=store.delta_yaw if store.delta_yaw.numel() else None,
        delta_rot=store.delta_rot if store.delta_rot.numel() else None,
        mode=mode, differentiable=diff)
    means_w, quats_w = object2world(obj.params.means, obj.params.quats, boxes)
    dc_obj = fourier_dc(obj.params.features_dc, boxes.t_norm)
    dc_bg = fourier_dc(bg.params.features_dc,
                       torch.zeros((), device=bg.active.device))

    def flat(bg_x, obj_x):
        return torch.cat([bg_x, obj_x.reshape((-1,) + obj_x.shape[2:])], 0)

    flat_params = dict(
        means=flat(bg.params.means, means_w),
        scales=flat(bg.params.scales, obj.params.scales),
        quats=flat(bg.params.quats, quats_w),
        features_dc_t=flat(dc_bg, dc_obj),
        features_rest=flat(bg.params.features_rest, obj.params.features_rest),
        opacities=flat(bg.params.opacities, obj.params.opacities),
    )
    active = flat(bg.active, obj.active & boxes.visible[:, None])
    return flat_params, active, boxes


def forward_scene(store: SceneGraphStore, tracks: ObjectTracks,
                  camera: Camera, step: int, config: SceneGraphConfig,
                  render_config: RenderConfig, training: bool = False,
                  eval_extras: bool = False, subset_accs: bool = True,
                  jitter: Optional[torch.Tensor] = None,
                  xys_offset: Optional[torch.Tensor] = None,
                  sky_dirs_grad: bool = False):
    """Scene-graph render of one camera: compose, render with the sky,
    plus the object-only / background-only renders (accumulations, and
    with eval_extras their rgb and depth). Returns (outputs dict,
    RenderOutputs of the full render, boxes).

    training=True steps the SH degree up with `step`, jitters the sky
    rays by `jitter` ((2, H, W), core.cameras.draw_pixel_jitter; pixel
    centers when None) and leaves rgb unclamped below. `xys_offset`
    ((N, 2) over the flat splat set) is the screen-space gradient hook of
    ops.render.render. subset_accs=False skips the two subset renders
    (the entropy loss that reads them is off until the background's
    stop_split_at). `config.camera_opt_mode` does not change this
    function: a trainer applies the camera delta to `camera` before it
    calls it; sky_dirs_grad=True lets the pose gradient through the sky
    rays (ops.cubemap.sample_cubemap)."""
    flat, active, boxes = compose(store, tracks, camera.time, config=config)
    cap_bg = store.background.capacity

    rgbs = sh_colors(flat["means"], flat["features_dc_t"],
                     flat["features_rest"], camera, step, config.base,
                     training=training)
    op = torch.sigmoid(flat["opacities"][:, 0])
    opac = torch.where(active, op, torch.zeros_like(op))
    scales = torch.exp(flat["scales"])
    sky = None
    if store.env_map is not None:
        sky = sky_color(store.env_map, camera,
                        jitter if training else None,
                        dirs_grad=sky_dirs_grad)

    out = render(flat["means"], scales, flat["quats"], opac, rgbs, camera,
                 render_config, sky_rgb=sky, training=training,
                 active=active, xys_offset=xys_offset)
    outputs = {"rgb": out.rgb, "accumulation": out.accumulation,
               "depth": out.depth}
    if sky is not None:
        outputs["sky"] = sky

    if subset_accs or eval_extras:
        seg_obj = torch.arange(active.shape[0], device=active.device) >= cap_bg
        out_obj = render(flat["means"], scales, flat["quats"], opac, rgbs,
                         camera, render_config, training=training,
                         active=active & seg_obj)
        out_bg = render(flat["means"], scales, flat["quats"], opac, rgbs,
                        camera, render_config, training=training,
                        active=active & ~seg_obj)
        outputs["object_acc"] = out_obj.accumulation
        outputs["background_acc"] = out_bg.accumulation

    if eval_extras:
        bg_rgb = torch.clamp(out_bg.rgb, max=1.0)
        if sky is not None:
            bg_rgb = (bg_rgb * out_bg.accumulation
                      + sky * (1 - out_bg.accumulation))
        outputs["background_rgb"] = torch.clamp(bg_rgb, 0.0, 1.0)
        outputs["object_rgb"] = torch.clamp(out_obj.rgb, 0.0, 1.0)
        outputs["background_depth"] = out_bg.depth
        outputs["object_depth"] = out_obj.depth
    return outputs, out, boxes


def scene_loss_dict(outputs: dict, batch: dict, config: SceneGraphConfig,
                    step: int, ssim_fn=None) -> dict:
    """The base L1 + SSIM + sky losses plus the object accumulation
    entropy loss, which is live past the background's stop_split_at (and
    only when the outputs carry "object_acc"). ssim_fn: see
    models.splatfacto.loss_dict."""
    losses = loss_dict(outputs, batch, config.base, ssim_fn=ssim_fn)
    if config.object_acc_entropy_loss_mult > 0 and "object_acc" in outputs:
        acc = torch.clamp(outputs["object_acc"], 1e-5, 1.0 - 1e-5)
        ent = -(acc * torch.log(acc) + (1 - acc) * torch.log(1 - acc))
        gate = 1.0 if int(step) > config.background.stop_split_at else 0.0
        losses["object_acc_entropy_loss"] = (
            config.object_acc_entropy_loss_mult * gate * torch.mean(ent))
    return losses
