"""Training step of the scene-graph model (counterpart of
street_gaussians_ns_tpu/engine/scene_train_step.py: `SceneTrainState`,
`init_scene_train_state`, `mask_inactive_grads`, `scene_train_step`,
`scene_refine_step`, `_split_opt`).

`scene_train_step`: the camera pose delta (when the camera optimizer is
on) -> compose -> SH colours -> jittered sky -> 1 or 3 renders -> L1 +
SSIM + sky-accumulation + entropy losses -> backward through the fused
rasterizer (kernels E and F) -> per-group Adam over background + objects
+ sky + bbox deltas + camera deltas -> densification statistics.
`scene_refine_step`: one refinement pass of the background and of every
object, each with its own config.

Both are functional: they return a new `SceneTrainState` built from new
tensors and leave the state they were given untouched (only its
`torch.Generator` advances when a step draws from it). The step counter
is a host int.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from ..core.cameras import Camera, draw_pixel_jitter
from ..models import refinement
from ..models.camera_opt import CameraOptConfig, apply_camera_opt
from ..models.gaussians import GaussianParams, GaussianStore
from ..models.scene_graph import (ObjectTracks, SceneGraphConfig,
                                  SceneGraphStore, forward_scene,
                                  scene_loss_dict)
from ..ops.render import RenderConfig
from ..ops.ssim import psnr
from ..utils.profiling import span
from .optimizers import (DEFAULT_GROUPS, AdamGroup, AdamState, adam_step,
                         init_adam, mask_rows, schedule, tree_map)
from .train_step import GAUSSIAN_GROUPS

BBOX_PARAMS = ("delta_center", "delta_yaw", "delta_rot")


@dataclasses.dataclass(frozen=True)
class SceneTrainState:
    store: SceneGraphStore
    opt: Dict[str, AdamState]
    step: int
    generator: torch.Generator     # on the store's device; draws the sky
    #                                jitter and the split noise
    # Per-camera pose deltas (num_cameras, 6) when the camera optimizer
    # is on (config.camera_opt_mode != "off"); None otherwise.
    camera_opt: Optional[torch.Tensor] = None


def _gaussian_group_params(store: SceneGraphStore, name: str):
    """Each gaussian group holds one leaf per submodel."""
    return {"bg": getattr(store.background.params, name),
            "obj": getattr(store.objects.params, name)}


def _bbox_params(store: SceneGraphStore):
    return {name: getattr(store, name) for name in BBOX_PARAMS}


def _with_params(store: SceneGraphStore, gauss: Dict, env_map,
                 bbox: Dict) -> SceneGraphStore:
    def sub(part: GaussianStore, key: str) -> GaussianStore:
        return dataclasses.replace(part, params=dataclasses.replace(
            part.params, **{k: v[key] for k, v in gauss.items()}))

    return dataclasses.replace(
        store, background=sub(store.background, "bg"),
        objects=sub(store.objects, "obj"), env_map=env_map, **bbox)


def mask_inactive_grads(g_gauss: Dict, store: SceneGraphStore) -> Dict:
    """Zero the gradient rows of inactive store slots before Adam: they
    hold all-zero parameters, contribute nothing to a render, and a
    degenerate-input gradient must not reach the parameters through
    Adam. (The step itself hands Adam the `active` masks instead:
    `scene_adam`.)"""
    return {name: {"bg": mask_rows(g["bg"], store.background.active),
                   "obj": mask_rows(g["obj"], store.objects.active)}
            for name, g in g_gauss.items()}


def scene_adam(store: SceneGraphStore, opt: Dict[str, AdamState], g_gauss,
               g_env, g_bbox, step: int, camera=(None, None)):
    """The Adam step of a scene-graph state, every group in one pass
    (`adam_step`): the six gaussian groups over the background and the
    objects, their inactive rows masked (`mask_inactive_grads`' rule); the
    sky and the bbox deltas where `opt` holds them; the camera-pose deltas
    where `opt` holds them and `camera` = (their gradient, the deltas) has
    a gradient. Returns (new store, new opt, new camera deltas)."""
    active = {"bg": store.background.active, "obj": store.objects.active}

    def group(name, grads, params, act=None):
        cfg = DEFAULT_GROUPS[name]
        return AdamGroup(grads, opt[name], params, schedule(cfg, step), cfg,
                         act)

    groups = {name: group(name, g_gauss[name],
                          _gaussian_group_params(store, name), active)
              for name in GAUSSIAN_GROUPS}
    if store.env_map is not None and "sky_sphere" in opt:
        groups["sky_sphere"] = group("sky_sphere", g_env, store.env_map)
    if "bbox_opt" in opt:
        groups["bbox_opt"] = group("bbox_opt", g_bbox, _bbox_params(store))
    if camera[0] is not None and "camera_opt" in opt:
        groups["camera_opt"] = group("camera_opt", *camera)
    stepped = adam_step(groups)

    def new(name, old):
        return stepped[name][0] if name in stepped else old

    new_store = _with_params(
        store, {name: stepped[name][0] for name in GAUSSIAN_GROUPS},
        new("sky_sphere", store.env_map),
        new("bbox_opt", _bbox_params(store)))
    new_opt = {**opt, **{name: s for name, (_, s) in stepped.items()}}
    return new_store, new_opt, new("camera_opt", camera[1])


def init_scene_train_state(store: SceneGraphStore,
                           generator: torch.Generator,
                           camera_opt: Optional[torch.Tensor] = None
                           ) -> SceneTrainState:
    opt = {name: init_adam(_gaussian_group_params(store, name))
           for name in GAUSSIAN_GROUPS}
    if store.env_map is not None:
        opt["sky_sphere"] = init_adam(store.env_map)
    if store.delta_center.numel():
        opt["bbox_opt"] = init_adam(_bbox_params(store))
    if camera_opt is not None:
        opt["camera_opt"] = init_adam(
            camera_opt, accum_steps=DEFAULT_GROUPS["camera_opt"].accum_steps)
    return SceneTrainState(store=store, opt=opt, step=0,
                           generator=generator, camera_opt=camera_opt)


def scene_loss_and_grads(state: SceneTrainState, tracks: ObjectTracks,
                         camera: Camera, batch: dict,
                         config: SceneGraphConfig,
                         render_config: RenderConfig,
                         subset_accs: bool = True,
                         jitter: Optional[torch.Tensor] = None,
                         camera_index=None):
    """The forward and backward of one step. Returns (total loss, losses,
    outputs, RenderOutputs of the full render, grads) with grads =
    {"gauss": {group: {"bg", "obj"}}, "env_map", "bbox": {...}, "xys":
    (N_flat, 2) the screen-space positional gradients, "camera_opt": the
    (num_cameras, 6) pose-delta gradient or None when the camera optimizer
    is off}; a parameter the loss does not reach gets zeros.

    With the camera optimizer on, row `camera_index` (0 when None) of
    state.camera_opt is composed with camera.c2w before the render, and
    the pose gradient also flows through the sky rays."""
    store = state.store
    def leaf(x):
        return x.detach().requires_grad_(True)

    with span("step.forward"):
        gauss = {name: tree_map(leaf, _gaussian_group_params(store, name))
                 for name in GAUSSIAN_GROUPS}
        env = leaf(store.env_map) if store.env_map is not None else None
        bbox = tree_map(leaf, _bbox_params(store))
        n_flat = (store.background.active.numel()
                  + store.objects.active.numel())
        xys_zero = torch.zeros((n_flat, 2), dtype=torch.float32,
                               device=store.background.active.device,
                               requires_grad=True)
        use_cam_opt = (state.camera_opt is not None
                       and config.camera_opt_mode != "off")
        cam_opt = None
        if use_cam_opt:
            cam_opt = leaf(state.camera_opt)
            camera = dataclasses.replace(camera, c2w=apply_camera_opt(
                CameraOptConfig(mode=config.camera_opt_mode,
                                num_cameras=cam_opt.shape[0]),
                cam_opt, 0 if camera_index is None else camera_index,
                camera.c2w))

        outputs, rout, _ = forward_scene(
            _with_params(store, gauss, env, bbox), tracks, camera, state.step,
            config, render_config, training=True, subset_accs=subset_accs,
            jitter=jitter, xys_offset=xys_zero, sky_dirs_grad=use_cam_opt)
        losses = scene_loss_dict(outputs, batch, config, state.step)
        total = sum(losses.values())

        leaves = [gauss[n][k] for n in GAUSSIAN_GROUPS for k in ("bg", "obj")]
        leaves += [bbox[n] for n in BBOX_PARAMS] + [xys_zero]
        if env is not None:
            leaves.append(env)
        if cam_opt is not None:
            leaves.append(cam_opt)
    with span("step.backward"):
        raw = torch.autograd.grad(total, leaves, allow_unused=True)
        got = [torch.zeros_like(p) if g is None else g
               for p, g in zip(leaves, raw)]
    it = iter(got)
    grads = {"gauss": {n: {"bg": next(it), "obj": next(it)}
                       for n in GAUSSIAN_GROUPS},
             "bbox": {n: next(it) for n in BBOX_PARAMS},
             "xys": next(it),
             "env_map": next(it) if env is not None else None,
             "camera_opt": next(it) if cam_opt is not None else None}
    detach = lambda t: t.detach()  # noqa: E731
    return (total.detach(), tree_map(detach, losses),
            tree_map(detach, outputs), rout, grads)


def scene_train_step(state: SceneTrainState, tracks: ObjectTracks,
                     camera: Camera, batch: dict, config: SceneGraphConfig,
                     render_config: RenderConfig, subset_accs: bool = True,
                     jitter: Optional[torch.Tensor] = None,
                     camera_index=None):
    """One scene-graph optimization step. Returns (new_state, metrics).

    batch: {"image" (H, W, 3), optional "mask", optional "semantic"}.
    subset_accs=False drops the object / background accumulation renders,
    which only the entropy loss past stop_split_at reads. `jitter`
    ((2, H, W)) is the sky rays' jitter; when None it is drawn from the
    state's generator. `camera_index` selects this step's row of the
    camera-pose deltas when the camera optimizer is on; their gradients
    accumulate over DEFAULT_GROUPS["camera_opt"].accum_steps calls."""
    store = state.store
    if jitter is None and store.env_map is not None:
        jitter = draw_pixel_jitter(camera, state.generator)
    total, losses, outputs, rout, grads = scene_loss_and_grads(
        state, tracks, camera, batch, config, render_config,
        subset_accs=subset_accs, jitter=jitter, camera_index=camera_index)
    cap_bg = store.background.capacity
    n_obj = store.num_objects
    step = state.step

    with torch.no_grad(), span("step.adam"):
        new_store, new_opt, new_cam_opt = scene_adam(
            store, state.opt, grads["gauss"], grads["env_map"],
            grads["bbox"], step, (grads["camera_opt"], state.camera_opt))

    with torch.no_grad(), span("step.stats"):
        # Densification statistics per submodel, by slicing the flat
        # buffers of the full render.
        max_hw = max(camera.height, camera.width)
        radii = rout.projected.radii
        g_xys = grads["xys"]
        bg_store = refinement.update_stats(
            new_store.background, g_xys[:cap_bg], radii[:cap_bg], max_hw,
            step, config.background)
        obj_store = new_store.objects
        if n_obj:
            obj_store = refinement.update_stats(
                obj_store, g_xys[cap_bg:].reshape(n_obj, -1, 2),
                radii[cap_bg:].reshape(n_obj, -1), max_hw, step,
                config.object_template)
        new_store = dataclasses.replace(new_store, background=bg_store,
                                        objects=obj_store)

        bg_act = bg_store.active
        n_act = torch.clamp(bg_act.sum(), min=1)
        bg_p = bg_store.params
        zero = torch.zeros((), dtype=torch.float32, device=bg_act.device)
        metrics = {
            "loss": total,
            "psnr": psnr(outputs["rgb"], batch["image"]),
            "gaussian_count": (bg_store.num_active
                               + (obj_store.num_active if n_obj else 0)),
            "scale_mean": torch.where(bg_act[:, None], torch.exp(bg_p.scales),
                                      zero).sum() / (3 * n_act),
            "log_scale_mean": torch.where(bg_act[:, None], bg_p.scales,
                                          zero).sum() / (3 * n_act),
            "sigmoid_opacity": torch.where(
                bg_act, torch.sigmoid(bg_p.opacities[:, 0]),
                zero).sum() / n_act,
            "radii_mean": radii.to(torch.float32).mean(),
            # The true (pre-capacity) counts: a trainer grows max_pairs
            # from them before any pair is dropped.
            "num_pairs": rout.bins.num_pairs,
            "num_rowruns": rout.bins.num_rowruns,
            "max_tile_count": rout.bins.max_tile_count,
            **losses,
        }
    return dataclasses.replace(state, store=new_store, opt=new_opt,
                               step=step + 1, camera_opt=new_cam_opt), metrics


def _split_opt(opt: Dict[str, AdamState], key: str) -> Dict[str, AdamState]:
    return {name: AdamState(mu=opt[name].mu[key], nu=opt[name].nu[key],
                            count=opt[name].count)
            for name in GAUSSIAN_GROUPS}


def draw_refine_noise(state: SceneTrainState,
                      config: SceneGraphConfig) -> dict:
    """The split noise of one refinement pass, from the state's
    generator: {"bg": (S, CAPP_bg, 3), "obj": (O, S, CAPP_obj, 3)}."""
    store = state.store
    dev = store.background.active.device
    bg = refinement.draw_split_noise(
        config.background, store.background.capacity, state.generator, dev)
    obj = [refinement.draw_split_noise(
        config.object_template, store.objects.capacity, state.generator, dev)
        for _ in range(store.num_objects)]
    return {"bg": bg, "obj": torch.stack(obj) if obj else None}


def scene_refine_step(state: SceneTrainState, config: SceneGraphConfig,
                      num_train_data: int, max_hw: int,
                      noise: Optional[dict] = None):
    """Refine the background and every object, each submodel with its
    own config, at step `state.step - 1`. Returns (new_state, info).
    `noise`: see draw_refine_noise; drawn from the state's generator when
    None."""
    if noise is None:
        noise = draw_refine_noise(state, config)
    store = state.store
    step = state.step - 1

    bg_store, bg_surgery, bg_info = refinement.refine(
        store.background, step, config.background, num_train_data, max_hw,
        noise["bg"])
    bg_opt = refinement.apply_moment_surgery(_split_opt(state.opt, "bg"),
                                             bg_surgery)

    obj_store = store.objects
    obj_opt = _split_opt(state.opt, "obj")
    obj_info = {}
    n_obj = store.num_objects
    if n_obj:
        def one(o):
            return tree_map(lambda x: x[o], _store_tree(store.objects))

        results = [refinement.refine(
            _store_from_tree(one(o)), step, config.object_template,
            num_train_data, max_hw, noise["obj"][o]) for o in range(n_obj)]
        obj_store = _store_from_tree(tree_map(
            lambda *xs: torch.stack(xs),
            *[_store_tree(r[0]) for r in results]))
        surgery = {"keep": torch.stack([r[1]["keep"] for r in results]),
                   "reset_opacities": results[0][1]["reset_opacities"]}
        obj_opt = refinement.apply_moment_surgery(obj_opt, surgery)
        obj_info = {k: torch.stack([r[2][k] for r in results]).sum()
                    for k in results[0][2]}

    new_opt = dict(state.opt)
    for name in GAUSSIAN_GROUPS:
        new_opt[name] = AdamState(
            mu={"bg": bg_opt[name].mu, "obj": obj_opt[name].mu},
            nu={"bg": bg_opt[name].nu, "obj": obj_opt[name].nu},
            count=state.opt[name].count)
    info = {f"bg_{k}": v for k, v in bg_info.items()}
    info.update({f"obj_{k}": v for k, v in obj_info.items()})
    new_store = dataclasses.replace(store, background=bg_store,
                                    objects=obj_store)
    return dataclasses.replace(state, store=new_store, opt=new_opt), info


def _store_tree(store: GaussianStore) -> dict:
    return {"params": store.params.as_dict(), "active": store.active,
            "xys_grad_norm": store.xys_grad_norm,
            "vis_counts": store.vis_counts, "max_2dsize": store.max_2dsize}


def _store_from_tree(tree: dict) -> GaussianStore:
    return GaussianStore(params=GaussianParams(**tree["params"]),
                         **{k: v for k, v in tree.items() if k != "params"})
