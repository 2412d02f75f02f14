"""Training step of the single-model (Splatfacto) pipeline (counterpart of
street_gaussians_ns_tpu/engine/train_step.py: `GAUSSIAN_GROUPS`,
`TrainState`, `init_train_state`, `train_step`, `refine_step`).

`train_step`: forward render -> L1 + SSIM + sky losses -> backward through
the fused rasterizer (with the screen-space xys gradient hook) -> 7
per-group Adam updates -> densification statistics. `refine_step`: one
refinement pass, called every refine_every steps by a host loop after
`train_step` has advanced the step.

The same pipeline trains the Periodic Vibration Gaussian model
(models.pvg): a temporal store's three more leaves are three more Adam
groups (10 leaves a step with the sky), and with `pvg` given the forward
is models.pvg.forward at the camera's time. It also trains 4D Gaussian
Splatting (models.deform4d): a plain store and the deformation field
(`TrainState.field`), whose planes and decoder are two more Adam groups
(9 leaves a step with the sky); with `deform4d` given the forward is
models.deform4d.forward and, once the field is live, the loss adds its
plane regularisers. A refine carries the store's leaves and leaves the
field as it is.

Both are functional, as engine.scene_train_step's: they return a new
`TrainState` and leave the one they were given untouched (only its
`torch.Generator` advances when a step draws from it). The scene-graph
variant lives in engine.scene_train_step.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from ..core.cameras import Camera, draw_pixel_jitter
from ..models import deform4d as deform4d_model
from ..models import pvg as pvg_model
from ..models import refinement
from ..models.deform4d import FIELD_GROUPS, Deform4DConfig
from ..models.gaussians import GaussianStore
from ..models.pvg import PVGConfig
from ..models.splatfacto import SplatfactoConfig, forward, loss_dict
from ..ops.render import RenderConfig
from ..ops.ssim import psnr
from ..utils.profiling import span
from .optimizers import (DEFAULT_GROUPS, DEFORM4D_GROUPS, PVG_GROUPS,
                         AdamGroup, AdamState, adam_step, init_adam,
                         schedule, tree_map)

GAUSSIAN_GROUPS = ("means", "scales", "quats", "features_dc",
                   "features_rest", "opacities")


def store_groups(store: GaussianStore) -> tuple:
    """The Adam groups of a store's leaves: GAUSSIAN_GROUPS, and a
    temporal store's tau, s_beta and velocity after them."""
    return tuple(store.params.as_dict())


def group_config(name: str):
    """A group's AdamConfig: the reference's registry, PVG's or the 4DGS
    field's."""
    return {**DEFAULT_GROUPS, **PVG_GROUPS, **DEFORM4D_GROUPS}[name]


def field_group(leaf: str) -> str:
    """The Adam group of a field leaf ("planes" -> "field_planes")."""
    return "field_" + leaf


@dataclasses.dataclass(frozen=True)
class TrainState:
    store: GaussianStore
    env_map: Optional[torch.Tensor]
    opt: Dict[str, AdamState]      # per-group Adam states
    step: int
    generator: torch.Generator     # on the store's device; draws the sky
    #                                jitter and the split noise
    # The 4DGS deformation field (models.deform4d: "planes", "decoder",
    # "aabb", "time_span"), None for the other models.
    field: Optional[dict] = None


def init_train_state(store: GaussianStore, env_map: Optional[torch.Tensor],
                     generator: torch.Generator,
                     field: Optional[dict] = None) -> TrainState:
    opt = {name: init_adam(getattr(store.params, name))
           for name in store_groups(store)}
    if env_map is not None:
        opt["sky_sphere"] = init_adam(env_map)
    if field is not None:
        opt.update({field_group(k): init_adam(field[k])
                    for k in FIELD_GROUPS})
    return TrainState(store=store, env_map=env_map, opt=opt, step=0,
                      generator=generator, field=field)


def loss_and_grads(state: TrainState, camera: Camera, batch: dict,
                   config: SplatfactoConfig, render_config: RenderConfig,
                   jitter: Optional[torch.Tensor] = None,
                   pvg: Optional[PVGConfig] = None,
                   deform4d: Optional[Deform4DConfig] = None):
    """The forward and backward of one step. Returns (total loss, losses,
    outputs, RenderOutputs, grads) with grads = {"params": {group: g},
    "env_map": g or None, "xys": (CAP, 2) the screen-space positional
    gradients, "field": {leaf: g} or None}; a parameter the loss does not
    reach gets zeros. `pvg` (a temporal store's model, and only then)
    renders with models.pvg.forward at the camera's time; `deform4d` (a
    state with a field, and only then) with models.deform4d.forward."""
    store = state.store
    if (pvg is not None) != store.params.temporal:
        raise ValueError("a temporal store trains with a PVGConfig, and "
                         "only a temporal store does")
    if (deform4d is not None) != (state.field is not None):
        raise ValueError("a state with a deformation field trains with a "
                         "Deform4DConfig, and only such a state does")
    names = store_groups(store)

    def leaf(x):
        return x.detach().requires_grad_(True)

    with span("step.forward"):
        params = dataclasses.replace(store.params, **{
            name: leaf(getattr(store.params, name)) for name in names})
        env = leaf(state.env_map) if state.env_map is not None else None
        field = None
        if state.field is not None:
            field = {**state.field,
                     **{k: leaf(state.field[k]) for k in FIELD_GROUPS}}
        xys_zero = torch.zeros((store.capacity, 2), dtype=torch.float32,
                               device=store.active.device, requires_grad=True)
        if pvg is not None:
            outputs, rout = pvg_model.forward(
                params, store.active, camera, state.step, config, pvg,
                render_config, env_map=env, jitter=jitter, training=True,
                xys_offset=xys_zero)
        elif deform4d is not None:
            outputs, rout = deform4d_model.forward(
                params, store.active, field, camera, state.step, config,
                deform4d, render_config, env_map=env, jitter=jitter,
                training=True, xys_offset=xys_zero)
        else:
            outputs, rout = forward(
                params, store.active, camera, state.step, config,
                render_config, env_map=env, jitter=jitter, training=True,
                time=batch.get("time"), xys_offset=xys_zero)
        losses = loss_dict(outputs, batch, config)
        if field is not None and deform4d_model.live(deform4d, state.step):
            losses.update(deform4d_model.regularizers(field["planes"],
                                                      deform4d))
        total = sum(losses.values())

        leaves = [getattr(params, n) for n in names] + [xys_zero]
        if env is not None:
            leaves.append(env)
        if field is not None:
            leaves += [field[k] for k in FIELD_GROUPS]
    with span("step.backward"):
        raw = torch.autograd.grad(total, leaves, allow_unused=True)
        got = [torch.zeros_like(p) if g is None else g
               for p, g in zip(leaves, raw)]
    it = iter(got)
    grads = {"params": {n: next(it) for n in names},
             "xys": next(it),
             "env_map": next(it) if env is not None else None}
    grads["field"] = ({k: next(it) for k in FIELD_GROUPS}
                      if field is not None else None)
    detach = lambda t: t.detach()  # noqa: E731
    return (total.detach(), tree_map(detach, losses),
            tree_map(detach, outputs), rout, grads)


def train_step(state: TrainState, camera: Camera, batch: dict,
               config: SplatfactoConfig, render_config: RenderConfig,
               jitter: Optional[torch.Tensor] = None,
               pvg: Optional[PVGConfig] = None,
               deform4d: Optional[Deform4DConfig] = None):
    """One optimization step. Returns (new_state, metrics).

    batch: {"image" (H, W, 3), optional "mask", "semantic", "time"}.
    `jitter` ((2, H, W)) is the sky rays' jitter; when None it is drawn
    from the state's generator. `pvg`, `deform4d`: see loss_and_grads."""
    if jitter is None and state.env_map is not None:
        jitter = draw_pixel_jitter(camera, state.generator)
    total, losses, outputs, rout, grads = loss_and_grads(
        state, camera, batch, config, render_config, jitter=jitter, pvg=pvg,
        deform4d=deform4d)
    step = state.step
    names = store_groups(state.store)
    with torch.no_grad(), span("step.adam"):
        groups = {}
        for name in names:
            cfg = group_config(name)
            groups[name] = AdamGroup(
                grads["params"][name], state.opt[name],
                getattr(state.store.params, name), schedule(cfg, step), cfg)
        if state.env_map is not None:
            cfg = DEFAULT_GROUPS["sky_sphere"]
            groups["sky_sphere"] = AdamGroup(
                grads["env_map"], state.opt["sky_sphere"], state.env_map,
                schedule(cfg, step), cfg)
        for k in FIELD_GROUPS if state.field is not None else ():
            name = field_group(k)
            cfg = group_config(name)
            groups[name] = AdamGroup(grads["field"][k], state.opt[name],
                                     state.field[k], schedule(cfg, step),
                                     cfg)
        stepped = adam_step(groups)
        new_opt = {**state.opt, **{n: s for n, (_, s) in stepped.items()}}
        new_env = stepped["sky_sphere"][0] if "sky_sphere" in stepped \
            else state.env_map
        new_field = state.field if state.field is None else {
            **state.field,
            **{k: stepped[field_group(k)][0] for k in FIELD_GROUPS}}
        store = dataclasses.replace(state.store, params=dataclasses.replace(
            state.store.params, **{name: stepped[name][0] for name in names}))
    with torch.no_grad(), span("step.stats"):
        max_hw = max(camera.height, camera.width)
        store = refinement.update_stats(store, grads["xys"],
                                        rout.projected.radii, max_hw, step,
                                        config)
        metrics = {
            "loss": total,
            "psnr": psnr(outputs["rgb"], batch["image"]),
            "gaussian_count": store.num_active,
            "num_pairs": rout.bins.num_pairs,
            "num_rowruns": rout.bins.num_rowruns,
            "max_tile_count": rout.bins.max_tile_count,
            **losses,
        }
    return dataclasses.replace(state, store=store, env_map=new_env,
                               opt=new_opt, field=new_field,
                               step=step + 1), metrics


def refine_step(state: TrainState, config: SplatfactoConfig,
                num_train_data: int, max_hw: int,
                noise: Optional[torch.Tensor] = None,
                densify_scale: Optional[torch.Tensor] = None):
    """One refinement pass (cull / densify / reset) at step
    `state.step - 1`, the step train_step has just finished. Returns
    (new_state, info). `noise`: the split noise
    (models.refinement.draw_split_noise), drawn from the state's
    generator when None. `densify_scale`: see models.refinement.refine
    (PVG's models.pvg.densify_scale)."""
    if noise is None:
        noise = refinement.draw_split_noise(
            config, state.store.capacity, state.generator,
            state.store.active.device)
    gauss_opt = {name: state.opt[name] for name in store_groups(state.store)}
    store, surgery, info = refinement.refine(
        state.store, state.step - 1, config, num_train_data, max_hw, noise,
        densify_scale=densify_scale)
    new_opt = dict(state.opt)
    new_opt.update(refinement.apply_moment_surgery(gauss_opt, surgery))
    return dataclasses.replace(state, store=store, opt=new_opt), info
