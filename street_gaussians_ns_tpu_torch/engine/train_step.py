"""Training step of the single-model (Splatfacto) pipeline (counterpart of
street_gaussians_ns_tpu/engine/train_step.py: `GAUSSIAN_GROUPS`,
`TrainState`, `init_train_state`, `train_step`, `refine_step`).

`train_step`: forward render -> L1 + SSIM + sky losses -> backward through
the fused rasterizer (with the screen-space xys gradient hook) -> 7
per-group Adam updates -> densification statistics. `refine_step`: one
refinement pass, called every refine_every steps by a host loop after
`train_step` has advanced the step.

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
from ..models import refinement
from ..models.gaussians import GaussianStore
from ..models.splatfacto import SplatfactoConfig, forward, loss_dict
from ..ops.render import RenderConfig
from ..ops.ssim import psnr
from ..utils.profiling import span
from .optimizers import (DEFAULT_GROUPS, AdamState, adam_update, init_adam,
                         schedule, tree_map)

GAUSSIAN_GROUPS = ("means", "scales", "quats", "features_dc",
                   "features_rest", "opacities")


@dataclasses.dataclass(frozen=True)
class TrainState:
    store: GaussianStore
    env_map: Optional[torch.Tensor]
    opt: Dict[str, AdamState]      # per-group Adam states
    step: int
    generator: torch.Generator     # on the store's device; draws the sky
    #                                jitter and the split noise


def init_train_state(store: GaussianStore, env_map: Optional[torch.Tensor],
                     generator: torch.Generator) -> TrainState:
    opt = {name: init_adam(getattr(store.params, name))
           for name in GAUSSIAN_GROUPS}
    if env_map is not None:
        opt["sky_sphere"] = init_adam(env_map)
    return TrainState(store=store, env_map=env_map, opt=opt, step=0,
                      generator=generator)


def loss_and_grads(state: TrainState, camera: Camera, batch: dict,
                   config: SplatfactoConfig, render_config: RenderConfig,
                   jitter: Optional[torch.Tensor] = None):
    """The forward and backward of one step. Returns (total loss, losses,
    outputs, RenderOutputs, grads) with grads = {"params": {group: g},
    "env_map": g or None, "xys": (CAP, 2) the screen-space positional
    gradients}; a parameter the loss does not reach gets zeros."""
    store = state.store

    def leaf(x):
        return x.detach().requires_grad_(True)

    with span("step.forward"):
        params = dataclasses.replace(store.params, **{
            name: leaf(getattr(store.params, name))
            for name in GAUSSIAN_GROUPS})
        env = leaf(state.env_map) if state.env_map is not None else None
        xys_zero = torch.zeros((store.capacity, 2), dtype=torch.float32,
                               device=store.active.device, requires_grad=True)
        outputs, rout = forward(
            params, store.active, camera, state.step, config, render_config,
            env_map=env, jitter=jitter, training=True, time=batch.get("time"),
            xys_offset=xys_zero)
        losses = loss_dict(outputs, batch, config)
        total = sum(losses.values())

        leaves = [getattr(params, n) for n in GAUSSIAN_GROUPS] + [xys_zero]
        if env is not None:
            leaves.append(env)
    with span("step.backward"):
        raw = torch.autograd.grad(total, leaves, allow_unused=True)
        got = [torch.zeros_like(p) if g is None else g
               for p, g in zip(leaves, raw)]
    it = iter(got)
    grads = {"params": {n: next(it) for n in GAUSSIAN_GROUPS},
             "xys": next(it),
             "env_map": next(it) if env is not None else None}
    detach = lambda t: t.detach()  # noqa: E731
    return (total.detach(), tree_map(detach, losses),
            tree_map(detach, outputs), rout, grads)


def train_step(state: TrainState, camera: Camera, batch: dict,
               config: SplatfactoConfig, render_config: RenderConfig,
               jitter: Optional[torch.Tensor] = None):
    """One optimization step. Returns (new_state, metrics).

    batch: {"image" (H, W, 3), optional "mask", "semantic", "time"}.
    `jitter` ((2, H, W)) is the sky rays' jitter; when None it is drawn
    from the state's generator."""
    if jitter is None and state.env_map is not None:
        jitter = draw_pixel_jitter(camera, state.generator)
    total, losses, outputs, rout, grads = loss_and_grads(
        state, camera, batch, config, render_config, jitter=jitter)
    step = state.step
    with torch.no_grad(), span("step.adam"):
        new_params = {}
        new_opt = dict(state.opt)
        for name in GAUSSIAN_GROUPS:
            cfg = DEFAULT_GROUPS[name]
            new_params[name], new_opt[name] = adam_update(
                grads["params"][name], state.opt[name],
                getattr(state.store.params, name), schedule(cfg, step), cfg)
        new_env = state.env_map
        if state.env_map is not None:
            cfg = DEFAULT_GROUPS["sky_sphere"]
            new_env, new_opt["sky_sphere"] = adam_update(
                grads["env_map"], state.opt["sky_sphere"], state.env_map,
                schedule(cfg, step), cfg)
        store = dataclasses.replace(state.store, params=dataclasses.replace(
            state.store.params, **new_params))
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
                               opt=new_opt, step=step + 1), metrics


def refine_step(state: TrainState, config: SplatfactoConfig,
                num_train_data: int, max_hw: int,
                noise: Optional[torch.Tensor] = None):
    """One refinement pass (cull / densify / reset) at step
    `state.step - 1`, the step train_step has just finished. Returns
    (new_state, info). `noise`: the split noise
    (models.refinement.draw_split_noise), drawn from the state's
    generator when None."""
    if noise is None:
        noise = refinement.draw_split_noise(
            config, state.store.capacity, state.generator,
            state.store.active.device)
    gauss_opt = {name: state.opt[name] for name in GAUSSIAN_GROUPS}
    store, surgery, info = refinement.refine(
        state.store, state.step - 1, config, num_train_data, max_hw, noise)
    new_opt = dict(state.opt)
    new_opt.update(refinement.apply_moment_surgery(gauss_opt, surgery))
    return dataclasses.replace(state, store=store, opt=new_opt), info
