"""Adaptive density control (densify / split / dup / cull) on the
fixed-capacity store (counterpart of
street_gaussians_ns_tpu/models/refinement.py: `update_stats`,
`_scatter_children`, `refine`, `apply_moment_surgery`).

Schedule and thresholds, as the JAX package replicates them from the
reference:
  * stats: per step, ||dL/dxys|| accumulated over visible gaussians and
    the largest screen radius ratio, stopped at stop_split_at;
  * every refine_every steps past warmup:
      - densify iff step < stop_split_at and
        step % (reset_alpha_every * refine_every) > num_train_data +
        refine_every;
      - high_grads: (sum_grad / vis_count) 0.5 max(H, W) >
        densify_grad_thresh;
      - split if scale_max > densify_size_thresh (or the screen size >
        split_screen_size until stop_screen_size_at): n_split_samples
        children at means + R(q) (exp(scale) N(0, 1)), child scales / 1.6,
        the original culled once all its children are placed; dup
        otherwise (one copy);
      - cull: alpha < cull_alpha_thresh, plus (past the first reset
        interval) scale_max > cull_scale_thresh, plus (until
        stop_screen_size_at) screen size > cull_screen_size, over the
        buffer with the children already scattered in;
      - opacity reset when step % reset_interval == refine_every: clamp
        the logit opacity to logit(2 cull_alpha_thresh) and zero the
        opacities group's Adam moments.
New and culled slots get zeroed Adam moments (`apply_moment_surgery`).

The step and the schedule's switches are host values here; the split
noise is drawn in one place (`draw_split_noise`) and handed to `refine`,
so a test can hand both packages the same numbers. Functions return new
stores and leave their arguments untouched.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..core import quaternions as quat
from ..engine.optimizers import AdamState, mask_moments, tree_map
from ..utils.profiling import span
from .gaussians import GaussianParams, GaussianStore
from .splatfacto import SplatfactoConfig


def update_stats(store: GaussianStore, xys_grad: torch.Tensor,
                 radii: torch.Tensor, max_hw: int, step: int,
                 config: SplatfactoConfig) -> GaussianStore:
    """Accumulate the densification statistics of one step. xys_grad
    (..., CAP, 2) is dL/dxys, radii (..., CAP) int32; leading object axes
    are allowed."""
    if not step < config.stop_split_at:
        return store
    visible = (radii > 0) & store.active
    grads = torch.linalg.vector_norm(xys_grad, dim=-1)
    zero = torch.zeros_like(grads)
    size = radii.to(torch.float32) / max_hw
    return dataclasses.replace(
        store,
        xys_grad_norm=store.xys_grad_norm + torch.where(visible, grads, zero),
        vis_counts=store.vis_counts + visible.to(torch.float32),
        max_2dsize=torch.where(visible,
                               torch.maximum(store.max_2dsize, size),
                               store.max_2dsize))


def _scatter_children(params: GaussianParams, active: torch.Tensor,
                      child_params: GaussianParams,
                      child_valid: torch.Tensor):
    """Place valid children into inactive slots (first fit, in child
    order). Returns (params, active, placed mask over slots, placed mask
    over children, number of valid children dropped for want of a slot).
    Reads the counts from the device."""
    cap = active.shape[0]
    with span("refine.nonzero", sync=True):
        free_slots = torch.nonzero(~active)[:, 0]
    with span("refine.nonzero", sync=True):
        valid_children = torch.nonzero(child_valid)[:, 0]
    n_place = min(free_slots.shape[0], valid_children.shape[0])
    target = free_slots[:n_place]
    source = valid_children[:n_place]

    def scat(buf, child):
        out = buf.clone()
        out[target] = child[source]
        return out

    new_params = GaussianParams(**{
        k: scat(v, getattr(child_params, k))
        for k, v in params.as_dict().items()})
    # index_fill_ takes the value as a kernel argument: no copy from the
    # host, which would wait for the card.
    new_active = active.clone().index_fill_(0, target, True)
    placed_slots = torch.zeros((cap,), dtype=torch.bool, device=active.device)
    placed_slots.index_fill_(0, target, True)
    placed_children = torch.zeros_like(child_valid)
    placed_children.index_fill_(0, source, True)
    n_dropped = valid_children.shape[0] - n_place
    return new_params, new_active, placed_slots, placed_children, n_dropped


def parent_budget(config: SplatfactoConfig, cap: int) -> int:
    """At most this many split/dup parents produce children in one pass;
    parents past the budget neither spawn nor die and retry next pass."""
    return min(cap, max(256, cap // config.refine_parent_cap_div))


def draw_split_noise(config: SplatfactoConfig, cap: int,
                     generator: torch.Generator, device) -> torch.Tensor:
    """The standard-normal noise that places split children:
    (n_split_samples, parent_budget, 3)."""
    return torch.randn((config.n_split_samples, parent_budget(config, cap),
                        3), dtype=torch.float32, device=device,
                       generator=generator)


def refine(store: GaussianStore, step: int, config: SplatfactoConfig,
           num_train_data: int, max_hw: int, noise: torch.Tensor,
           densify_scale: torch.Tensor | None = None):
    """One refinement pass of one store; call every refine_every steps
    past warmup. `noise`: see draw_split_noise. `densify_scale` ((CAP,),
    PVG's position-aware gamma, models.pvg.densify_scale) multiplies each
    gaussian's average screen gradient in the densify test. Every leaf of
    the store reaches the children, a temporal store's tau, s_beta and
    velocity copied from the parent.

    Returns (new_store, surgery, info): surgery = {"keep": (CAP,) bool
    mask of the slots whose Adam moments survive, "reset_opacities": bool,
    zero the opacities group's moments}; info holds 0-d int64 counts."""
    p = store.params
    cap = store.capacity
    dev = store.active.device
    reset_interval = config.reset_alpha_every * config.refine_every

    run = step > config.warmup_length
    do_densify = (run and step < config.stop_split_at
                  and (step % reset_interval)
                  > (num_train_data + config.refine_every))

    vis = torch.clamp(store.vis_counts, min=1.0)
    avg_grad = (store.xys_grad_norm / vis) * 0.5 * max_hw
    if densify_scale is not None:
        avg_grad = avg_grad * densify_scale
    high_grads = store.active & (avg_grad > config.densify_grad_thresh)

    scale_max = torch.exp(p.scales).amax(dim=-1)
    big_world = scale_max > config.densify_size_thresh
    big_screen = store.max_2dsize > config.split_screen_size
    if not step < config.stop_screen_size_at:
        big_screen = torch.zeros_like(big_screen)
    none = torch.zeros_like(high_grads)
    splits = high_grads & (big_world | big_screen) if do_densify else none
    dups = high_grads & ~big_world if do_densify else none

    # --- children: the parents of this round, compacted to the budget ----
    nsamps = config.n_split_samples
    capp = parent_budget(config, cap)
    if tuple(noise.shape) != (nsamps, capp, 3):
        raise ValueError(f"noise must be ({nsamps}, {capp}, 3), got "
                         f"{tuple(noise.shape)}")
    parent_has = splits | dups
    order = torch.sort((~parent_has).to(torch.int8), stable=True).indices
    sel = order[:capp]
    psel = GaussianParams(**{k: v[sel] for k, v in p.as_dict().items()})
    splits_sel = splits[sel]
    dups_sel = dups[sel]

    R = quat.to_rotmat(quat.normalize(psel.quats))           # (CAPP, 3, 3)
    samples = torch.einsum("nij,snj->sni", R,
                           noise * torch.exp(psel.scales))
    split_means = psel.means[None] + samples                 # (S, CAPP, 3)
    split_scales = torch.log(torch.exp(psel.scales) / 1.6).expand(
        nsamps, capp, 3)

    # Parent-major child order: one parent's samples are adjacent, so the
    # first-fit placement under a tight slot budget completes whole split
    # families.
    def pm(x_snc):
        return x_snc.transpose(0, 1).reshape((capp * nsamps,)
                                             + x_snc.shape[2:])

    def rep(x):
        return torch.repeat_interleave(x, nsamps, dim=0)

    # Split children: new means and scales; every other leaf copied.
    split_children = dict(means=pm(split_means), scales=pm(split_scales))
    children = GaussianParams(**{
        k: torch.cat([split_children[k] if k in split_children
                      else rep(v), v])
        for k, v in psel.as_dict().items()})
    child_valid = torch.cat([rep(splits_sel), dups_sel])

    new_params, new_active, placed, placed_children, n_dropped = \
        _scatter_children(p, store.active, children, child_valid)
    # Children lost to the parent budget, not just to the slot budget.
    over_splits = splits.sum() - splits_sel.sum()
    over_dups = dups.sum() - dups_sel.sum()
    n_dropped = n_dropped + over_splits * nsamps + over_dups

    # --- cull over the buffer with the children in ----------------------
    alpha = torch.sigmoid(new_params.opacities[:, 0])
    culls = new_active & (alpha < config.cull_alpha_thresh)
    if step > reset_interval:
        toobig = torch.exp(new_params.scales).amax(dim=-1) \
            > config.cull_scale_thresh
        if step < config.stop_screen_size_at:
            # max_2dsize is zero for children.
            max2d = torch.where(placed, torch.zeros_like(store.max_2dsize),
                                store.max_2dsize)
            toobig = toobig | (max2d > config.cull_screen_size)
        culls = culls | (new_active & toobig)
    # Split originals die, but only those whose nsamps children were all
    # placed: a parent past the budget, or one whose children found no
    # slot, got no replacement and stays.
    split_children_placed = placed_children[:nsamps * capp].reshape(
        capp, nsamps).all(dim=1)
    splits_replaced = torch.zeros((cap,), dtype=torch.bool, device=dev)
    splits_replaced[sel] = splits_sel & split_children_placed
    culls = culls | splits_replaced
    # Past stop_split_at the cull fires once more, at the first refine
    # boundary at or after it (the reference's stats stop refreshing then).
    final_cull = (config.continue_cull_post_densification
                  and config.stop_split_at <= step
                  < config.stop_split_at + config.refine_every)
    if not (run and (do_densify or final_cull)):
        culls = torch.zeros_like(culls)
    new_active = new_active & ~culls

    keep = ~culls & ~placed      # children start with zero moments too

    do_reset = (run and step < config.stop_split_at
                and (step % reset_interval) == config.refine_every)
    if do_reset:
        reset_logit = math.log(2.0 * config.cull_alpha_thresh
                               / (1.0 - 2.0 * config.cull_alpha_thresh))
        new_params = dataclasses.replace(
            new_params,
            opacities=torch.clamp(new_params.opacities, max=reset_logit))

    # The stats reset only once refinement runs; within warmup they keep
    # accumulating.
    def stat(x):
        return torch.zeros_like(x) if run else x

    new_store = GaussianStore(
        params=new_params, active=new_active,
        xys_grad_norm=stat(store.xys_grad_norm),
        vis_counts=stat(store.vis_counts),
        max_2dsize=stat(store.max_2dsize))
    info = {
        "high_grads_count": high_grads.sum(),
        "refine_splits_count": splits.sum(),
        "refine_dups_count": dups.sum(),
        "refine_culls_count": culls.sum(),
        "children_dropped": torch.as_tensor(n_dropped, device=dev),
        "gaussian_count": new_active.sum(),
    }
    return new_store, {"keep": keep, "reset_opacities": do_reset}, info


def apply_moment_surgery(opt_states: dict, surgery: dict) -> dict:
    """Zero the Adam moments of culled and new slots and, on an opacity
    reset, of the whole opacities group. opt_states: group name ->
    AdamState whose leaves lead with the keep mask's axes."""
    new = {name: mask_moments(s, surgery["keep"])
           for name, s in opt_states.items()}
    if surgery["reset_opacities"]:
        op = new["opacities"]
        new["opacities"] = AdamState(mu=tree_map(torch.zeros_like, op.mu),
                                     nu=tree_map(torch.zeros_like, op.nu),
                                     count=op.count)
    return new
