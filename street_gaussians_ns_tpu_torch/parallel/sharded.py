"""The multi-device scene-graph training step (counterpart of
street_gaussians_ns_tpu/parallel/sharded.py: `_combine_layers`,
`_combine_alpha`, `sharded_scene_loss`, `make_sharded_train_step`,
`stack_batches`, `stack_cameras`).

Every rank runs `sharded_scene_loss` for its place in the mesh
(parallel.mesh), which is what the JAX package's shard_map body runs per
device:

  * data rows train on one camera each; the loss is the mean over rows;
  * the background gaussians are sharded over the model columns: a rank
    projects its shard and computes its SH colours, the compact screen
    attributes are all-gathered over the row, and the objects (small,
    replicated) are projected by every rank;
  * each column bins and composites its pair-balanced window of the
    global depth order into a full-frame (accum, T) layer
    (ops.composite.composite_tiles_fused with balance_gather), and the
    layers merge in depth order by (C, T) |> (C', T') = (C + T C', T T')
    (_combine_layers), in bfloat16 on the wire when the render is bf16
    and there is more than one column; with more than one column the sky
    and the SSIM are computed in bands of rows, one band a column
    (models.splatfacto.sky_color row0/rows, ops.ssim.ssim_band_mean).
    The compositor takes 16x16 tiles only: another tile size raises.

Like the JAX merge, each column composites its window from T = 1, so a
pixel that a nearer window ended still takes pairs of a farther one (the
JAX package's documented deviation from the single-device frame).

The backward: every rank differentiates its own loss seeded with
1 / (data x model), the collectives' adjoints (parallel.collectives) hand
each column the cotangents of what it sent, and the gradients are then
summed over the mesh axes a leaf is replicated on: over the data rows
for the background shard, over every rank for the objects, the sky, the
box deltas. This is the JAX shard_map transpose, so a replicated
parameter's gradient is counted once, however many columns use it.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

from ..core.cameras import Camera, draw_pixel_jitter, viewmat_from_c2w
from ..core.projection import Projected, project
from ..engine.optimizers import tree_map
from ..engine.scene_train_step import (BBOX_PARAMS, SceneTrainState,
                                       _bbox_params, _gaussian_group_params,
                                       scene_adam)
from ..engine.train_step import GAUSSIAN_GROUPS
from ..models import refinement
from ..models.fourier import fourier_dc
from ..models.scene_graph import (ObjectTracks, SceneGraphConfig,
                                  interpolate_boxes, object2world,
                                  scene_loss_dict)
from ..models.splatfacto import sh_colors, sky_color
from ..ops.composite import (_check_tile_size, _tiles_to_image,
                              composite_tiles_fused)
from ..ops.packing import round_bf16
from ..ops.render import RenderConfig
from ..ops.ssim import ssim_band_mean
from .collectives import (all_gather_tiled, all_reduce, allreduce_form,
                          gather_tiled, group_size, pmax, pmean, psum,
                          reduce_scatter_tiled)
from .mesh import Mesh

_FLOAT_FIELDS = ("xys", "depths", "conics", "comp")
_INT_FIELDS = ("radii", "num_tiles_hit", "tile_box")


def _pad_to(x: torch.Tensor, n: int) -> torch.Tensor:
    pad = n - x.shape[0]
    if pad <= 0:
        return x
    return torch.cat([x, torch.zeros((pad,) + tuple(x.shape[1:]),
                                     dtype=x.dtype, device=x.device)])


class _RoundBf16(torch.autograd.Function):
    """round_bf16 forward and backward: a value sent as bf16, whose
    cotangent comes back as bf16 (JAX differentiates its astype pair so)."""

    @staticmethod
    def forward(ctx, x):
        return round_bf16(x)

    @staticmethod
    def backward(ctx, g):
        return round_bf16(g)


class _AllGatherBf16(torch.autograd.Function):
    """all_gather_tiled of bf16-rounded values: bf16 words on the wire,
    but float32 words holding the rounded values where the gather is an
    all-reduce (gloo with CUDA tensors, parallel.collectives). The
    backward rounds the reduce-scattered cotangent to bf16."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        if allreduce_form(x, group):
            return gather_tiled(x, group)
        return gather_tiled(x.to(torch.bfloat16), group).to(torch.float32)

    @staticmethod
    def backward(ctx, g):
        return round_bf16(reduce_scatter_tiled(round_bf16(g), ctx.group)), None


def _combine_layers(accum: torch.Tensor, alpha: torch.Tensor, group,
                    bf16: bool = False):
    """Merge the columns' (premultiplied accum (T, PIX, C), layer alpha
    (T, PIX)) front to back across the model group: (C, T) |> (C', T') =
    (C + T C', T T') in column order, which is depth order. Returns
    (accum, alpha) of the merged frame, on every rank of the group.
    bf16=True sends the layers as bfloat16 (halving the model axis's
    largest message); the merge itself is float32."""
    m = group_size(group)
    if bf16:
        def ag(x):
            return _AllGatherBf16.apply(_RoundBf16.apply(x), group)
    else:
        def ag(x):
            return all_gather_tiled(x, group)

    la = ag(accum).reshape((m,) + tuple(accum.shape))
    lt = ag(1.0 - alpha).reshape((m,) + tuple(alpha.shape))
    out = torch.zeros_like(la[0])
    t = torch.ones_like(lt[0])
    for k in range(m):
        out = out + t[..., None] * la[k]
        t = t * lt[k]
    return out, 1.0 - t


def _combine_alpha(alpha: torch.Tensor, group) -> torch.Tensor:
    """Alpha-only layer merge: 1 - prod_m (1 - alpha_m)."""
    m = group_size(group)
    lt = all_gather_tiled(1.0 - alpha, group).reshape(
        (m,) + tuple(alpha.shape))
    return 1.0 - torch.prod(lt, dim=0)


def _gather_projected(pr: Projected, group) -> Projected:
    fields = {k: all_gather_tiled(getattr(pr, k), group)
              for k in _FLOAT_FIELDS}
    fields.update({k: gather_tiled(getattr(pr, k), group)
                   for k in _INT_FIELDS})
    return Projected(**fields)


def _cat_projected(a: Projected, b: Projected) -> Projected:
    return Projected(**{k: torch.cat([getattr(a, k), getattr(b, k)])
                        for k in _FLOAT_FIELDS + _INT_FIELDS})


def sharded_scene_loss(mesh: Mesh, gauss: Dict, env, bbox: Dict,
                       off_bg: torch.Tensor, off_obj: torch.Tensor,
                       bg_active: torch.Tensor, obj_active: torch.Tensor,
                       tracks: ObjectTracks, camera: Camera, batch: Dict,
                       step: int, config: SceneGraphConfig,
                       render_config: RenderConfig, cap_bg: int,
                       jitter: Optional[torch.Tensor] = None,
                       subset_accs: bool = True):
    """This rank's part of the sharded loss: (loss, aux). `gauss` holds
    {group: {"bg": this rank's shard, "obj": all objects}}, off_bg
    (cap_bg / model, 2) and off_obj (O, CAP_o, 2) are the zero-valued
    screen-space hooks, camera / batch / jitter this rank's data row's.
    loss is the mean over data rows of the merged loss (the same on every
    rank); aux: psnr (mean over rows), num_pairs / num_rowruns /
    max_tile_count (maxed over every rank: the per-device demand the pair
    capacity must cover), bg_radii (this rank's shard), obj_radii."""
    model_size = mesh.model
    mg, dg = mesh.model_group, mesh.data_group
    width, height = camera.width, camera.height
    ts = render_config.tile_size
    _check_tile_size(ts)
    ntx = -(-width // ts)
    nty = -(-height // ts)
    num_tiles = ntx * nty
    dev = bg_active.device

    bg = {k: gauss[k]["bg"] for k in GAUSSIAN_GROUPS}
    obj = {k: gauss[k]["obj"] for k in GAUSSIAN_GROUPS}
    boxes = interpolate_boxes(
        tracks, camera.time,
        delta_center=bbox["delta_center"] if bbox["delta_center"].numel()
        else None,
        delta_yaw=bbox["delta_yaw"] if bbox["delta_yaw"].numel() else None,
        delta_rot=bbox["delta_rot"] if bbox["delta_rot"].numel() else None,
        mode=config.bbox_mode, differentiable=config.bbox_differentiable)
    o_means, o_quats = object2world(obj["means"], obj["quats"], boxes)
    o_dc = fourier_dc(obj["features_dc"], boxes.t_norm)

    def flat_obj(x):
        return x.reshape((-1,) + tuple(x.shape[2:]))

    vm = viewmat_from_c2w(camera.c2w)

    def project_set(means, scales_log, quats, active, xys_off, op):
        return project(means, torch.exp(scales_log), quats, vm, camera.fx,
                       camera.fy, camera.cx, camera.cy, width, height,
                       tile_size=ts, opacities=op.detach(), active=active,
                       xys_offset=xys_off)

    # Background: this rank's shard, projected, then all-gathered.
    sig = torch.sigmoid(bg["opacities"][:, 0])
    op_bg = torch.where(bg_active, sig, torch.zeros_like(sig))
    pr_bg = project_set(bg["means"], bg["scales"], bg["quats"], bg_active,
                        off_bg, op_bg)
    dc_bg = fourier_dc(bg["features_dc"], torch.zeros((), device=dev))
    rgb_bg = sh_colors(bg["means"], dc_bg, bg["features_rest"], camera, step,
                       config.base, True)
    pr_bg_g = _gather_projected(pr_bg, mg)
    rgb_bg_g = all_gather_tiled(rgb_bg, mg)
    op_bg_g = all_gather_tiled(op_bg, mg)

    # Objects: replicated, every rank projects all of them.
    obj_flat_active = flat_obj(obj_active & boxes.visible[:, None])
    sig_o = torch.sigmoid(flat_obj(obj["opacities"])[:, 0])
    op_obj = torch.where(obj_flat_active, sig_o, torch.zeros_like(sig_o))
    pr_obj = project_set(flat_obj(o_means), flat_obj(obj["scales"]),
                         flat_obj(o_quats), obj_flat_active, flat_obj(off_obj),
                         op_obj)
    rgb_obj = sh_colors(flat_obj(o_means), flat_obj(o_dc),
                        flat_obj(obj["features_rest"]), camera, step,
                        config.base, True)

    pr = _cat_projected(pr_bg_g, pr_obj)
    rgbs = torch.cat([rgb_bg_g, rgb_obj])
    opac = torch.cat([op_bg_g, op_obj])
    n_total = opac.shape[0]
    seg_obj = torch.arange(n_total, device=dev) >= cap_bg
    colors4 = torch.cat([rgbs, pr.depths[:, None]], dim=-1)

    n_pad = -(-n_total // model_size) * model_size
    slice_size = n_pad // model_size
    # Pad rows hit no tile: depth key +inf, no pairs.
    pr_pad = Projected(**{k: _pad_to(getattr(pr, k), n_pad)
                          for k in _FLOAT_FIELDS + _INT_FIELDS})
    colors4_pad = _pad_to(colors4, n_pad)
    opac_pad = _pad_to(opac, n_pad)
    seg_obj_pad = _pad_to(seg_obj, n_pad)
    zero = torch.zeros_like(opac_pad)

    def layer(opac_in, colors_in):
        return composite_tiles_fused(
            pr_pad, colors_in, opac_in, 0, num_tiles, width, height,
            render_config.max_pairs, render_config.max_rowruns,
            last_color_is_depth=True, precision=render_config.precision,
            slice0=mesh.col * slice_size, slice_size=slice_size,
            balance_gather=(functools.partial(gather_tiled, group=mg)
                            if model_size > 1 else None))

    accum_l, alpha_l, bins_main = layer(opac_pad, colors4_pad)
    # bf16 on the wire only when there is something to send.
    accum_t, alpha_t = _combine_layers(
        accum_l, alpha_l, mg,
        bf16=render_config.precision == "bf16" and model_size > 1)
    if subset_accs:
        _, a_obj_l, _ = layer(torch.where(seg_obj_pad, opac_pad, zero),
                              colors4_pad)
        _, a_bg_l, _ = layer(torch.where(seg_obj_pad, zero, opac_pad),
                             colors4_pad)
        alpha_obj = _combine_alpha(a_obj_l, mg)
        alpha_bg = _combine_alpha(a_bg_l, mg)
    else:
        alpha_obj = alpha_bg = torch.zeros_like(alpha_t)

    img4 = _tiles_to_image(accum_t, ntx, nty, width, height)
    alpha = _tiles_to_image(alpha_t, ntx, nty, width, height)[..., None]
    rgb = torch.clamp(img4[..., :3], max=1.0)
    if env is not None:
        if model_size > 1:
            # The sky in bands of pixel rows, one a column, gathered.
            band = -(-height // model_size)
            sky_band = sky_color(env, camera, jitter, row0=mesh.col * band,
                                 rows=band)
            sky = all_gather_tiled(sky_band, mg)[:height]
        else:
            sky = sky_color(env, camera, jitter)
        rgb = rgb * alpha + sky * (1.0 - alpha)
    depth = torch.where(alpha > 1e-3,
                        img4[..., 3:4] / torch.clamp(alpha, min=1e-3),
                        torch.full_like(alpha, render_config.depth_far_fill))
    outputs = {
        "rgb": rgb, "accumulation": alpha, "depth": depth,
        "object_acc": _tiles_to_image(alpha_obj, ntx, nty, width,
                                      height)[..., None],
        "background_acc": _tiles_to_image(alpha_bg, ntx, nty, width,
                                          height)[..., None],
    }
    # The SSIM in bands of map rows, one a column: the value is summed over
    # the row, the gradient flows through the local band.
    ssim_fn = None
    if model_size > 1:
        sband = -(-(height - 10) // model_size)

        def ssim_fn(a, b):
            return psum(ssim_band_mean(a, b, mesh.col * sband, sband), mg)

    losses = scene_loss_dict(outputs, batch, config, step, ssim_fn=ssim_fn)
    loss = pmean(sum(losses.values()), dg)
    mse = torch.mean((outputs["rgb"] - batch["image"].to(torch.float32))
                     ** 2)
    psnr_local = -10.0 * torch.log10(torch.clamp(mse, min=1e-12))
    aux = {
        "psnr": pmean(psnr_local.detach(), dg),
        "num_pairs": pmax(bins_main.num_pairs, dg, mg),
        "num_pairs_local": bins_main.num_pairs,
        "num_rowruns": pmax(bins_main.num_rowruns, dg, mg),
        "max_tile_count": pmax(bins_main.max_tile_count, dg, mg),
        "bg_radii": pr_bg.radii,
        "obj_radii": pr_obj.radii,
        "frame": {k: outputs[k].detach() for k in ("rgb", "accumulation")},
    }
    return loss, aux


def _rank_batch(batch_b: Dict, row: int, device) -> Dict:
    return {k: (v[row].to(device) if v is not None else None)
            for k, v in batch_b.items()}


def _rank_camera(cam_b: Dict, row: int, width: int, height: int) -> Camera:
    return Camera(fx=cam_b["fx"][row], fy=cam_b["fy"][row],
                  cx=cam_b["cx"][row], cy=cam_b["cy"][row],
                  c2w=cam_b["c2w"][row], time=cam_b["time"][row],
                  width=width, height=height)


def make_sharded_train_step(mesh: Mesh, config: SceneGraphConfig,
                            render_config: RenderConfig, width: int,
                            height: int, cap_bg: int,
                            subset_accs: bool = True):
    """Returns step(state, tracks, cam_b, batch_b, jitters=None) ->
    (state, metrics) for this rank: cam_b / batch_b carry a leading axis
    of the data size (stack_cameras, stack_batches; the rank takes its
    row), `state` holds this rank's background shard (parallel.trainer.
    place_state). `jitters` ((data, 2, H, W)) are the rows' sky jitters;
    when None (and there is a sky) every rank draws all of them from the
    state's generator in row order, so the generators stay equal.
    Adam steps the local shard; the densification statistics take the
    local radii maxed over the data rows and the screen-space gradients
    summed over them. The camera optimizer is not part of this step, as in
    the JAX package."""
    if cap_bg % mesh.model:
        raise ValueError(f"background capacity {cap_bg} must divide the "
                         f"model axis {mesh.model}")
    dg, mg = mesh.data_group, mesh.model_group
    # shard_map's seed of a replicated output: 1 / (mesh size) a device.
    ct_seed = 1.0 / (mesh.data * mesh.model)

    def step_fn(state: SceneTrainState, tracks: ObjectTracks, cam_b: Dict,
                batch_b: Dict, jitters: Optional[torch.Tensor] = None):
        store = state.store
        dev = store.background.active.device
        camera = _rank_camera(cam_b, mesh.row, width, height)
        if jitters is None and store.env_map is not None:
            jitters = torch.stack([draw_pixel_jitter(camera, state.generator)
                                   for _ in range(mesh.data)])
        batch = _rank_batch(batch_b, mesh.row, dev)
        jitter = None if jitters is None else jitters[mesh.row].to(dev)
        n_obj = store.num_objects
        cap_obj = store.objects.active.shape[1] if n_obj else 0

        def leaf(x):
            return x.detach().requires_grad_(True)

        gauss = {n: tree_map(leaf, _gaussian_group_params(store, n))
                 for n in GAUSSIAN_GROUPS}
        env = leaf(store.env_map) if store.env_map is not None else None
        bbox = tree_map(leaf, _bbox_params(store))
        off_bg = torch.zeros((store.background.active.shape[0], 2),
                             device=dev, requires_grad=True)
        off_obj = torch.zeros((n_obj, cap_obj, 2), device=dev,
                              requires_grad=True)
        loss, aux = sharded_scene_loss(
            mesh, gauss, env, bbox, off_bg, off_obj, store.background.active,
            store.objects.active, tracks, camera, batch, state.step, config,
            render_config, cap_bg, jitter=jitter, subset_accs=subset_accs)

        bg_leaves = [gauss[n]["bg"] for n in GAUSSIAN_GROUPS] + [off_bg]
        rep_leaves = ([gauss[n]["obj"] for n in GAUSSIAN_GROUPS]
                      + [bbox[n] for n in BBOX_PARAMS] + [off_obj]
                      + ([env] if env is not None else []))
        leaves = bg_leaves + rep_leaves
        raw = torch.autograd.grad(loss, leaves,
                                  grad_outputs=torch.full_like(loss, ct_seed),
                                  allow_unused=True)
        got = [torch.zeros_like(p) if g is None else g
               for p, g in zip(leaves, raw)]
        with torch.no_grad():
            # Sum over the axes a leaf is replicated on.
            got = ([all_reduce(g, dg) for g in got[:len(bg_leaves)]]
                   + [all_reduce(all_reduce(g, dg), mg)
                      for g in got[len(bg_leaves):]])
            it = iter(got)
            g_gauss = {n: {"bg": next(it)} for n in GAUSSIAN_GROUPS}
            g_off_bg = next(it)
            for n in GAUSSIAN_GROUPS:
                g_gauss[n]["obj"] = next(it)
            g_bbox = {n: next(it) for n in BBOX_PARAMS}
            g_off_obj = next(it)
            g_env = next(it) if env is not None else None
            new_state, metrics = _apply_grads(
                state, config, g_gauss, g_env, g_bbox, g_off_bg, g_off_obj,
                aux, loss, max(height, width), mesh)
        return new_state, metrics

    return step_fn


def _apply_grads(state, config, g_gauss, g_env, g_bbox, g_off_bg, g_off_obj,
                 aux, loss, max_hw, mesh):
    """Adam on the local shard and the replicated leaves, then the
    densification statistics: radii maxed over the data rows."""
    store = state.store
    step = state.step
    n_obj = store.num_objects
    dg, mg = mesh.data_group, mesh.model_group
    new_store, new_opt, _ = scene_adam(store, state.opt, g_gauss, g_env,
                                       g_bbox, step)
    bg_radii = all_reduce(aux["bg_radii"], dg, op=dist.ReduceOp.MAX)
    bg_store = refinement.update_stats(new_store.background, g_off_bg,
                                       bg_radii, max_hw, step,
                                       config.background)
    obj_store = new_store.objects
    if n_obj:
        obj_radii = all_reduce(aux["obj_radii"], dg,
                               op=dist.ReduceOp.MAX).reshape(n_obj, -1)
        obj_store = refinement.update_stats(obj_store, g_off_obj, obj_radii,
                                            max_hw, step,
                                            config.object_template)
    new_store = dataclasses.replace(new_store, background=bg_store,
                                    objects=obj_store)
    count = all_reduce(bg_store.num_active, mg) + (
        obj_store.num_active if n_obj else 0)
    metrics = {"loss": loss.detach(), "psnr": aux["psnr"],
               "num_pairs": aux["num_pairs"],
               "num_pairs_local": aux["num_pairs_local"],
               "num_rowruns": aux["num_rowruns"],
               "max_tile_count": aux["max_tile_count"],
               "gaussian_count": count,
               # This rank's data row's merged frame (not a scalar).
               **{f"frame_{k}": v for k, v in aux["frame"].items()}}
    return dataclasses.replace(state, store=new_store, opt=new_opt,
                               step=step + 1), metrics


def stack_batches(batches: List[Dict], height: int, width: int) -> Dict:
    """Stack per-frame batches, a neutral mask (all ones) and semantic (all
    zeros) standing in where a frame has none."""
    def t(x):
        return torch.as_tensor(x)

    dev = t(batches[0]["image"]).device
    return {
        "image": torch.stack([t(b["image"]) for b in batches]),
        "mask": torch.stack([
            t(b["mask"]) if b.get("mask") is not None
            else torch.ones((height, width, 1), dtype=torch.bool, device=dev)
            for b in batches]),
        "semantic": torch.stack([
            t(b["semantic"]) if b.get("semantic") is not None
            else torch.zeros((height, width, 1), dtype=torch.int32,
                             device=dev)
            for b in batches]),
    }


def stack_cameras(cameras: List[Camera]) -> Dict:
    """Same-resolution cameras -> the dict of stacked fields the sharded
    step takes (leading axis: data rows)."""
    return {k: torch.stack([getattr(c, k) for c in cameras])
            for k in ("fx", "fy", "cx", "cy", "c2w", "time")}
