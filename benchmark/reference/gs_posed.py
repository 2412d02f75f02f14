"""Plain PyTorch reference of the scene graph with tracked-pose
optimisation (Street Gaussians, arXiv:2401.01339, sec. 3.3): each tracked
box's per-frame centre delta and yaw delta are trained with the scene,
R' = R dR and T' = T + dT, where `gs.boxes_at` detaches them.

Everything else is `gs`: the projection, the pairs a tile holds, SH, the
sky, the losses and Adam. The compositor runs over blocks of whole tiles
(contiguous in tile order, about BLOCK_PAIRS pairs each) under
activation checkpointing, so the backward of a render holds one block's
intermediates at a time and three steps of a 4.6 M-slot scene fit on the
card after the program is freed. Tiles composite independently, so the
blocks' images add up (zero outside their tiles) and their
transmittances multiply (one outside). Imports nothing of the measured
package.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from . import gs

BLOCK_PAIRS = 2 ** 19
LEAF_GROUPS = ("means", "scales", "quats", "features_dc", "features_rest",
               "opacities")
DELTAS = ("delta_center", "delta_yaw")


def boxes_at(tracks: dict, t: float, delta_center, delta_yaw):
    """gs.boxes_at with the deltas' gradient: the exact frame or SLERP /
    lerp between the bracketing frames; at an exact annotated frame (or
    before the first) the centre gets + delta_center[f] and the box
    rotation is post-multiplied by the yaw quaternion of delta_yaw[f]."""
    times = tracks["times"]
    F = times.shape[0]
    tt = torch.tensor(t, dtype=torch.float32, device=times.device)
    i1 = int(torch.clamp(torch.searchsorted(times, tt.reshape(1)), 0,
                         F - 1)[0])
    i0 = max(i1 - 1, 0)
    t0, t1 = times[i0], times[i1]
    exact = bool(tt == t1)
    w = (torch.ones_like(tt) if exact else torch.clamp(
        (tt - t0) / torch.where(t1 > t0, t1 - t0, torch.ones_like(t1)),
        0.0, 1.0))
    in_range = bool((tt >= times[0]) & (tt <= times[-1]))
    centers = tracks["centers"][i0] * (1 - w) + tracks["centers"][i1] * w
    quats = gs.q_slerp(tracks["quats"][i0], tracks["quats"][i1], w)
    v0, v1 = tracks["valid"][i0], tracks["valid"][i1]
    visible = (v0 if float(w) <= 0 else v1 if float(w) >= 1 else v0 & v1)
    visible = visible & in_range
    span = tracks["obj_last"] - tracks["obj_first"]
    frame_pos = float(i0) + w
    t_norm = torch.where(span > 0, (frame_pos - tracks["obj_first"])
                         / torch.clamp(span, min=1e-6), torch.ones_like(span))
    if exact or float(w) <= 0:
        fi = i1 if exact else i0
        centers = centers + delta_center[fi]
        dy = delta_yaw[fi]
        z = torch.zeros_like(dy)
        quats = gs.q_mul(quats, torch.stack([torch.cos(dy), z, z,
                                             torch.sin(dy)], -1))
    return centers, quats, visible, t_norm


def flat_scene(p: dict, tracks: dict, t: float):
    """gs.flat_scene with the boxes posed by boxes_at above."""
    bg_dc = gs.fourier_dc(p["bg/features_dc"], torch.zeros(()))
    centers, bq, visible, t_norm = boxes_at(tracks, t, p["delta_center"],
                                            p["delta_yaw"])
    R = gs.q_rotmat(gs.q_normalize(bq))
    om = torch.einsum("oij,ocj->oci", R, p["obj/means"]) + centers[:, None]
    oq = gs.q_mul(bq[:, None, :], p["obj/quats"])
    odc = gs.fourier_dc(p["obj/features_dc"], t_norm)

    def cat(a, b):
        return torch.cat([a, b.reshape((-1,) + b.shape[2:])], 0)
    return (cat(p["bg/means"], om), cat(p["bg/scales"], p["obj/scales"]),
            cat(p["bg/quats"], oq), cat(bg_dc, odc),
            cat(p["bg/features_rest"], p["obj/features_rest"]),
            cat(p["bg/opacities"], p["obj/opacities"]),
            cat(p["bg/active"], p["obj/active"] & visible[:, None]),
            p["bg/means"].shape[0])


def tile_blocks(starts: torch.Tensor, block_pairs: int = BLOCK_PAIRS):
    """Contiguous tile ranges [t0, t1) of about block_pairs pairs each (a
    tile with more stands alone)."""
    s = starts.tolist()
    out, t0 = [], 0
    for t in range(1, len(s)):
        if s[t] - s[t0] >= block_pairs or t == len(s) - 1:
            out.append((t0, t))
            t0 = t
    return out


def composite(xys, conics, op, colors, gp, starts, W, H,
              block_pairs: int = BLOCK_PAIRS):
    """gs.composite over tile blocks, each under checkpointing: the same
    (img, T, evaluations, contributing)."""
    img, T = 0.0, 1.0
    ev = co = 0

    def one(xys, conics, op, colors, sb):
        return gs.composite(xys, conics, op, colors, gp, sb, W, H)
    for t0, t1 in tile_blocks(starts, block_pairs):
        sb = starts.clamp(min=starts[t0], max=starts[t1])
        i, t, e, c = checkpoint(one, xys, conics, op, colors, sb,
                                use_reentrant=False)
        img, T = img + i, T * t
        ev, co = ev + e, co + c
    return img, T, ev, co


def render(means, scales_lin, quats, opac, rgbs, cam, sky=None,
           training=False, active=None):
    """gs.render with the blocked compositor."""
    W, H = cam["width"], cam["height"]
    xys, depth, conics, visible, box, q = gs.project(means, scales_lin,
                                                     quats, opac, cam)
    if active is not None:
        visible = visible & active
    ntx, nty = -(-W // gs.TILE), -(-H // gs.TILE)
    gp, starts = gs.tile_pairs(xys, depth, conics, visible, box, q, ntx, nty)
    colors = torch.cat([rgbs, depth[:, None]], -1)
    img, T, _, _ = composite(xys, conics, opac, colors, gp, starts, W, H)
    alpha = (1.0 - T)[..., None]
    rgb = torch.clamp(img[..., :3], max=1.0)
    if sky is not None:
        rgb = rgb * alpha + sky * (1.0 - alpha)
    if not training:
        rgb = torch.clamp(rgb, 0.0, 1.0)
    d = torch.where(alpha > 1e-3, img[..., 3:4] / torch.clamp(alpha, min=1e-3),
                    torch.full_like(alpha, gs.DEPTH_FAR))
    return {"rgb": rgb, "accumulation": alpha, "depth": d}


def forward(p: dict, tracks: dict, cam: dict, degree: int, training: bool,
            jitter=None):
    """The scene graph's render of one camera, the boxes posed with the
    deltas' gradient (no object-only or background-only renders: the
    entropy loss that reads them is off before stop_split_at)."""
    means, scales, quats, dc, rest, opl, active, _ = flat_scene(
        p, tracks, cam["time"])
    rgbs = gs.sh_rgb(means, dc, rest, cam["c2w"][:3, 3], degree)
    op = torch.sigmoid(opl[:, 0])
    op = torch.where(active, op, torch.zeros_like(op))
    sky = gs.sky_rgb(p["env_map"], cam, jitter if training else None)
    return render(means, torch.exp(scales), quats, op, rgbs, cam, sky,
                  training, active)


def leaf_names(sc: dict) -> list:
    """The trained leaves: each submodel's gaussian groups, the sky and
    the two deltas."""
    return [k for k in sc if k.split("/")[-1] in LEAF_GROUPS] + [
        "env_map", *DELTAS]


def reference_steps(sc: dict, tracks: dict, steps: list, degree: int) -> dict:
    """train_check.reference_steps over every leaf, the deltas included:
    steps [(step, camera, target (H, W, 3), semantic (H, W, 1), jitter
    (2, H, W))]. Returns {"losses", "first_grad", "change"} as host
    floats."""
    gs.no_tf32()
    names = leaf_names(sc)
    fixed = {k: sc[k] for k in sc if k not in names}
    p = {k: sc[k].detach().clone() for k in names}
    p0 = {k: v.clone() for k, v in p.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    losses, first = [], {}
    for i, (step, cam, img, sem, jitter) in enumerate(steps):
        leaves = {k: p[k].requires_grad_(True) for k in names}
        out = forward({**leaves, **fixed}, tracks, cam, degree,
                      training=True, jitter=jitter)
        loss = gs.loss(out, img, sem)
        grads = torch.autograd.grad(loss, [leaves[k] for k in names])
        losses.append(float(loss.detach()))
        with torch.no_grad():
            for k, g in zip(names, grads):
                if "/" in k:
                    act = fixed[k.split("/")[0] + "/active"]
                    a = act.reshape(act.shape + (1,) * (g.dim() - act.dim()))
                    g = torch.where(a, g, torch.zeros_like(g))
                if i == 0:
                    first[k] = float(torch.linalg.vector_norm(g))
                p[k], m[k], v2[k] = gs.adam(
                    p[k].detach(), g, m[k], v2[k], i + 1,
                    gs.lr_at(k.split("/")[-1], step))
        del out, loss, grads, leaves
    change = {k: float(torch.linalg.vector_norm(p[k] - p0[k])) for k in names}
    return {"losses": losses, "first_grad": first, "change": change}
