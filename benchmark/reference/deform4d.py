"""Plain PyTorch reference of 4D Gaussian Splatting (4DGS; Wu et al.,
arXiv:2310.08528, sec. 3-4): one canonical cloud and the sky, moved to
each camera's time t by a HexPlane deformation field.

    x^ = 2 (X - a_min) / (a_max - a_min) - 1,  t^ = 2 (t - t0) / (t1 - t0) - 1
    f_h = concat_l prod_(i,j) bilinear(R_l(i, j); x^_i, x^_j)
          over xy, xz, yz, xt, yt, zt, each plane (C, N_j, N_i)
    f_d = W0 f_h + b0 (4DGS's defor_depth 1: the only depth built)
    dX, ds, dr = Linear(ReLU(Linear(ReLU(f_d)))), one head each
    X' = X + dX, s' = s + ds, r' = r + dr

The bilinear sample is written out as four corner gathers (`index_select`
of the flattened plane) and their weights, K-Planes' grid_sample settings
by hand: align_corners (a coordinate of -1 or 1 lands on the first or last
cell), border padding (the cell coordinate clamped to [0, N - 1]), and
the border counted as outside for the coordinate's gradient (a clamped
coordinate, or one on the border, sends none back). Gradients come from
autograd. The field runs over blocks of slots under activation
checkpointing (BLOCK_SLOTS), so that three steps at 4.2 M slots fit on the
card; then `gs`' SH (from X'), sky, loss and Adam through `gs_posed`'
blocked compositor, the loss plus K-Planes' plane regularisers: plane TV
on the spatial planes, the mean square of the second difference along
time on the time planes, and the mean of |1 - R| on the time planes, each
summed over planes and scales and weighted. TF32 is off (gs.no_tf32).
Imports nothing of the measured package.

Departures from the paper and its code, beside those of the
configuration (configs/deform4d_waymo3.json): t^ spans [-1, 1] over the
clip (the code feeds its time as it comes); the three spatial planes take
K-Planes' TV; the planes are multiplied in the order xy, xz, yz, xt, yt,
zt; the learning rates decay exponentially with no delay phase.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from . import gs, gs_posed

SPACE_PAIRS = ((0, 1), (0, 2), (1, 2))
TIME_PAIRS = ((0, 3), (1, 3), (2, 3))
HEADS = (("means", 3), ("scales", 3), ("quats", 4))
FIELD = ("planes", "decoder")
BLOCK_SLOTS = 2 ** 19


def plane_shapes(cfg: dict) -> list:
    """The planes in the flat order: per scale, xy, xz, yz (C, R, R),
    then xt, yt, zt (C, N_t, R)."""
    c, nt = cfg["plane_channels"], cfg["time_cells"]
    out = []
    for l in cfg["plane_scales"]:
        r = cfg["plane_base_resolution"] * l
        out += [(c, r, r)] * 3 + [(c, nt, r)] * 3
    return out


def decoder_shapes(cfg: dict) -> list:
    """(name, shape) of the decoder's tensors in the flat order."""
    if cfg["defor_depth"] != 1:
        raise ValueError(f"defor_depth {cfg['defor_depth']}: the decoder "
                         "is one Linear (depth 1)")
    w = cfg["net_width"]
    out = [("w0", (w, len(cfg["plane_scales"]) * cfg["plane_channels"])),
           ("b0", (w,))]
    for name, k in HEADS:
        out += [(f"{name}.w1", (w, w)), (f"{name}.b1", (w,)),
                (f"{name}.w2", (k, w)), (f"{name}.b2", (k,))]
    return out


def _split(flat, shapes) -> list:
    out, off = [], 0
    for s in shapes:
        n = math.prod(s)
        out.append(flat[off:off + n].reshape(s))
        off += n
    assert off == flat.numel(), (off, flat.numel())
    return out


def _cell(u, n: int):
    """The cell coordinate of u in [-1, 1] over n cells (align_corners),
    clamped to [0, n - 1]; its gradient passes strictly inside only."""
    x = (u + 1.0) / 2.0 * (n - 1)
    inside = (x > 0) & (x < n - 1)
    return torch.where(inside, x, torch.clamp(x, 0, n - 1).detach())


def bilinear(plane, u, v):
    """plane (C, H, W) at (u (N,) along W, v (N,) along H): (C, N) by
    four corner gathers."""
    c, h, w = plane.shape
    x, y = _cell(u, w), _cell(v, h)
    x0f, y0f = torch.floor(x).detach(), torch.floor(y).detach()
    fx, fy = x - x0f, y - y0f
    x0, y0 = x0f.long(), y0f.long()
    x1, y1 = torch.clamp(x0 + 1, max=w - 1), torch.clamp(y0 + 1, max=h - 1)
    flat = plane.reshape(c, h * w)

    def at(yy, xx):
        return flat.index_select(1, yy * w + xx)
    return (at(y0, x0) * ((1 - fx) * (1 - fy)) + at(y0, x1) * (fx * (1 - fy))
            + at(y1, x0) * ((1 - fx) * fy) + at(y1, x1) * (fx * fy))


def encode(planes, xh, th, cfg: dict):
    """f_h (len(scales) C, N) at (x^ (N, 3), t^ (0-d or (1,)))."""
    views = _split(planes, plane_shapes(cfg))
    coords = [xh[:, 0], xh[:, 1], xh[:, 2], th.reshape(()).expand(
        xh.shape[0])]
    feats = []
    for s in range(len(cfg["plane_scales"])):
        f = 1.0
        for k, (i, j) in enumerate(SPACE_PAIRS + TIME_PAIRS):
            f = f * bilinear(views[6 * s + k], coords[i], coords[j])
        feats.append(f)
    return torch.cat(feats, 0)


def decode(decoder, f, cfg: dict):
    """[dX (N, 3), ds (N, 3), dr (N, 4)] from f_h (channels, N)."""
    v = dict(zip([n for n, _ in decoder_shapes(cfg)],
                 _split(decoder, [s for _, s in decoder_shapes(cfg)])))
    h = torch.relu(f.t() @ v["w0"].t() + v["b0"])
    return [torch.relu(h @ v[f"{n}.w1"].t() + v[f"{n}.b1"]) @ v[f"{n}.w2"].t()
            + v[f"{n}.b2"] for n, _ in HEADS]


def normalise(means, t, aabb, time_span):
    xh = 2.0 * (means - aabb[0]) / (aabb[1] - aabb[0]) - 1.0
    th = 2.0 * (t - time_span[0]) / (time_span[1] - time_span[0]) - 1.0
    return xh, th


def field(means, planes, decoder, aabb, time_span, t, cfg: dict,
          block: int = BLOCK_SLOTS):
    """(dX, ds, dr) of every slot at time t (a 0-d float32 tensor), over
    blocks of `block` slots, each under checkpointing."""
    def one(m, planes, decoder):
        xh, th = normalise(m, t, aabb, time_span)
        return torch.cat(decode(decoder, encode(planes, xh, th, cfg), cfg),
                         -1)
    parts = [checkpoint(one, means[i:i + block], planes, decoder,
                        use_reentrant=False)
             for i in range(0, means.shape[0], block)]
    d = torch.cat(parts, 0)
    return d[:, 0:3], d[:, 3:6], d[:, 6:10]


def regularizers(planes, cfg: dict):
    """The weighted sum of the three plane regularisers."""
    views = _split(planes, plane_shapes(cfg))
    tv = smooth = l1 = 0.0
    for s in range(len(cfg["plane_scales"])):
        for p in views[6 * s:6 * s + 3]:
            c, h, w = p.shape
            dh = ((p[:, 1:, :] - p[:, :-1, :]) ** 2).sum() / (c * (h - 1) * w)
            dw = ((p[:, :, 1:] - p[:, :, :-1]) ** 2).sum() / (c * h * (w - 1))
            tv = tv + 2.0 * (dh + dw)
        for p in views[6 * s + 3:6 * s + 6]:
            d1 = p[:, 1:, :] - p[:, :-1, :]
            smooth = smooth + ((d1[:, 1:, :] - d1[:, :-1, :]) ** 2).mean()
            l1 = l1 + (1.0 - p).abs().mean()
    return (cfg["plane_tv_weight"] * tv
            + cfg["time_smoothness_weight"] * smooth
            + cfg["l1_time_planes_weight"] * l1)


def forward(p: dict, cam: dict, degree: int, cfg: dict, training: bool,
            jitter=None, block: int = BLOCK_SLOTS):
    """The cloud's render of one camera at its time; p holds "bg/<leaf>",
    "bg/active", "env_map" and "field/<planes, decoder, aabb,
    time_span>"."""
    t = torch.tensor(cam["time"], dtype=torch.float32,
                     device=p["bg/means"].device)
    dx, ds, dr = field(p["bg/means"], p["field/planes"], p["field/decoder"],
                       p["field/aabb"], p["field/time_span"], t, cfg, block)
    means = p["bg/means"] + dx
    active = p["bg/active"]
    op = torch.sigmoid(p["bg/opacities"][:, 0])
    op = torch.where(active, op, torch.zeros_like(op))
    dc = gs.fourier_dc(p["bg/features_dc"], torch.zeros(()))
    rgbs = gs.sh_rgb(means, dc, p["bg/features_rest"], cam["c2w"][:3, 3],
                     degree)
    sky = gs.sky_rgb(p["env_map"], cam, jitter if training else None)
    return gs_posed.render(means, torch.exp(p["bg/scales"] + ds),
                           p["bg/quats"] + dr, op, rgbs, cam, sky, training,
                           active)


def leaf_names(sc: dict) -> list:
    """The trained leaves: the cloud's six groups, the sky, the planes and
    the decoder."""
    return [f"bg/{g}" for g in gs_posed.LEAF_GROUPS] + [
        "env_map", "field/planes", "field/decoder"]


def lr_at(leaf: str, step: int, field_lr: dict) -> float:
    """gs.lr_at for the cloud's groups and the sky; a field leaf's from
    `field_lr` ({"planes": [lr, final], "decoder": ..., "max_steps"}), in
    the same float32 exponential schedule."""
    group = leaf.split("/")[-1]
    if not leaf.startswith("field/"):
        return gs.lr_at(group, step)
    lr, final = field_lr[group]
    t = np.clip(np.float32(step) / np.float32(field_lr["max_steps"]), 0, 1)
    return float(np.float32(lr) * np.power(np.float32(final / lr), t,
                                           dtype=np.float32))


def reference_steps(sc: dict, steps: list, degree: int, cfg: dict,
                    block: int = BLOCK_SLOTS) -> dict:
    """The first steps from the cloud's and the field's leaves `sc`: steps
    [(step, camera, target (H, W, 3), semantic (H, W, 1), jitter
    (2, H, W))], every leaf of leaf_names stepped by Adam, the cloud's
    inactive rows' gradients zeroed, the loss with the plane regularisers
    (the field is live at every step given). Returns {"losses",
    "first_grad", "change", "decoder_parts"} as host floats:
    decoder_parts holds the norm of the decoder's first gradient in each
    of its tensors (decoder_shapes' names)."""
    gs.no_tf32()
    names = leaf_names(sc)
    fixed = {k: sc[k] for k in sc if k not in names}
    p = {k: sc[k].detach().clone() for k in names}
    p0 = {k: v.clone() for k, v in p.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    act = fixed["bg/active"]
    losses, first = [], {}
    for i, (step, cam, img, sem, jitter) in enumerate(steps):
        leaves = {k: p[k].requires_grad_(True) for k in names}
        out = forward({**leaves, **fixed}, cam, degree, cfg, training=True,
                      jitter=jitter, block=block)
        loss = gs.loss(out, img, sem) + regularizers(leaves["field/planes"],
                                                     cfg)
        grads = torch.autograd.grad(loss, [leaves[k] for k in names])
        losses.append(float(loss.detach()))
        with torch.no_grad():
            for k, g in zip(names, grads):
                if k.startswith("bg/"):
                    a = act.reshape(act.shape + (1,) * (g.dim() - 1))
                    g = torch.where(a, g, torch.zeros_like(g))
                if i == 0:
                    first[k] = float(torch.linalg.vector_norm(g))
                    if k == "field/decoder":
                        parts = decoder_part_norms(g, cfg)
                p[k], m[k], v2[k] = gs.adam(
                    p[k].detach(), g, m[k], v2[k], i + 1,
                    lr_at(k, step, cfg["field_lr"]))
        del out, loss, grads, leaves
    change = {k: float(torch.linalg.vector_norm(p[k] - p0[k])) for k in names}
    return {"losses": losses, "first_grad": first, "change": change,
            "decoder_parts": parts}


def decoder_part_norms(flat, cfg: dict) -> dict:
    """{name: norm} of a flat decoder-shaped tensor's parts."""
    shapes = decoder_shapes(cfg)
    return {n: float(torch.linalg.vector_norm(v)) for (n, _), v in zip(
        shapes, _split(flat, [s for _, s in shapes]))}
