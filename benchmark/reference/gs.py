"""Plain PyTorch reference of the scene graph and Splatfacto pipelines.

It follows the published description (gsplat v0.1 `project_gaussians`,
the classic alpha compositor with 1/255 skip and 1e-4 saturation, real SH
to degree 3, the Street Gaussians scene graph with Fourier DC and a sky
cubemap, L1 + SSIM + sky-accumulation losses, Adam), written here without
kernels: the pairs a tile holds are enumerated directly from the coverage
contour, and the compositor walks every tile's depth-sorted list in chunks
with `torch.cumprod`, so autograd gives the backward. Nothing here imports
the measured package; it reads only the inputs the benchmark makes.

Arithmetic that the port shares with its JAX original (the projection's
componentwise order, the coverage contour, the cubemap taps) is a frozen
copy of that plain formulation, so float32 results agree to rounding.
"""
from __future__ import annotations

import math

import numpy as np
import torch

T_EPS = 1e-4
ALPHA_THRESH = 1.0 / 255.0
ALPHA_CLAMP = 0.999
SIGMA_MIN = -1e-3
CLIP_THRESH = 0.01
BLUR_2D = 0.3
TILE = 16
SH_C0 = 0.28209479177387814
DEPTH_FAR = 10.0
SKY_SEMANTIC = 2


def no_tf32() -> None:
    """float32 matrix products in float32 (not TF32) on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# --------------------------------------------------------------------------
# Quaternions (wxyz).
# --------------------------------------------------------------------------

def q_normalize(q):
    n2 = torch.sum(q * q, dim=-1, keepdim=True)
    tiny = n2 < 1e-24
    return torch.where(tiny, q, q / torch.sqrt(torch.where(
        tiny, torch.ones_like(n2), n2)))


def q_rotmat(q):
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r = torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        dim=-1)
    return r.reshape(q.shape[:-1] + (3, 3))


def q_mul(a, b):
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([aw * bw - ax * bx - ay * by - az * bz,
                        aw * bx + ax * bw + ay * bz - az * by,
                        aw * by - ax * bz + ay * bw + az * bx,
                        aw * bz + ax * by - ay * bx + az * bw], dim=-1)


def q_slerp(q0, q1, t):
    q0, q1 = q_normalize(q0), q_normalize(q1)
    dot = torch.sum(q0 * q1, dim=-1, keepdim=True)
    q1 = torch.where(dot < 0, -q1, q1)
    dot = torch.clamp(dot.abs(), -1.0, 1.0)
    theta = torch.arccos(dot)
    s = torch.sin(theta)
    lerp = s < 1e-6
    safe = torch.where(lerp, torch.ones_like(s), s)
    w0 = torch.where(lerp, 1 - t, torch.sin((1 - t) * theta) / safe)
    w1 = torch.where(lerp, t, torch.sin(t * theta) / safe)
    return q_normalize(w0 * q0 + w1 * q1)


# --------------------------------------------------------------------------
# The scene graph: boxes at a time, objects posed into the world.
# --------------------------------------------------------------------------

def fourier_dc(dc, t):
    """dc (..., N, F, 3) at time t (...,): even k cos(t k 2pi/F), odd k
    sin(t (k+1) 2pi/F), summed first to last."""
    F = dc.shape[-2]
    t = torch.as_tensor(t, dtype=torch.float32, device=dc.device)[..., None]
    k = torch.arange(F, dtype=torch.float32, device=dc.device)
    basis = torch.where(torch.arange(F, device=dc.device) % 2 == 0,
                        torch.cos(t * k * (2 * math.pi / F)),
                        torch.sin(t * (k + 1) * (2 * math.pi / F)))
    out = dc[..., 0, :] * basis[..., 0, None, None]
    for i in range(1, F):
        out = out + dc[..., i, :] * basis[..., i, None, None]
    return out


def boxes_at(tracks: dict, t: float, delta_center, delta_yaw):
    """The "simple" bbox mode: the exact frame or SLERP / lerp between the
    bracketing frames; the deltas (detached) apply at exact frames."""
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
    quats = q_slerp(tracks["quats"][i0], tracks["quats"][i1], w)
    v0, v1 = tracks["valid"][i0], tracks["valid"][i1]
    visible = (v0 if float(w) <= 0 else v1 if float(w) >= 1 else v0 & v1)
    visible = visible & in_range
    span = tracks["obj_last"] - tracks["obj_first"]
    frame_pos = float(i0) + w
    t_norm = torch.where(span > 0, (frame_pos - tracks["obj_first"])
                         / torch.clamp(span, min=1e-6), torch.ones_like(span))
    if exact or float(w) <= 0:
        fi = i1 if exact else i0
        centers = centers + delta_center[fi].detach()
        dy = delta_yaw[fi].detach()
        z = torch.zeros_like(dy)
        quats = q_mul(quats, torch.stack([torch.cos(dy), z, z,
                                          torch.sin(dy)], -1))
    return centers, quats, visible, t_norm


def flat_scene(p: dict, tracks, t: float):
    """Background + posed objects as one splat set. `p` holds the store's
    leaves as "bg/<name>", "obj/<name>" and "env_map", "delta_center",
    "delta_yaw"; tracks is None for the single-model pipeline. Returns
    (means, log scales, quats, DC, rest, logit opacities, active, n_bg)."""
    bg_dc = fourier_dc(p["bg/features_dc"], torch.zeros(()))
    if tracks is None:
        return (p["bg/means"], p["bg/scales"], p["bg/quats"], bg_dc,
                p["bg/features_rest"], p["bg/opacities"], p["bg/active"],
                p["bg/means"].shape[0])
    centers, bq, visible, t_norm = boxes_at(tracks, t, p["delta_center"],
                                            p["delta_yaw"])
    R = q_rotmat(q_normalize(bq))
    om = torch.einsum("oij,ocj->oci", R, p["obj/means"]) + centers[:, None]
    oq = q_mul(bq[:, None, :], p["obj/quats"])
    odc = fourier_dc(p["obj/features_dc"], t_norm)

    def cat(a, b):
        return torch.cat([a, b.reshape((-1,) + b.shape[2:])], 0)
    return (cat(p["bg/means"], om), cat(p["bg/scales"], p["obj/scales"]),
            cat(p["bg/quats"], oq), cat(bg_dc, odc),
            cat(p["bg/features_rest"], p["obj/features_rest"]),
            cat(p["bg/opacities"], p["obj/opacities"]),
            cat(p["bg/active"], p["obj/active"] & visible[:, None]),
            p["bg/means"].shape[0])


# --------------------------------------------------------------------------
# Colours: SH, sky.
# --------------------------------------------------------------------------

_C1 = 0.4886025119029199
_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
       -1.0925484305920792, 0.5462742152960396)
_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
       0.3731763325901154, -0.4570457994644658, 1.445305721320277,
       -0.5900435899266435)


def sh_rgb(means, dc, rest, cam_pos, degree: int):
    """clamp(sum_k coeff_k basis_k(view dir) + 0.5, 0); directions from
    the camera centre, detached."""
    d = means.detach() - cam_pos
    d = d / torch.clamp(torch.linalg.vector_norm(d, dim=-1, keepdim=True),
                        min=1e-12)
    x, y, z = d[:, 0], d[:, 1], d[:, 2]
    xx, yy, zz, xy, yz, xz = x * x, y * y, z * z, x * y, y * z, x * z
    basis = [SH_C0 * torch.ones_like(x), -_C1 * y, _C1 * z, -_C1 * x,
             _C2[0] * xy, _C2[1] * yz, _C2[2] * (2 * zz - xx - yy),
             _C2[3] * xz, _C2[4] * (xx - yy),
             _C3[0] * y * (3 * xx - yy), _C3[1] * xy * z,
             _C3[2] * y * (4 * zz - xx - yy),
             _C3[3] * z * (2 * zz - 3 * xx - 3 * yy),
             _C3[4] * x * (4 * zz - xx - yy), _C3[5] * z * (xx - yy),
             _C3[6] * x * (xx - 3 * yy)]
    k = rest.shape[1] + 1
    out = basis[0][:, None] * dc
    for i in range(1, min(k, (degree + 1) ** 2)):
        out = out + basis[i][:, None] * rest[:, i - 1]
    return torch.clamp(out + 0.5, min=0.0)


def pixel_dirs(cam: dict, jitter=None):
    H, W = cam["height"], cam["width"]
    dev = cam["c2w"].device
    u = torch.arange(W, dtype=torch.float32, device=dev)[None].expand(H, W)
    v = torch.arange(H, dtype=torch.float32, device=dev)[:, None].expand(H, W)
    if jitter is None:
        u, v = u + 0.5, v + 0.5
    else:
        u, v = u + jitter[0], v + jitter[1]
    d = torch.stack([(u - cam["cx"]) / cam["fx"], (v - cam["cy"]) / cam["fy"],
                     torch.ones_like(u)], -1)
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    R = cam["c2w"][:3, :3]
    return (d[..., 0:1] * R[:, 0] + d[..., 1:2] * R[:, 1]
            + d[..., 2:3] * R[:, 2])


def sky_rgb(env, cam: dict, jitter=None):
    """Bilinear cubemap lookup (faces +x,-x,+y,-y,+z,-z, clamped at face
    edges) along the pixel rays mapped to the cubemap frame (x, z, -y)."""
    w = pixel_dirs(cam, jitter).detach()
    x, y, z = w[..., 0], w[..., 2], -w[..., 1]
    ax, ay, az = x.abs(), y.abs(), z.abs()
    is_x = (ax >= ay) & (ax >= az)
    is_y = ~is_x & (ay >= az)
    ma = torch.where(is_x, ax, torch.where(is_y, ay, az)).clamp(min=1e-12)
    face = torch.where(is_x, torch.where(x >= 0, 0, 1), torch.where(
        is_y, torch.where(y >= 0, 2, 3), torch.where(z >= 0, 4, 5)))
    u = torch.where(is_x, torch.where(x >= 0, -z, z), torch.where(
        is_y, x, torch.where(z >= 0, x, -x)))
    v = torch.where(is_x, -y, torch.where(is_y, torch.where(y >= 0, z, -z),
                                          -y))
    R = env.shape[1]
    fx = 0.5 * (u / ma + 1.0) * R - 0.5
    fy = 0.5 * (v / ma + 1.0) * R - 0.5
    x0, y0 = torch.floor(fx), torch.floor(fy)
    wx, wy = (fx - x0)[..., None], (fy - y0)[..., None]

    def tap(xi, yi):
        return env[face, yi.clamp(0, R - 1).long(), xi.clamp(0, R - 1).long()]
    return (tap(x0, y0) * (1 - wx) * (1 - wy) + tap(x0 + 1, y0) * wx * (1 - wy)
            + tap(x0, y0 + 1) * (1 - wx) * wy
            + tap(x0 + 1, y0 + 1) * wx * wy)


# --------------------------------------------------------------------------
# Projection (EWA, gsplat v0.1) and the pairs a tile holds.
# --------------------------------------------------------------------------

def viewmat(c2w):
    R = c2w[:3, :3] * torch.tensor([1.0, -1.0, -1.0], device=c2w.device)
    Rt = R.T
    return Rt, -(Rt @ c2w[:3, 3:4])[:, 0]


def coverage_q(op):
    return torch.clamp(2.0 * torch.log(torch.clamp(op, min=1e-12) * 255.0),
                       max=9.0)


def project(means, scales, quats, op, cam: dict):
    """(xys, depth, conics, visible, tile box [x0, x1, y0, y1), q)."""
    Rwc, twc = viewmat(cam["c2w"])
    fx, fy, cx, cy = (torch.tensor(cam[k], dtype=torch.float32,
                                   device=means.device)
                      for k in ("fx", "fy", "cx", "cy"))
    W, H = cam["width"], cam["height"]
    mx, my, mz = means[:, 0], means[:, 1], means[:, 2]
    px = Rwc[0, 0] * mx + Rwc[0, 1] * my + Rwc[0, 2] * mz + twc[0]
    py = Rwc[1, 0] * mx + Rwc[1, 1] * my + Rwc[1, 2] * mz + twc[1]
    tz = Rwc[2, 0] * mx + Rwc[2, 1] * my + Rwc[2, 2] * mz + twc[2]
    valid = tz > CLIP_THRESH
    tzs = torch.where(valid, tz, torch.ones_like(tz))
    n2 = torch.sum(quats * quats, -1, keepdim=True)
    tiny = n2 < 1e-24
    q = torch.where(tiny, quats, quats / torch.sqrt(torch.where(
        tiny, torch.ones_like(n2), n2)))
    w, x, y, z = q.unbind(-1)
    r = [[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
         [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
         [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]]
    s = [scales[:, i] ** 2 for i in range(3)]

    def cov(i, j):
        return (r[i][0] * r[j][0] * s[0] + r[i][1] * r[j][1] * s[1]
                + r[i][2] * r[j][2] * s[2])
    c00, c01, c02, c11, c12, c22 = (cov(0, 0), cov(0, 1), cov(0, 2),
                                    cov(1, 1), cov(1, 2), cov(2, 2))
    lim_x, lim_y = 1.3 * 0.5 * W / fx, 1.3 * 0.5 * H / fy
    tx = torch.minimum(torch.maximum(px / tzs, -lim_x), lim_x) * tzs
    ty = torch.minimum(torch.maximum(py / tzs, -lim_y), lim_y) * tzs
    rz = 1.0 / tzs
    rz2 = rz * rz
    j00, j02 = fx * rz, -fx * tx * rz2
    j11, j12 = fy * rz, -fy * ty * rz2
    t0 = [j00 * Rwc[0, k] + j02 * Rwc[2, k] for k in range(3)]
    t1 = [j11 * Rwc[1, k] + j12 * Rwc[2, k] for k in range(3)]
    u0 = t0[0] * c00 + t0[1] * c01 + t0[2] * c02
    u1 = t0[0] * c01 + t0[1] * c11 + t0[2] * c12
    u2 = t0[0] * c02 + t0[1] * c12 + t0[2] * c22
    v0 = t1[0] * c00 + t1[1] * c01 + t1[2] * c02
    v1 = t1[0] * c01 + t1[1] * c11 + t1[2] * c12
    v2 = t1[0] * c02 + t1[1] * c12 + t1[2] * c22
    a = u0 * t0[0] + u1 * t0[1] + u2 * t0[2] + BLUR_2D
    b = u0 * t1[0] + u1 * t1[1] + u2 * t1[2]
    c = v0 * t1[0] + v1 * t1[1] + v2 * t1[2] + BLUR_2D
    det = a * c - b * b
    ok = det > 0
    ds = torch.where(ok, det, torch.ones_like(det))
    conics = torch.stack([c / ds, -b / ds, a / ds], -1)
    qv = coverage_q(op.detach())
    rx = torch.ceil(torch.sqrt(torch.clamp(qv * a, min=1e-8))).detach()
    ry = torch.ceil(torch.sqrt(torch.clamp(qv * c, min=1e-8))).detach()
    xys = torch.stack([fx * px * rz + cx, fy * py * rz + cy], -1)
    ntx, nty = -(-W // TILE), -(-H // TILE)
    xd, yd = xys[:, 0].detach(), xys[:, 1].detach()

    def bound(v, plus, hi):
        return torch.clamp(torch.floor(v / TILE) + plus, 0, hi).long()
    x0, y0 = bound(xd - rx, 0, ntx), bound(yd - ry, 0, nty)
    x1, y1 = bound(xd + rx, 1, ntx), bound(yd + ry, 1, nty)
    visible = valid & ok & (qv > 0)
    x1 = torch.where(visible, torch.maximum(x1, x0), x0)
    y1 = torch.where(visible, torch.maximum(y1, y0), y0)
    box = torch.stack([x0, x1, y0, y1], -1)
    return xys, tz, conics, visible, box, qv


def row_range(conic, xy, box, ty, q):
    """Tile columns [x0, x1) of tile row ty that the q-contour ellipse
    a dx^2 + 2 b dx dy + c dy^2 = q covers, clipped to the tile box."""
    a = torch.clamp(conic[:, 0], min=1e-12)
    b = conic[:, 1]
    c = torch.clamp(conic[:, 2], min=1e-12)
    q = torch.clamp(q, min=0.0)
    ylo = (ty * TILE).float()
    yhi = ylo + TILE
    cx_, cy_ = xy[:, 0], xy[:, 1]
    det = torch.clamp(a * c - b * b, min=1e-12)
    dym = torch.sqrt(q * a / det)
    dlo = torch.minimum(torch.maximum(ylo - cy_, -dym), dym)
    dhi = torch.minimum(torch.maximum(yhi - cy_, -dym), dym)
    valid = (ylo - cy_ <= dym) & (yhi - cy_ >= -dym) & (q > 0)
    dyv = -torch.sqrt(q) * b / torch.sqrt(det * c)

    def sx(dy, sign):
        return (-b * dy + sign * torch.sqrt(torch.clamp(
            q * a - det * dy * dy, min=0.0))) / a

    def clip(v, lo, hi):
        return torch.minimum(torch.maximum(v, lo), hi)
    x_hi = cx_ + sx(clip(dyv, dlo, dhi), 1.0)
    x_lo = cx_ + sx(clip(-dyv, dlo, dhi), -1.0)

    def fl(v):
        return torch.floor(v).clamp(-2.0 ** 30, 2.0 ** 30).long()
    x0 = torch.minimum(torch.maximum(fl(x_lo / TILE), box[:, 0]), box[:, 1])
    x1 = torch.minimum(torch.maximum(fl(x_hi / TILE) + 1, x0), box[:, 1])
    return x0, torch.where(valid, x1, x0)


def tile_pairs(xys, depth, conics, visible, box, q, ntx, nty):
    """The (gaussian, tile) pairs the coverage contour admits, sorted by
    tile then depth (ties by index). Returns (gaussian ids, tile starts
    (ntx * nty + 1,))."""
    with torch.no_grad():
        ids = torch.nonzero(visible).squeeze(1)
        order = torch.sort(depth[ids], stable=True).indices
        ids = ids[order]
        rank_of = torch.full_like(visible, -1, dtype=torch.long)
        rank_of[ids] = torch.arange(ids.numel(), device=ids.device)
        vid = torch.nonzero(visible).squeeze(1)
        nrows = (box[vid, 3] - box[vid, 2]).clamp(min=0)
        g = torch.repeat_interleave(vid, nrows)
        first = torch.cumsum(nrows, 0) - nrows
        ty = box[g, 2] + (torch.arange(g.numel(), device=g.device)
                          - torch.repeat_interleave(first, nrows))
        x0, x1 = row_range(conics[g], xys[g], box[g], ty, q[g])
        ncol = (x1 - x0).clamp(min=0)
        gp = torch.repeat_interleave(g, ncol)
        f2 = torch.cumsum(ncol, 0) - ncol
        tx = torch.repeat_interleave(x0, ncol) + (
            torch.arange(gp.numel(), device=g.device)
            - torch.repeat_interleave(f2, ncol))
        tile = torch.repeat_interleave(ty, ncol) * ntx + tx
        key = tile * ids.numel() + rank_of[gp]
        key, perm = torch.sort(key)
        gp = gp[perm]
        counts = torch.bincount(tile, minlength=ntx * nty)
        starts = torch.zeros(ntx * nty + 1, dtype=torch.long,
                             device=g.device)
        starts[1:] = torch.cumsum(counts, 0)
    return gp, starts


# --------------------------------------------------------------------------
# The compositor: each tile's list front to back, chunk by chunk.
# --------------------------------------------------------------------------

def composite(xys, conics, op, colors, gp, starts, W, H, chunk_elems=24e6):
    """Front-to-back alpha compositing of every tile's sorted pairs.
    Returns (img (H, W, C), T_final (H, W), evaluations, contributing):
    an evaluation is a (pixel, pair) the pixel reaches before it
    saturates (the pair that saturates it included), a contributing one
    passes both skip tests before saturation."""
    dev = xys.device
    ntx, nty = -(-W // TILE), -(-H // TILE)
    nt = ntx * nty
    C = colors.shape[1]
    lens = starts[1:] - starts[:-1]
    lx = (torch.arange(TILE * TILE, device=dev) % TILE).float()
    ly = (torch.arange(TILE * TILE, device=dev) // TILE).float()
    act = torch.arange(nt, device=dev)
    tx, ty = act % ntx, act // ntx
    px_all = tx[:, None].float() * TILE + lx + 0.5
    py_all = ty[:, None].float() * TILE + ly + 0.5
    inside_all = (px_all < W) & (py_all < H)
    done = ~inside_all
    T = torch.ones((nt, TILE * TILE), device=dev)
    pos = torch.zeros(nt, dtype=torch.long, device=dev)
    keep = (lens > 0) & ~done.all(1)
    fin_idx, fin_T, add_idx, add_val = [], [], [], []
    fin_idx.append(act[~keep])
    fin_T.append(T[~keep])
    act, T, done, pos = act[keep], T[keep], done[keep], pos[keep]
    evals = torch.zeros((), dtype=torch.long, device=dev)
    contribs = torch.zeros((), dtype=torch.long, device=dev)
    P = max(int(gp.numel()), 1)
    while act.numel():
        na = act.numel()
        B = int(max(4, min(1024, 2 ** int(math.log2(max(
            chunk_elems / (na * TILE * TILE), 1))))))
        idx = (starts[act] + pos)[:, None] + torch.arange(B, device=dev)
        valid = idx < starts[act + 1][:, None]
        g = gp[idx.clamp(max=P - 1)]
        pxa = px_all[act][:, :, None]
        pya = py_all[act][:, :, None]
        dx = xys[g, 0][:, None, :] - pxa
        dy = xys[g, 1][:, None, :] - pya
        cg = conics[g]
        sigma = (0.5 * (cg[..., 0][:, None, :] * dx * dx
                        + cg[..., 2][:, None, :] * dy * dy)
                 + cg[..., 1][:, None, :] * dx * dy)
        alpha = torch.clamp(op[g][:, None, :] * torch.exp(
            -torch.clamp(sigma, min=0.0)), max=ALPHA_CLAMP)
        live = valid[:, None, :] & ~done[:, :, None]
        considered = live & (sigma >= SIGMA_MIN) & (alpha >= ALPHA_THRESH)
        a = torch.where(considered, alpha, torch.zeros_like(alpha))
        one_minus = 1.0 - a
        T_after = T[:, :, None] * torch.cumprod(one_minus, dim=2)
        term = considered & (T_after <= T_EPS)
        nterm = torch.cumsum(term.to(torch.int32), 2)
        contrib = considered & (nterm == 0)
        reached = live & ((nterm - term.to(torch.int32)) == 0)
        T_before = torch.cat([T[:, :, None], T_after[:, :, :-1]], 2)
        w = torch.where(contrib, a * T_before, torch.zeros_like(a))
        add_idx.append(act)
        add_val.append(torch.einsum("npb,nbc->npc", w, colors[g]))
        evals = evals + reached.sum()
        contribs = contribs + contrib.sum()
        T = T * torch.prod(torch.where(contrib, one_minus,
                                       torch.ones_like(one_minus)), 2)
        done = done | term.any(2)
        pos = pos + B
        keep = (pos < lens[act]) & ~done.all(1)
        fin_idx.append(act[~keep])
        fin_T.append(T[~keep])
        act, T, done, pos = act[keep], T[keep], done[keep], pos[keep]
    fi = torch.cat(fin_idx)
    T_tiles = torch.ones((nt, TILE * TILE), device=dev).index_put(
        (fi,), torch.cat(fin_T))
    acc = torch.zeros((nt, TILE * TILE, C), device=dev)
    if add_idx:
        acc = acc.index_add(0, torch.cat(add_idx), torch.cat(add_val))

    def image(x):
        x = x.reshape(nty, ntx, TILE, TILE, -1).permute(0, 2, 1, 3, 4)
        return x.reshape(nty * TILE, ntx * TILE, -1)[:H, :W]
    return image(acc), image(T_tiles[..., None])[..., 0], evals, contribs


# --------------------------------------------------------------------------
# One render, the scene-graph forward and the losses.
# --------------------------------------------------------------------------

def render(means, scales_lin, quats, opac, rgbs, cam, sky=None,
           training=False, active=None, counts=None):
    """ops/render semantics: rgb and depth as one 4-channel colour, rgb
    clamped to <= 1, the sky behind, alpha-normalised depth with far fill,
    rgb clamped to [0, 1] outside training."""
    W, H = cam["width"], cam["height"]
    xys, depth, conics, visible, box, q = project(means, scales_lin, quats,
                                                  opac, cam)
    if active is not None:
        visible = visible & active
    ntx, nty = -(-W // TILE), -(-H // TILE)
    gp, starts = tile_pairs(xys, depth, conics, visible, box, q, ntx, nty)
    colors = torch.cat([rgbs, depth[:, None]], -1)
    img, T, ev, co = composite(xys, conics, opac, colors, gp, starts, W, H)
    if counts is not None:
        counts["pairs"] = counts.get("pairs", 0) + int(gp.numel())
        counts["evals"] = counts.get("evals", 0) + int(ev)
        counts["contrib"] = counts.get("contrib", 0) + int(co)
        counts["gaussians"] = counts.get("gaussians", 0) + int(
            visible.sum())
    alpha = (1.0 - T)[..., None]
    rgb = torch.clamp(img[..., :3], max=1.0)
    if sky is not None:
        rgb = rgb * alpha + sky * (1.0 - alpha)
    if not training:
        rgb = torch.clamp(rgb, 0.0, 1.0)
    d = torch.where(alpha > 1e-3, img[..., 3:4] / torch.clamp(alpha, min=1e-3),
                    torch.full_like(alpha, DEPTH_FAR))
    return {"rgb": rgb, "accumulation": alpha, "depth": d}


def forward(p: dict, tracks, cam: dict, degree: int, training: bool,
            jitter=None, extras: bool = False, counts=None):
    """The scene graph's (or, with tracks None, Splatfacto's) render of
    one camera; with extras the object-only and background-only renders
    and their heads."""
    means, scales, quats, dc, rest, opl, active, n_bg = flat_scene(
        p, tracks, cam["time"])
    rgbs = sh_rgb(means, dc, rest, cam["c2w"][:3, 3], degree)
    op = torch.sigmoid(opl[:, 0])
    op = torch.where(active, op, torch.zeros_like(op))
    sl = torch.exp(scales)
    sky = (sky_rgb(p["env_map"], cam, jitter if training else None)
           if p.get("env_map") is not None else None)
    out = render(means, sl, quats, op, rgbs, cam, sky, training, active,
                 counts)
    if extras:
        seg = torch.arange(active.shape[0], device=active.device) >= n_bg
        o = render(means, sl, quats, op, rgbs, cam, None, training,
                   active & seg, counts)
        b = render(means, sl, quats, op, rgbs, cam, None, training,
                   active & ~seg, counts)
        bg_rgb = torch.clamp(b["rgb"], max=1.0)
        if sky is not None:
            bg_rgb = bg_rgb * b["accumulation"] + sky * (1 - b["accumulation"])
        out["background_rgb"] = torch.clamp(bg_rgb, 0.0, 1.0)
        out["object_rgb"] = torch.clamp(o["rgb"], 0.0, 1.0)
    return out


def _window(win=11, sigma=1.5):
    x = np.arange(win, dtype=np.float32) - (win - 1) / 2.0
    g = np.exp(-(x ** 2) / (2.0 * sigma ** 2))
    return g / g.sum()


def _blur(x, win):
    k, h, w = len(win), x.shape[1], x.shape[2]
    out = sum(float(win[i]) * x[:, i:i + h - k + 1, :] for i in range(k))
    return sum(float(win[i]) * out[:, :, i:i + w - k + 1] for i in range(k))


def ssim(a, b):
    """pytorch_msssim SSIM(data_range=1): 11x11 gaussian, sigma 1.5,
    valid padding, the mean over pixels and channels."""
    x, y = a.permute(2, 0, 1), b.permute(2, 0, 1)
    win = _window()
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    m1, m2 = _blur(x, win), _blur(y, win)
    s1 = _blur(x * x, win) - m1 * m1
    s2 = _blur(y * y, win) - m2 * m2
    s12 = _blur(x * y, win) - m1 * m2
    cs = (2 * s12 + c2) / (s1 + s2 + c2)
    return torch.mean((2 * m1 * m2 + c1) / (m1 * m1 + m2 * m2 + c1) * cs)


def loss(out, image, semantic, ssim_lambda=0.2, sky_mult=0.5):
    l1 = torch.mean(torch.abs(image - out["rgb"]))
    total = (1 - ssim_lambda) * l1 + ssim_lambda * (1 - ssim(image,
                                                             out["rgb"]))
    if semantic is not None:
        sky = (semantic == SKY_SEMANTIC).float()
        total = total + sky_mult * torch.mean(sky * out["accumulation"])
    return total


# --------------------------------------------------------------------------
# Adam (torch.optim.Adam's update, eps outside the root) with the
# reference's per-group learning rates.
# --------------------------------------------------------------------------

LR = {"means": (1.6e-4, 1.6e-6), "features_dc": (2.5e-3, None),
      "features_rest": (2.5e-3 / 20, None), "opacities": (5e-2, None),
      "scales": (5e-3, None), "quats": (1e-3, None),
      "env_map": (5e-3, None), "delta_center": (1e-3, 5e-5),
      "delta_yaw": (1e-3, 5e-5)}
MAX_STEPS = 70000


def lr_at(group: str, step: int) -> float:
    lr, final = LR[group]
    if final is None:
        return float(np.float32(lr))
    t = np.clip(np.float32(step) / np.float32(MAX_STEPS), 0, 1)
    return float(np.float32(lr) * np.power(np.float32(final / lr), t,
                                           dtype=np.float32))


def adam(p, g, m, v, count: int, lr: float, b1=0.9, b2=0.999, eps=1e-15):
    c1 = float(1 - np.power(np.float32(b1), np.float32(count)))
    c2 = float(1 - np.power(np.float32(b2), np.float32(count)))
    m = b1 * m + (1 - b1) * g
    v = b2 * v + (1 - b2) * (g * g)
    return p - lr * (m / c1) / (torch.sqrt(v / c2) + eps), m, v
