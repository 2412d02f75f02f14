"""Kernel L: the EWA projection of every slot in one launch forward and one
backward (`csrc/project.cu`), behind core.projection.project for CUDA
tensors. Its forward specification, and what CPU tensors run, is the
plain version core.projection._project_plain; its backward specification
is `_project_vjp_plain` below, the closed form of autograd's gradient
through the plain version.

`project_cuda` is an autograd Function: the forward launches once and
keeps only its inputs (no intermediate a slot); the backward launches once
(with a second, one-block pass where the view matrix is differentiated)
and returns the gradients of the means, scales, quaternions, the view
matrix and the centre offset, from those of the centres, depths, conics
and the blur compensation."""
from __future__ import annotations

import ctypes

import torch

from ..core.projected import BLUR_2D, CLIP_THRESH, Projected
from ..utils.profiling import span
from . import _cuda

_P = ctypes.c_void_p
_L = ctypes.c_longlong
_I = ctypes.c_int
_F = ctypes.c_float

PROJECT_KERNEL = _cuda.register(_cuda.Kernel(
    name="project",
    source="project.cu",
    replaces="none: street_gaussians_ns_tpu/core/projection.py project is "
             "jnp code that XLA fuses",
    entries={
        "sg_project_fwd": (_P, _L, _P, _L, _P, _L, _P, _P, _P, _L, _P,
                           _P, _P, _P, _P, _I, _I, _I, _F,
                           _P, _P, _P, _P, _P, _P, _P, _L, _P),
        "sg_project_bwd": (_P, _L, _P, _L, _P, _L, _P, _P, _P, _P, _P,
                           _I, _I, _F, _P, _L, _L, _P, _L, _P, _L, _L,
                           _P, _L, _P, _P, _P, _P, _L, _P, _L, _P)},
))

# Threads a block in both launches; the backward's view-matrix partials
# are 12 doubles a block.
THREADS = 256
_NULL = ctypes.c_void_p(None)


def _opt(t):
    return _cuda.ptr(t) if t is not None else _NULL


def _check_camera(viewmat, intrinsics) -> None:
    _cuda.check(viewmat, "viewmat", torch.float32, shape=(4, 4))
    for name, v in zip(("fx", "fy", "cx", "cy"), intrinsics):
        if not isinstance(v, torch.Tensor):
            raise TypeError(f"{name}: expected a 0-d float32 tensor, got "
                            f"{type(v).__name__}")
        _cuda.check(v, name, torch.float32, shape=())
        if v.requires_grad:
            raise ValueError(f"{name}: the intrinsics are not "
                             f"differentiated")


def _check_device(*tensors) -> torch.device:
    """The one CUDA device of every operand given; raises otherwise."""
    devs = {t.device for t in tensors if t is not None}
    if len(devs) != 1 or next(iter(devs)).type != "cuda":
        raise ValueError(f"kernel L needs its operands on one CUDA device, "
                         f"got {sorted(map(str, devs))}")
    return devs.pop()


def _check_rows(t, name, n, cols):
    _cuda.check(t, name, torch.float32, shape=(n, cols), strided_rows=True)


def project_fwd(means, scales, quats, viewmat, fx, fy, cx, cy, width: int,
                height: int, tile_size: int, clip_thresh: float,
                opacities=None, active=None, xys_offset=None) -> Projected:
    """One forward launch on the current stream. means, scales (N, 3) and
    quats (N, 4) float32 may be row-strided views (a unit column stride);
    opacities (N,) float32, active (N,) bool contiguous; xys_offset (N, 2)
    float32 row-strided; viewmat (4, 4) float32 contiguous; fx..cy 0-d
    float32; all on one CUDA device."""
    n = means.shape[0]
    _check_rows(means, "means", n, 3)
    _check_rows(scales, "scales", n, 3)
    _check_rows(quats, "quats", n, 4)
    _check_camera(viewmat, (fx, fy, cx, cy))
    if opacities is not None:
        _cuda.check(opacities, "opacities", torch.float32, shape=(n,))
    if active is not None:
        _cuda.check(active, "active", torch.bool, shape=(n,))
    if xys_offset is not None:
        _check_rows(xys_offset, "xys_offset", n, 2)
    if tile_size <= 0 or width <= 0 or height <= 0:
        raise ValueError(f"bad frame {width}x{height} / tile {tile_size}")
    dev = _check_device(means, scales, quats, viewmat, fx, fy, cx, cy,
                        opacities, active, xys_offset)
    f32, i32 = dict(dtype=torch.float32, device=dev), dict(dtype=torch.int32,
                                                          device=dev)
    xys = torch.empty((n, 2), **f32)
    depths = torch.empty((n,), **f32)
    radii = torch.empty((n,), **i32)
    conics = torch.empty((n, 3), **f32)
    comp = torch.empty((n,), **f32)
    tiles = torch.empty((n,), **i32)
    box = torch.empty((n, 4), **i32)
    PROJECT_KERNEL.launch(
        "sg_project_fwd", _cuda.ptr(means), means.stride(0),
        _cuda.ptr(scales), scales.stride(0), _cuda.ptr(quats),
        quats.stride(0), _opt(opacities), _opt(active), _opt(xys_offset),
        xys_offset.stride(0) if xys_offset is not None else 0,
        _cuda.ptr(viewmat), _cuda.ptr(fx), _cuda.ptr(fy), _cuda.ptr(cx),
        _cuda.ptr(cy), width, height, tile_size, clip_thresh,
        _cuda.ptr(xys), _cuda.ptr(depths), _cuda.ptr(radii),
        _cuda.ptr(conics), _cuda.ptr(comp), _cuda.ptr(tiles),
        _cuda.ptr(box), n, _cuda.stream(means))
    return Projected(xys=xys, depths=depths, radii=radii, conics=conics,
                     comp=comp, num_tiles_hit=tiles, tile_box=box)


def _check_grad(g, name, shape):
    if g is None:
        return
    if g.dtype != torch.float32 or tuple(g.shape) != shape:
        raise ValueError(f"{name}: expected float32 {shape}, got {g.dtype} "
                         f"{tuple(g.shape)}")


def project_bwd(means, scales, quats, viewmat, fx, fy, cx, cy, width: int,
                height: int, clip_thresh: float, g_xys=None, g_depths=None,
                g_conics=None, g_comp=None, view_grad: bool = False):
    """One backward launch on the current stream (and a one-block second
    pass for the view matrix when view_grad): (d_means (N, 3), d_scales
    (N, 3), d_quats (N, 4), d_viewmat (4, 4) or None) from the gradients
    of the centres (N, 2), depths (N,), conics (N, 3) and compensation
    (N,), float32 with any strides, each None where nothing was given."""
    n = means.shape[0]
    _check_rows(means, "means", n, 3)
    _check_rows(scales, "scales", n, 3)
    _check_rows(quats, "quats", n, 4)
    _check_camera(viewmat, (fx, fy, cx, cy))
    _check_grad(g_xys, "g_xys", (n, 2))
    _check_grad(g_depths, "g_depths", (n,))
    _check_grad(g_conics, "g_conics", (n, 3))
    _check_grad(g_comp, "g_comp", (n,))
    dev = _check_device(means, scales, quats, viewmat, fx, fy, cx, cy,
                        g_xys, g_depths, g_conics, g_comp)
    f32 = dict(dtype=torch.float32, device=dev)
    d_means = torch.empty((n, 3), **f32)
    d_scales = torch.empty((n, 3), **f32)
    d_quats = torch.empty((n, 4), **f32)
    d_view = partials = None
    if view_grad:
        d_view = torch.empty((4, 4), **f32)
        partials = torch.empty((-(-n // THREADS) * 12,), dtype=torch.float64,
                               device=dev)

    def strides(g, k):
        return tuple(g.stride()) if g is not None else (0,) * k

    PROJECT_KERNEL.launch(
        "sg_project_bwd", _cuda.ptr(means), means.stride(0),
        _cuda.ptr(scales), scales.stride(0), _cuda.ptr(quats),
        quats.stride(0), _cuda.ptr(viewmat), _cuda.ptr(fx), _cuda.ptr(fy),
        _cuda.ptr(cx), _cuda.ptr(cy), width, height, clip_thresh,
        _opt(g_xys), *strides(g_xys, 2), _opt(g_depths),
        *strides(g_depths, 1), _opt(g_conics), *strides(g_conics, 2),
        _opt(g_comp), *strides(g_comp, 1), _cuda.ptr(d_means),
        _cuda.ptr(d_scales), _cuda.ptr(d_quats), _opt(partials),
        partials.numel() if partials is not None else 0, _opt(d_view), n,
        _cuda.stream(means), modes=("bwd",))
    return d_means, d_scales, d_quats, d_view


class _Project(torch.autograd.Function):
    """Kernel L forward and backward as one autograd node: means, scales,
    quats, viewmat and xys_offset are differentiated; the opacities, the
    active mask and the intrinsics are not. The integer outputs are not
    differentiable; a gradient not given (an output nobody used) is
    skipped, not read as zeros."""

    @staticmethod
    def forward(ctx, means, scales, quats, viewmat, xys_offset, fx, fy, cx,
                cy, opacities, active, width, height, tile_size,
                clip_thresh):
        p = project_fwd(means, scales, quats, viewmat, fx, fy, cx, cy,
                        width, height, tile_size, clip_thresh, opacities,
                        active, xys_offset)
        ctx.mark_non_differentiable(p.radii, p.num_tiles_hit, p.tile_box)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(means, scales, quats, viewmat, fx, fy, cx, cy)
        ctx.frame = (width, height, clip_thresh)
        return (p.xys, p.depths, p.radii, p.conics, p.comp, p.num_tiles_hit,
                p.tile_box)

    @staticmethod
    def backward(ctx, g_xys, g_depths, _radii, g_conics, g_comp, _tiles,
                 _box):
        means, scales, quats, viewmat, fx, fy, cx, cy = ctx.saved_tensors
        need = ctx.needs_input_grad
        with span("render.project_bwd"):
            d_means, d_scales, d_quats, d_view = project_bwd(
                means, scales, quats, viewmat, fx, fy, cx, cy, *ctx.frame,
                g_xys, g_depths, g_conics, g_comp, view_grad=need[3])
        return (d_means if need[0] else None, d_scales if need[1] else None,
                d_quats if need[2] else None, d_view,
                g_xys if need[4] else None) + (None,) * 10


def project_cuda(means, scales, quats, viewmat, fx, fy, cx, cy, width: int,
                 height: int, tile_size: int = 16,
                 clip_thresh: float = CLIP_THRESH,
                 opacities=None, active=None, xys_offset=None) -> Projected:
    """core.projection.project by kernel L (see there for the arguments)."""
    out = _Project.apply(means, scales, quats, viewmat, xys_offset, fx, fy,
                         cx, cy, None if opacities is None
                         else opacities.detach(), active, int(width),
                         int(height), int(tile_size), float(clip_thresh))
    return Projected(*out)


def _project_vjp_plain(means, scales, quats, viewmat, fx, fy, cx, cy,
                       width: int, height: int,
                       clip_thresh: float = CLIP_THRESH, g_xys=None,
                       g_depths=None, g_conics=None, g_comp=None):
    """The gradients (d_means, d_scales, d_quats, d_viewmat) of
    core.projection._project_plain's centres, depths, conics and
    compensation, given theirs (None: not given), in closed form: kernel
    L's backward specification, which the kernel equals bit for bit in
    float32 on the card (the view matrix's sums aside, which it adds in
    float64; tests/test_torch_cuda.py and chip_smoke.py hold it to this
    on the card, tests/test_torch_project.py holds this to autograd in
    float64). The forward's values are formed as the
    plain version forms them; the subgradients are autograd's: the
    inclusive edge of a clamp, half each way at a tie of minimum /
    maximum, zero to the branch a where does not take; behind the near
    clip, the view depth's gradient passes only to the depth. Any float
    dtype; d_viewmat is (4, 4) with a zero last row."""
    dt = means.dtype
    z = torch.zeros_like(means[:, 0])
    R = viewmat[:3, :3].to(dt)
    t = viewmat[:3, 3].to(dt)
    m = [means[:, i] for i in range(3)]
    px = R[0, 0] * m[0] + R[0, 1] * m[1] + R[0, 2] * m[2] + t[0]
    py = R[1, 0] * m[0] + R[1, 1] * m[1] + R[1, 2] * m[2] + t[1]
    tz = R[2, 0] * m[0] + R[2, 1] * m[1] + R[2, 2] * m[2] + t[2]
    valid = tz > clip_thresh
    tzs = torch.where(valid, tz, torch.ones_like(tz))

    q = [quats[:, i] for i in range(4)]
    n2 = torch.sum(quats * quats, dim=-1)
    tiny = n2 < 1e-24
    den = torch.sqrt(torch.where(tiny, torch.ones_like(n2), n2))
    qn = [torch.where(tiny, qi, qi / den) for qi in q]
    w, x, y, zq = qn
    r = [[1 - 2 * (y * y + zq * zq), 2 * (x * y - w * zq),
          2 * (x * zq + w * y)],
         [2 * (x * y + w * zq), 1 - 2 * (x * x + zq * zq),
          2 * (y * zq - w * x)],
         [2 * (x * zq - w * y), 2 * (y * zq + w * x),
          1 - 2 * (x * x + y * y)]]
    sc = [scales[:, k] for k in range(3)]
    s = [v * v for v in sc]
    cov = [[sum(r[i][k] * r[j][k] * s[k] for k in range(3))
            for j in range(3)] for i in range(3)]

    lim_x = 1.3 * (0.5 * width / fx)
    lim_y = 1.3 * (0.5 * height / fy)
    ux, uy = px / tzs, py / tzs
    mxx = torch.maximum(ux, -lim_x)
    mxy = torch.maximum(uy, -lim_y)
    clx = torch.minimum(mxx, lim_x)
    cly = torch.minimum(mxy, lim_y)
    tx, ty = clx * tzs, cly * tzs
    rz = 1.0 / tzs
    rz2 = rz * rz
    j00, j11 = fx * rz, fy * rz
    j02, j12 = -fx * tx * rz2, -fy * ty * rz2
    T = [[j00 * R[0, k] + j02 * R[2, k] for k in range(3)],
         [j11 * R[1, k] + j12 * R[2, k] for k in range(3)]]
    u = [sum(T[0][j] * cov[j][k] for j in range(3)) for k in range(3)]
    v = [sum(T[1][j] * cov[j][k] for j in range(3)) for k in range(3)]
    a = sum(u[k] * T[0][k] for k in range(3))
    b = sum(u[k] * T[1][k] for k in range(3))
    c = sum(v[k] * T[1][k] for k in range(3))
    ab, cb = a + BLUR_2D, c + BLUR_2D
    det_orig = a * c - b * b
    det = ab * cb - b * b
    det_ok = det > 0
    dw = torch.where(det_ok, det, torch.ones_like(det))

    # The centres: (fx px) rz + cx, (fy py) rz + cy.
    gx = g_xys[:, 0] if g_xys is not None else z
    gy = g_xys[:, 1] if g_xys is not None else z
    g_px = gx * rz * fx
    g_py = gy * rz * fy
    g_rz = gx * (fx * px) + gy * (fy * py)
    # The conics: (c + blur, -b, a + blur) / dw.
    g0, g1, g2 = ((g_conics[:, i] for i in range(3)) if g_conics is not None
                  else (z, z, z))
    g_ab, g_cb, g_b = g2 / dw, g0 / dw, -g1 / dw
    g_dw = -(g0 * cb - g1 * b + g2 * ab) / (dw * dw)
    g_do = z
    if g_comp is not None:
        # comp = sqrt(clamp(det_orig / dw, min=0)).
        ratio = det_orig / dw
        comp = torch.sqrt(torch.clamp(ratio, min=0.0))
        g_ratio = torch.where(ratio >= 0, g_comp / (2 * comp), z)
        g_do = g_ratio / dw
        g_dw = g_dw - g_ratio * ratio / dw
    g_det = torch.where(det_ok, g_dw, z)
    g_a = g_ab + g_det * cb + g_do * c
    g_c = g_cb + g_det * ab + g_do * a
    g_b = g_b - 2 * b * (g_det + g_do)

    # a = T0 S T0', b = T0 S T1', c = T1 S T1'.
    g_T = [[2 * g_a * u[k] + g_b * v[k] for k in range(3)],
           [g_b * u[k] + 2 * g_c * v[k] for k in range(3)]]
    # The gradient of each of the six components: c_ij (i < j) stands for
    # both S_ij and S_ji.
    g_cov = [[(g_a * T[0][i] * T[0][i] + g_b * T[0][i] * T[1][i]
               + g_c * T[1][i] * T[1][i]) if i == j else
              (2 * g_a * T[0][i] * T[0][j]
               + g_b * (T[0][i] * T[1][j] + T[0][j] * T[1][i])
               + 2 * g_c * T[1][i] * T[1][j])
              for j in range(3)] for i in range(3)]
    g_R = [[z, z, z], [z, z, z], [z, z, z]]
    g_j00 = g_j02 = g_j11 = g_j12 = z
    for k in range(3):
        g_j00 = g_j00 + g_T[0][k] * R[0, k]
        g_j02 = g_j02 + g_T[0][k] * R[2, k]
        g_j11 = g_j11 + g_T[1][k] * R[1, k]
        g_j12 = g_j12 + g_T[1][k] * R[2, k]
        g_R[0][k] = g_R[0][k] + g_T[0][k] * j00
        g_R[1][k] = g_R[1][k] + g_T[1][k] * j11
        g_R[2][k] = g_R[2][k] + g_T[0][k] * j02 + g_T[1][k] * j12
    g_rz = g_rz + g_j00 * fx + g_j11 * fy
    g_rz2 = g_j02 * (-fx * tx) + g_j12 * (-fy * ty)
    g_tx = g_j02 * rz2 * -fx
    g_ty = g_j12 * rz2 * -fy
    g_rz = g_rz + 2 * rz * g_rz2
    g_tzs = -g_rz * rz * rz + g_tx * clx + g_ty * cly

    def clamp_grad(g, u_, mx_, lim):
        # minimum(mx_, lim), then maximum(u_, -lim), as autograd splits them.
        g = torch.where(mx_ == lim, g / 2, torch.where(mx_ > lim, z, g))
        return torch.where(u_ == -lim, g / 2, torch.where(u_ < -lim, z, g))

    g_ux = clamp_grad(g_tx * tzs, ux, mxx, lim_x)
    g_uy = clamp_grad(g_ty * tzs, uy, mxy, lim_y)
    g_px = g_px + g_ux / tzs
    g_py = g_py + g_uy / tzs
    g_tzs = g_tzs - (g_ux * ux + g_uy * uy) / tzs
    g_tz = torch.where(valid, g_tzs, z)
    if g_depths is not None:
        g_tz = g_tz + g_depths
    g_cam = (g_px, g_py, g_tz)
    d_means = torch.stack([g_px * R[0, j] + g_py * R[1, j] + g_tz * R[2, j]
                           for j in range(3)], dim=-1)
    for i in range(3):
        for j in range(3):
            g_R[i][j] = g_R[i][j] + g_cam[i] * m[j]

    # The covariance: c_ij = sum_k r_ik r_jk s_k.
    g_r = [[sum((2 if i == j else 1) * g_cov[min(i, j)][max(i, j)]
                * r[j][k] for j in range(3)) * s[k] for k in range(3)]
           for i in range(3)]
    g_s = [sum(g_cov[i][j] * r[i][k] * r[j][k]
               for i in range(3) for j in range(i, 3)) for k in range(3)]
    d_scales = torch.stack([2 * g_s[k] * sc[k] for k in range(3)], dim=-1)
    G = g_r
    g_w = 2 * (-zq * G[0][1] + y * G[0][2] + zq * G[1][0] - x * G[1][2]
               - y * G[2][0] + x * G[2][1])
    g_x = 2 * (y * G[0][1] + zq * G[0][2] + y * G[1][0] - 2 * x * G[1][1]
               - w * G[1][2] + zq * G[2][0] + w * G[2][1] - 2 * x * G[2][2])
    g_y = 2 * (-2 * y * G[0][0] + x * G[0][1] + w * G[0][2] + x * G[1][0]
               + zq * G[1][2] - w * G[2][0] + zq * G[2][1] - 2 * y * G[2][2])
    g_z = 2 * (-2 * zq * G[0][0] - w * G[0][1] + x * G[0][2] + w * G[1][0]
               - 2 * zq * G[1][1] + y * G[1][2] + x * G[2][0] + y * G[2][1])
    g_qn = (g_w, g_x, g_y, g_z)
    dot = sum(gi * qi for gi, qi in zip(g_qn, q))
    d_quats = torch.stack([torch.where(tiny, gi, gi / den - qi * dot
                                       / (den * den * den))
                           for gi, qi in zip(g_qn, q)], dim=-1)
    d_view = torch.zeros((4, 4), dtype=dt, device=means.device)
    for i in range(3):
        for j in range(3):
            d_view[i, j] = g_R[i][j].sum()
        d_view[i, 3] = g_cam[i].sum()
    return d_means, d_scales, d_quats, d_view
