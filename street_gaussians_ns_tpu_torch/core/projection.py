"""EWA projection of 3D Gaussians to screen space (counterpart of
street_gaussians_ns_tpu/core/projection.py).

gsplat v0.1 `project_gaussians` semantics: near clip, R diag(s)^2 R^T,
the perspective Jacobian with the 1.3x tan-FOV clamp, the 0.3 px blur
dilation, the blur compensation factor, the conic, the 3-sigma radius,
pixel centers and view depth. The arithmetic is written componentwise in
the JAX package's order, so float32 results agree to rounding and the
integer outputs (radii, tile boxes, tile counts) agree exactly.

`coverage_q`, `ellipse_row_xrange` and `row_tile_range` are the shared
coverage predicate: tile binning enumerates exactly the (gaussian, tile)
pairs it admits, and the per-pixel oracle tests pixels against it.

`project` on CUDA tensors is kernel L (ops/project.py, one launch
forward and one backward); CPU tensors run `_project_plain`, which is
also kernel L's forward specification. The choice is made here, in core,
because every caller reaches the projection through this one function:
ops.render, the models' pair-count probes, parallel.sharded and the
benchmark's Splatfacto step all import core.projection.project, so a
dispatch anywhere above would leave some of them on the plain version.
ops.project imports only core.projected (`Projected` and the constants),
not this module, so the two do not import each other.
"""
from __future__ import annotations

import dataclasses

import torch

from ..ops import _cuda
from ..ops import project as project_kernel
from .projected import BLUR_2D, CLIP_THRESH, Projected


def _floor_int(x: torch.Tensor) -> torch.Tensor:
    """floor(x) as int32, converted as the JAX package converts: values
    past int32's range saturate and NaN becomes 0. The card's conversion
    (cvt.rzi) gives those bits by itself, which the card tests hold against
    the explicit form below, in one launch where the explicit form takes
    five: on an NVIDIA H100 at 1.2 M values, 0.016-0.028 ms of host time a
    call against 0.068-0.093, about 1 ms of a frame's 18 calls. The CPU's
    conversion does not saturate, so there the ends are set explicitly."""
    f = torch.floor(x)
    if f.device.type != "cpu":
        return f.to(torch.int32)
    inside = torch.nan_to_num(f, nan=0.0).clamp(-2.0 ** 31, 2.0 ** 31 - 128)
    return torch.where(f >= 2.0 ** 31, torch.iinfo(torch.int32).max,
                       inside.to(torch.int32))


def compute_cov3d(scales: torch.Tensor, quats: torch.Tensor) -> torch.Tensor:
    """3D covariance R diag(s)^2 R^T (N, 3, 3); scales are linear."""
    from . import quaternions as quat

    R = quat.to_rotmat(quat.normalize(quats))
    M = R * scales[:, None, :]
    return M @ M.transpose(-1, -2)


def _cov3d_components(scales, quats):
    """Upper-triangular 3D covariance as six (N,) tensors."""
    n2 = torch.sum(quats * quats, dim=-1, keepdim=True)
    tiny = n2 < 1e-24
    q = torch.where(tiny, quats,
                    quats / torch.sqrt(torch.where(tiny, torch.ones_like(n2),
                                                   n2)))
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - w * z)
    r02 = 2 * (x * z + w * y)
    r10 = 2 * (x * y + w * z)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - w * x)
    r20 = 2 * (x * z - w * y)
    r21 = 2 * (y * z + w * x)
    r22 = 1 - 2 * (x * x + y * y)
    s0 = scales[:, 0] ** 2
    s1 = scales[:, 1] ** 2
    s2 = scales[:, 2] ** 2
    c00 = r00 * r00 * s0 + r01 * r01 * s1 + r02 * r02 * s2
    c01 = r00 * r10 * s0 + r01 * r11 * s1 + r02 * r12 * s2
    c02 = r00 * r20 * s0 + r01 * r21 * s1 + r02 * r22 * s2
    c11 = r10 * r10 * s0 + r11 * r11 * s1 + r12 * r12 * s2
    c12 = r10 * r20 * s0 + r11 * r21 * s1 + r12 * r22 * s2
    c22 = r20 * r20 * s0 + r21 * r21 * s1 + r22 * r22 * s2
    return c00, c01, c02, c11, c12, c22


def coverage_q(op: torch.Tensor) -> torch.Tensor:
    """Opacity-aware coverage contour level q = min(9, 2 ln(255 op)):
    outside the contour alpha < 1/255 and every compositor skips the
    pair; q <= 0 means the splat is invisible everywhere."""
    return torch.clamp(2.0 * torch.log(torch.clamp(op, min=1e-12) * 255.0),
                       max=9.0)


def ellipse_row_xrange(conic, xys, ylo, yhi, q=9.0):
    """Pixel-x extent (x_lo, x_hi, valid) of the q-contour ellipse
    a dx^2 + 2b dx dy + c dy^2 = q within the pixel-y band [ylo, yhi].
    conic (..., 3), xys (..., 2); ylo/yhi/q broadcast."""
    a = torch.clamp(conic[..., 0], min=1e-12)
    b = conic[..., 1]
    c = torch.clamp(conic[..., 2], min=1e-12)
    q = torch.clamp(torch.as_tensor(q, dtype=a.dtype, device=a.device),
                    min=0.0)
    cx_, cy_ = xys[..., 0], xys[..., 1]
    det = torch.clamp(a * c - b * b, min=1e-12)
    dym = torch.sqrt(q * a / det)
    dlo = torch.minimum(torch.maximum(ylo - cy_, -dym), dym)
    dhi = torch.minimum(torch.maximum(yhi - cy_, -dym), dym)
    valid = (ylo - cy_ <= dym) & (yhi - cy_ >= -dym) & (q > 0.0)
    dy_v = -torch.sqrt(q) * b / torch.sqrt(det * c)

    def slice_x(dy, sign):
        s = torch.sqrt(torch.clamp(q * a - det * dy * dy, min=0.0))
        return (-b * dy + sign * s) / a

    def clip(v, lo, hi):
        return torch.minimum(torch.maximum(v, lo), hi)

    x_hi = cx_ + slice_x(clip(dy_v, dlo, dhi), 1.0)
    x_lo = cx_ + slice_x(clip(-dy_v, dlo, dhi), -1.0)
    return x_lo, x_hi, valid


def row_tile_range(conic, xys, tile_box, ty, tile_size: int, q=9.0):
    """Tile-column range [x0, x1) the q-contour ellipse covers in tile row
    `ty`, clipped to the tile box; x1 == x0 where the row misses. All
    arguments broadcast; returns int32 (x0, x1)."""
    ylo = (ty * tile_size).to(torch.float32)
    x_lo, x_hi, bval = ellipse_row_xrange(conic, xys, ylo,
                                          ylo + float(tile_size), q)
    x0b = tile_box[..., 0]
    x1b = tile_box[..., 1]
    y0b = tile_box[..., 2]
    y1b = tile_box[..., 3]
    x0 = torch.minimum(torch.maximum(_floor_int(x_lo / tile_size), x0b), x1b)
    x1 = torch.minimum(torch.maximum(_floor_int(x_hi / tile_size) + 1, x0),
                       x1b)
    in_row = bval & (ty >= y0b) & (ty < y1b)
    return x0, torch.where(in_row, x1, x0)


def project(
    means: torch.Tensor,
    scales: torch.Tensor,
    quats: torch.Tensor,
    viewmat: torch.Tensor,
    fx, fy, cx, cy,
    width: int,
    height: int,
    tile_size: int = 16,
    clip_thresh: float = CLIP_THRESH,
    opacities: torch.Tensor | None = None,
    active: torch.Tensor | None = None,
    xys_offset: torch.Tensor | None = None,
) -> Projected:
    """Project N Gaussians into screen space. fx..cy are 0-d float32
    tensors. `opacities` ((N,) in [0, 1], the values the compositor
    receives) tightens the tile box to the opacity-aware coverage contour
    (coverage_q); it is not differentiated. `active` ((N,) bool) zeroes
    the radius and tile count of the other slots; `xys_offset` ((N, 2))
    is added to the centres, a hook whose gradient is the centres'.

    Differentiable in means, scales, quats, viewmat and xys_offset. CUDA
    tensors launch kernel L (ops.project) or raise; CPU tensors run
    `_project_plain`."""
    if not _cuda.is_cpu(means, scales, quats, viewmat):
        return project_kernel.project_cuda(
            means, scales, quats, viewmat, fx, fy, cx, cy, width, height,
            tile_size, clip_thresh, opacities, active, xys_offset)
    proj = _project_plain(means, scales, quats, viewmat, fx, fy, cx, cy,
                          width, height, tile_size, clip_thresh, opacities)
    if active is not None:
        proj = dataclasses.replace(
            proj, radii=torch.where(active, proj.radii, 0),
            num_tiles_hit=torch.where(active, proj.num_tiles_hit, 0))
    if xys_offset is not None:
        proj = dataclasses.replace(proj, xys=proj.xys + xys_offset)
    return proj


def _project_plain(means, scales, quats, viewmat, fx, fy, cx, cy,
                   width: int, height: int, tile_size: int = 16,
                   clip_thresh: float = CLIP_THRESH, opacities=None,
                   dtype: torch.dtype = torch.float32) -> Projected:
    """`project` in plain PyTorch, componentwise in the JAX package's
    order, computed in `dtype` (float32 as `project` runs it; the tests
    differentiate it in float64 too)."""
    means = means.to(dtype)
    Rwc = viewmat[:3, :3].to(dtype)
    twc = viewmat[:3, 3].to(dtype)

    mx, my, mz = means[:, 0], means[:, 1], means[:, 2]
    px_v = Rwc[0, 0] * mx + Rwc[0, 1] * my + Rwc[0, 2] * mz + twc[0]
    py_v = Rwc[1, 0] * mx + Rwc[1, 1] * my + Rwc[1, 2] * mz + twc[1]
    tz = Rwc[2, 0] * mx + Rwc[2, 1] * my + Rwc[2, 2] * mz + twc[2]
    valid = tz > clip_thresh
    tz_safe = torch.where(valid, tz, torch.ones_like(tz))

    c00, c01, c02, c11, c12, c22 = _cov3d_components(scales.to(dtype),
                                                     quats.to(dtype))

    tan_fovx = 0.5 * width / fx
    tan_fovy = 0.5 * height / fy
    lim_x = 1.3 * tan_fovx
    lim_y = 1.3 * tan_fovy
    tx = torch.minimum(torch.maximum(px_v / tz_safe, -lim_x), lim_x) * tz_safe
    ty = torch.minimum(torch.maximum(py_v / tz_safe, -lim_y), lim_y) * tz_safe

    rz = 1.0 / tz_safe
    rz2 = rz * rz
    j00 = fx * rz
    j02 = -fx * tx * rz2
    j11 = fy * rz
    j12 = -fy * ty * rz2
    t00 = j00 * Rwc[0, 0] + j02 * Rwc[2, 0]
    t01 = j00 * Rwc[0, 1] + j02 * Rwc[2, 1]
    t02 = j00 * Rwc[0, 2] + j02 * Rwc[2, 2]
    t10 = j11 * Rwc[1, 0] + j12 * Rwc[2, 0]
    t11 = j11 * Rwc[1, 1] + j12 * Rwc[2, 1]
    t12 = j11 * Rwc[1, 2] + j12 * Rwc[2, 2]

    u0 = t00 * c00 + t01 * c01 + t02 * c02
    u1 = t00 * c01 + t01 * c11 + t02 * c12
    u2 = t00 * c02 + t01 * c12 + t02 * c22
    v0 = t10 * c00 + t11 * c01 + t12 * c02
    v1 = t10 * c01 + t11 * c11 + t12 * c12
    v2 = t10 * c02 + t11 * c12 + t12 * c22
    a = u0 * t00 + u1 * t01 + u2 * t02
    b = u0 * t10 + u1 * t11 + u2 * t12
    c = v0 * t10 + v1 * t11 + v2 * t12
    det_orig = a * c - b * b
    a = a + BLUR_2D
    c = c + BLUR_2D
    det = a * c - b * b
    one = torch.ones_like(det)
    comp = torch.sqrt(torch.clamp(det_orig / torch.where(det > 0, det, one),
                                  min=0.0))

    det_ok = det > 0
    det_safe = torch.where(det_ok, det, one)
    conics = torch.stack([c / det_safe, -b / det_safe, a / det_safe], dim=-1)

    mid = 0.5 * (a + c)
    v1 = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radius_f = torch.ceil(3.0 * torch.sqrt(v1))
    qv = coverage_q(opacities.to(dtype)) if opacities is not None else 9.0
    rx = torch.ceil(torch.sqrt(torch.clamp(qv * a, min=1e-8)))
    ry = torch.ceil(torch.sqrt(torch.clamp(qv * c, min=1e-8)))

    center_x = fx * px_v * rz + cx
    center_y = fy * py_v * rz + cy
    xys = torch.stack([center_x, center_y], dim=-1)

    ntx = (width + tile_size - 1) // tile_size
    nty = (height + tile_size - 1) // tile_size

    def tile_bound(v, plus, hi):
        return _floor_int(torch.clamp(torch.floor(v / tile_size) + plus,
                                      0, hi))

    x0 = tile_bound(center_x - rx, 0, ntx)
    y0 = tile_bound(center_y - ry, 0, nty)
    x1 = tile_bound(center_x + rx, 1, ntx)
    y1 = tile_bound(center_y + ry, 1, nty)

    visible = valid & det_ok
    if opacities is not None:
        visible = visible & (qv > 0.0)
    radii = torch.where(visible, radius_f, torch.zeros_like(radius_f)).to(
        torch.int32)
    x1 = torch.where(visible, torch.maximum(x1, x0), x0)
    y1 = torch.where(visible, torch.maximum(y1, y0), y0)
    num_tiles = torch.where(visible, (x1 - x0) * (y1 - y0),
                            torch.zeros_like(x0))

    return Projected(
        xys=xys,
        depths=tz,
        radii=radii,
        conics=conics,
        comp=comp,
        num_tiles_hit=num_tiles,
        tile_box=torch.stack([x0, x1, y0, y1], dim=-1),
    )
