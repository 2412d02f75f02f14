"""Cubemap sampling for the sky model (counterpart of
street_gaussians_ns_tpu/ops/cubemap.py, `cube_faces_uv` and the gather
path of `sample_cubemap`).

Face selection by dominant axis (OpenGL layout, faces +x,-x,+y,-y,+z,-z)
and a bilinear lookup clamped at face edges. The JAX package's one-hot
matmul formulation is a TPU idiom for its slow gathers; on the GPU the
four-tap gather is the direct form.
"""
from __future__ import annotations

import torch


def cube_faces_uv(dirs: torch.Tensor):
    """Direction vectors (..., 3) -> (face (int64), s, t) with s, t in
    [0, 1]; dirs need not be normalized."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    ax, ay, az = x.abs(), y.abs(), z.abs()
    is_x = (ax >= ay) & (ax >= az)
    is_y = (~is_x) & (ay >= az)
    ma = torch.where(is_x, ax, torch.where(is_y, ay, az)).clamp(min=1e-12)
    pos_x, pos_y, pos_z = x >= 0, y >= 0, z >= 0
    face = torch.where(
        is_x, torch.where(pos_x, 0, 1),
        torch.where(is_y, torch.where(pos_y, 2, 3), torch.where(pos_z, 4, 5)))
    u = torch.where(is_x, torch.where(pos_x, -z, z),
                    torch.where(is_y, x, torch.where(pos_z, x, -x)))
    v = torch.where(is_x, -y, torch.where(is_y, torch.where(pos_y, z, -z), -y))
    s = 0.5 * (u / ma + 1.0)
    t = 0.5 * (v / ma + 1.0)
    return face, s, t


def sample_cubemap(cubemap: torch.Tensor, dirs: torch.Tensor,
                   dirs_grad: bool = False) -> torch.Tensor:
    """Bilinear cubemap lookup: cubemap (6, R, R, C), dirs (..., 3) ->
    (..., C), differentiable in the cubemap. With dirs_grad=True the
    gradient also flows through the sampling geometry into `dirs` (camera
    pose optimisation through the sky); otherwise the geometry is
    detached, which skips that part of the backward."""
    R = cubemap.shape[1]
    face, s, t = cube_faces_uv(dirs if dirs_grad else dirs.detach())
    fx = s * R - 0.5
    fy = t * R - 0.5
    x0 = torch.floor(fx)
    y0 = torch.floor(fy)
    wx = (fx - x0)[..., None]
    wy = (fy - y0)[..., None]

    def tap(xi, yi):
        xi = xi.clamp(0, R - 1).to(torch.int64)
        yi = yi.clamp(0, R - 1).to(torch.int64)
        return cubemap[face, yi, xi]

    return (tap(x0, y0) * (1 - wx) * (1 - wy)
            + tap(x0 + 1, y0) * wx * (1 - wy)
            + tap(x0, y0 + 1) * (1 - wx) * wy
            + tap(x0 + 1, y0 + 1) * wx * wy)
