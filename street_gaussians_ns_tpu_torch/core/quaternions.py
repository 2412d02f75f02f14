"""Quaternion algebra in PyTorch (counterpart of
street_gaussians_ns_tpu/core/quaternions.py).

Convention: wxyz (scalar-first). All functions broadcast over leading axes.
"""
from __future__ import annotations

import math

import torch


def normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Normalize quaternions (..., 4) to unit norm; a zero quaternion is
    returned unchanged (inactive store slots hold all-zero quats)."""
    n2 = torch.sum(q * q, dim=-1, keepdim=True)
    tiny = n2 < eps * eps
    norm = torch.sqrt(torch.where(tiny, torch.ones_like(n2), n2))
    return torch.where(tiny, q, q / norm)


def to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (..., 4) wxyz -> rotation matrix (..., 3, 3)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    r = torch.stack(
        [
            1.0 - 2.0 * (yy + zz), 2.0 * (xy - wz), 2.0 * (xz + wy),
            2.0 * (xy + wz), 1.0 - 2.0 * (xx + zz), 2.0 * (yz - wx),
            2.0 * (xz - wy), 2.0 * (yz + wx), 1.0 - 2.0 * (xx + yy),
        ],
        dim=-1,
    )
    return r.reshape(q.shape[:-1] + (3, 3))


def multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a*b, wxyz. Broadcasts over leading axes."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def from_rotmat(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> unit quaternion (..., 4) wxyz by
    Shepperd's method (the best-conditioned of four forms)."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    def _s(v):
        return torch.sqrt(torch.clamp(v, min=1e-12)) * 2.0

    s = _s(1.0 + tr)
    qw = torch.stack([0.25 * s, (m21 - m12) / s, (m02 - m20) / s,
                      (m10 - m01) / s], -1)
    s = _s(1.0 + m00 - m11 - m22)
    qx = torch.stack([(m21 - m12) / s, 0.25 * s, (m01 + m10) / s,
                      (m02 + m20) / s], -1)
    s = _s(1.0 - m00 + m11 - m22)
    qy = torch.stack([(m02 - m20) / s, (m01 + m10) / s, 0.25 * s,
                      (m12 + m21) / s], -1)
    s = _s(1.0 - m00 - m11 + m22)
    qz = torch.stack([(m10 - m01) / s, (m02 + m20) / s, (m12 + m21) / s,
                      0.25 * s], -1)
    cands = torch.stack([tr, m00 - m11 - m22, m11 - m00 - m22,
                         m22 - m00 - m11], -1)
    idx = torch.argmax(cands, dim=-1)[..., None]
    q = torch.where(idx == 0, qw,
                    torch.where(idx == 1, qx, torch.where(idx == 2, qy, qz)))
    return normalize(q)


def shoemake_quats(u: torch.Tensor) -> torch.Tensor:
    """Unit quaternions (n, 4) wxyz from uniforms u (3, n) in [0, 1) by
    Shoemake's subgroup algorithm; uniform on the rotation group when the
    rows are independent uniform draws."""
    u0, v, w = u[0], u[1], u[2]
    two_pi = 2.0 * math.pi
    return torch.stack([
        torch.sqrt(1.0 - u0) * torch.sin(two_pi * v),
        torch.sqrt(1.0 - u0) * torch.cos(two_pi * v),
        torch.sqrt(u0) * torch.sin(two_pi * w),
        torch.sqrt(u0) * torch.cos(two_pi * w),
    ], dim=-1)


def slerp(q0: torch.Tensor, q1: torch.Tensor, t) -> torch.Tensor:
    """Spherical linear interpolation between unit quaternions (wxyz),
    along the short arc; lerp for nearly parallel quats. `t` is a scalar
    or has q0's leading shape."""
    q0 = normalize(q0)
    q1 = normalize(q1)
    dot = torch.sum(q0 * q1, dim=-1, keepdim=True)
    q1 = torch.where(dot < 0.0, -q1, q1)
    dot = torch.clamp(torch.abs(dot), -1.0, 1.0)
    theta = torch.arccos(dot)
    sin_theta = torch.sin(theta)
    use_lerp = sin_theta < 1e-6
    t = torch.as_tensor(t, dtype=q0.dtype, device=q0.device)
    if t.dim() == q0.dim() - 1:
        t = t[..., None]
    safe_sin = torch.where(use_lerp, torch.ones_like(sin_theta), sin_theta)
    w0 = torch.where(use_lerp, 1.0 - t, torch.sin((1.0 - t) * theta) / safe_sin)
    w1 = torch.where(use_lerp, t, torch.sin(t * theta) / safe_sin)
    return normalize(w0 * q0 + w1 * q1)
