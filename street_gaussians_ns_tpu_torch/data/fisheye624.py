"""FISHEYE624 (Aria fisheye-rad-tan-thin-prism) camera model + undistortion
(counterpart of street_gaussians_ns_tpu/data/fisheye624.py, a copy).

Closes the one camera-model gap vs the reference: its datamanager supports
PERSPECTIVE / FISHEYE / FISHEYE624 undistortion (sgn_datamanager.py:326-497);
the FISHEYE624 branch (:399-493) delegates the projection math to
nerfstudio's `fisheye624_project` / `fisheye624_unproject_helper`. This
module implements the same 16-parameter model natively in numpy:

    params = [fx, fy, cx, cy, k0..k5, p0, p1, s0..s3]

Forward model for a camera-frame point (x, y, z):
    r      = |(x, y)|,  theta = atan2(r, z)
    radial = 1 + k0 th^2 + k1 th^4 + ... + k5 th^12
    (xr, yr) = radial * theta / r * (x, y)          # equidistant + radial
    tangential: uv += 2 (uv . p) uv + |uv|^2 p      # p = (p0, p1)
    thin prism: u += s0 |uv|^2 + s1 |uv|^4
                v += s2 |uv|^2 + s3 |uv|^4
    pixel: (fx u + cx, fy v + cy)

The unproject helper inverts only the radial part (Newton on theta) — the
same approximation the reference relies on for its FOV estimate
(sgn_datamanager.py:413-428). Undistortion reproduces the reference's
heuristics: output square of side 2*fisheye_crop_radius, focal from the
unmasked FOV, circular validity mask remapped through the same grid
(:430-493). One conscious fix: the reference inherits a meshgrid('ij') /
cv2.remap row-column mixup that only cancels for square symmetric sensors;
we use the conventional (map_x=u, map_y=v) orientation, identical for the
square outputs this branch always produces.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

_EPS = 1e-9


def project(xyz: np.ndarray, params: np.ndarray) -> np.ndarray:
    """Project camera-frame points (N, 3) -> distorted pixels (N, 2)."""
    xyz = np.asarray(xyz, np.float64)
    params = np.asarray(params, np.float64)
    assert params.shape == (16,), params.shape
    fx, fy, cx, cy = params[:4]
    k = params[4:10]
    p = params[10:12]
    s = params[12:16]

    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    r = np.hypot(x, y)
    theta = np.arctan2(r, z)
    th2 = theta * theta
    radial = np.ones_like(theta)
    acc = np.ones_like(theta)
    for ki in k:
        acc = acc * th2
        radial = radial + ki * acc
    # theta/r -> 1/z as r -> 0 (atan2(r, z) ~ r/z); the exact center ray.
    th_div_r = np.where(r > _EPS, theta / np.maximum(r, _EPS),
                        1.0 / np.maximum(z, _EPS))
    u = radial * th_div_r * x
    v = radial * th_div_r * y

    sq = u * u + v * v
    dot2 = 2.0 * (u * p[0] + v * p[1])
    ut = u + dot2 * u + sq * p[0]
    vt = v + dot2 * v + sq * p[1]
    ut = ut + s[0] * sq + s[1] * sq * sq
    vt = vt + s[2] * sq + s[3] * sq * sq
    return np.stack([fx * ut + cx, fy * vt + cy], axis=-1)


def unproject_radial(uv: np.ndarray, params: np.ndarray,
                     iters: int = 20) -> np.ndarray:
    """Unproject distorted pixels (N, 2) -> unit rays (N, 3), inverting the
    radial polynomial only (Newton), like the reference's FOV helper."""
    uv = np.asarray(uv, np.float64)
    params = np.asarray(params, np.float64)
    fx, fy, cx, cy = params[:4]
    k = params[4:10]

    un = (uv[..., 0] - cx) / fx
    vn = (uv[..., 1] - cy) / fy
    th_d = np.hypot(un, vn)            # = theta * radial(theta)

    theta = th_d.copy()
    for _ in range(iters):
        th2 = theta * theta
        radial = np.ones_like(theta)
        dradial = np.zeros_like(theta)   # d(theta*radial)/dtheta - radial
        acc = np.ones_like(theta)
        for i, ki in enumerate(k):
            acc = acc * th2
            radial = radial + ki * acc
            dradial = dradial + (2 * i + 2) * ki * acc
        f = theta * radial - th_d
        df = radial + dradial
        theta = theta - f / np.maximum(df, _EPS)
    theta = np.maximum(theta, 0.0)

    sin_t, cos_t = np.sin(theta), np.cos(theta)
    inv = np.where(th_d > _EPS, 1.0 / np.maximum(th_d, _EPS), 0.0)
    return np.stack([sin_t * un * inv, sin_t * vn * inv, cos_t], axis=-1)


def undistort_frame_fisheye624(
    image: np.ndarray,
    params: np.ndarray,               # (16,) fx fy cx cy k0..k5 p0 p1 s0..s3
    fisheye_crop_radius: float,
    semantic: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, Tuple[float, float, float, float],
           np.ndarray, Optional[np.ndarray]]:
    """Undistort one FISHEYE624 frame to a pinhole image.

    Mirrors sgn_datamanager.py:399-493: FOV from unprojecting the 4 crop-
    circle boundary points, square output of side 2*crop_radius, focal
    h / (2 tan(fov/2)), remap through the forward model, circular validity
    mask remapped alongside. Returns (image, (fx, fy, cx, cy), mask,
    semantic)."""
    from ..utils.optional import opencv

    cv2 = opencv()
    params = np.asarray(params, np.float64)
    cx, cy = params[2], params[3]
    rad = float(fisheye_crop_radius)

    edge = np.array([[cx, cy - rad], [cx, cy + rad],
                     [cx - rad, cy], [cx + rad, cy]])
    upper, lower, left, right = unproject_radial(edge, params)

    def _angle(a, b):
        c = np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b))
        return float(np.arccos(np.clip(c, -1.0, 1.0)))

    fov = max(_angle(upper, lower), _angle(left, right))

    side = int(rad * 2)
    focal = side / (2.0 * np.tan(fov / 2.0))
    ncx = (side - 1) / 2.0
    ncy = (side - 1) / 2.0

    # Undistorted pixel grid -> rays -> distorted source coordinates.
    u, v = np.meshgrid(np.arange(side, dtype=np.float64),
                       np.arange(side, dtype=np.float64), indexing="xy")
    rays = np.stack([(u - ncx) / focal, (v - ncy) / focal,
                     np.ones_like(u)], axis=-1)
    dist_uv = project(rays.reshape(-1, 3), params).reshape(side, side, 2)
    map_x = dist_uv[..., 0].astype(np.float32)
    map_y = dist_uv[..., 1].astype(np.float32)

    out = cv2.remap(image, map_x, map_y, interpolation=cv2.INTER_LINEAR)

    h, w = image.shape[:2]
    yy, xx = np.mgrid[:h, :w].astype(np.float64)
    circ = (np.hypot(yy - h // 2, xx - w // 2) < rad).astype(np.uint8) * 255
    mask = (cv2.remap(circ, map_x, map_y, interpolation=cv2.INTER_LINEAR,
                      borderMode=cv2.BORDER_CONSTANT, borderValue=0)
            >= 255)[..., None]

    if semantic is not None:
        semantic = cv2.remap(
            semantic.astype(np.int32)[..., 0], map_x, map_y,
            interpolation=cv2.INTER_NEAREST)[..., None]

    return out, (float(focal), float(focal), float(ncx), float(ncy)), \
        mask, semantic
