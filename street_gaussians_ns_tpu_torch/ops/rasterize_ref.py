"""Oracle rasterizer: exact, slow, per-pixel scan over depth-sorted
Gaussians (counterpart of street_gaussians_ns_tpu/ops/rasterize_ref.py).

Per pixel, front to back over splats sorted by view depth:
    sigma  = 0.5*(a*dx^2 + c*dy^2) + b*dx*dy       (dx = center - pixel)
    alpha  = min(0.999, opacity * exp(-max(sigma, 0)))
    skip   if sigma < SIGMA_MIN or alpha < ALPHA_THRESH
    next_T = T * (1 - alpha); if next_T <= T_EPS: stop (before accumulating)
    out   += color * alpha * T;  T = next_T
final: out += T * background;  alpha_out = 1 - T
A splat reaches only pixels whose tile its coverage ellipse covers
(core.projection.row_tile_range), the same pair set binning enumerates.
Used by the tests as the reference of the compositors.
"""
from __future__ import annotations

import torch

from ..core.projection import row_tile_range

ALPHA_THRESH = 1.0 / 255.0
ALPHA_CLAMP = 0.999
T_EPS = 1e-4
SIGMA_MIN = -1e-3


def rasterize_reference(xys, depths, radii, conics, colors, opacities,
                        tile_box, width: int, height: int,
                        tile_size: int = 16, background=None):
    """Returns (img (H, W, C), alpha (H, W))."""
    dev = xys.device
    C = colors.shape[-1]
    if background is None:
        background = torch.zeros((C,), dtype=colors.dtype, device=dev)
    visible = radii > 0
    sort_depth = torch.where(visible, depths,
                             torch.full_like(depths, float("inf")))
    order = torch.sort(sort_depth, stable=True).indices

    px = torch.arange(width, dtype=torch.float32, device=dev)[None, :] + 0.5
    py = torch.arange(height, dtype=torch.float32, device=dev)[:, None] + 0.5
    tile_x = (torch.arange(width, device=dev) // tile_size)[None, :]
    tile_y = (torch.arange(height, device=dev) // tile_size)[:, None]

    T = torch.ones((height, width), dtype=torch.float32, device=dev)
    accum = torch.zeros((height, width, C), dtype=torch.float32, device=dev)
    done = torch.zeros((height, width), dtype=torch.bool, device=dev)
    for i in order.tolist():
        if not bool(visible[i]):
            continue
        xy, conic = xys[i], conics[i]
        dx = xy[0] - px
        dy = xy[1] - py
        sigma = (0.5 * (conic[0] * dx * dx + conic[2] * dy * dy)
                 + conic[1] * dx * dy)
        alpha = torch.clamp(
            opacities[i] * torch.exp(-torch.clamp(sigma, min=0.0)),
            max=ALPHA_CLAMP)
        x0r, x1r = row_tile_range(conic[None, None, :], xy[None, None, :],
                                  tile_box[i][None, None, :], tile_y,
                                  tile_size)
        in_box = (tile_x >= x0r) & (tile_x < x1r)
        considered = (in_box & (sigma >= SIGMA_MIN) & (alpha >= ALPHA_THRESH)
                      & ~done)
        next_T = T * (1.0 - alpha)
        terminate = considered & (next_T <= T_EPS)
        contributes = considered & ~terminate
        w = torch.where(contributes, alpha * T, torch.zeros_like(T))
        accum = accum + w[..., None] * colors[i][None, None, :]
        T = torch.where(contributes, next_T, T)
        done = done | terminate
    img = accum + T[..., None] * background[None, None, :]
    return img, 1.0 - T
