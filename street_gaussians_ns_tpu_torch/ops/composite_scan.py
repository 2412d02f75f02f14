"""Tile-binned alpha compositing one splat at a time, in plain PyTorch
(counterpart of street_gaussians_ns_tpu/ops/composite_jnp.py, the JAX
package's impl="scan"; the module is named for the impl, not for jnp):
the second portable compositor, differentiated by autograd itself.

The semantics of ops.rasterize_ref organised as the production path is:
per-tile splat lists from TileBins, front-to-back masked compositing with
(tiles, pixels) state, and a fixed `max_per_tile` budget: pairs past it
are dropped, exactly as the JAX function drops them (the frozen golden
image was rendered with that truncation). The JAX `lax.scan` over the
per-tile splat axis is a Python loop here, cut short after the densest
tile's last budgeted pair.
"""
from __future__ import annotations

import torch

from .composite_chunked import tiles_to_image
from .rasterize_ref import ALPHA_CLAMP, ALPHA_THRESH, SIGMA_MIN, T_EPS
from .tiles import TileBins


def rasterize_tiles_scan(xys, conics, colors, opacities, bins: TileBins,
                         width: int, height: int, tile_size: int,
                         background: torch.Tensor, max_per_tile: int):
    """Returns (img (H, W, C), alpha (H, W)) from bins that carry
    gauss_idx."""
    if bins.gauss_idx is None:
        raise ValueError("these bins carry no gauss_idx: they must come "
                         "from ops.tiles.bin_gaussians")
    dev = xys.device
    ntx, nty = bins.num_tiles_x, bins.num_tiles_y
    num_tiles = ntx * nty
    P = tile_size * tile_size
    C = colors.shape[-1]
    n = xys.shape[0]
    max_pairs = bins.gauss_idx.shape[0]
    start = bins.tile_start.to(torch.int64)
    count = bins.tile_count.to(torch.int64)

    tid = torch.arange(num_tiles, device=dev)
    lp = torch.arange(P, device=dev)
    px = (((tid % ntx) * tile_size)[:, None] + (lp % tile_size)[None, :]
          ).to(torch.float32) + 0.5
    py = (((tid // ntx) * tile_size)[:, None] + (lp // tile_size)[None, :]
          ).to(torch.float32) + 0.5

    T = torch.ones((num_tiles, P), dtype=torch.float32, device=dev)
    accum = torch.zeros((num_tiles, P, C), dtype=torch.float32, device=dev)
    done = torch.zeros((num_tiles, P), dtype=torch.bool, device=dev)
    zero = torch.zeros_like(T)
    deepest = min(max_per_tile, int(count.max())) if num_tiles else 0
    for m in range(deepest):
        ok = m < count                                           # (T,)
        gidx = bins.gauss_idx[(start + m).clamp(0, max_pairs - 1)]
        gidx = gidx.to(torch.int64).clamp(0, n - 1)
        xy, conic = xys[gidx], conics[gidx]
        dx = xy[:, 0:1] - px                                     # (T, P)
        dy = xy[:, 1:2] - py
        a, b, c = conic[:, 0:1], conic[:, 1:2], conic[:, 2:3]
        sigma = 0.5 * (a * dx * dx + c * dy * dy) + b * dx * dy
        alpha = torch.clamp(
            opacities[gidx][:, None] * torch.exp(-torch.clamp(sigma,
                                                              min=0.0)),
            max=ALPHA_CLAMP)
        considered = (ok[:, None] & (sigma >= SIGMA_MIN)
                      & (alpha >= ALPHA_THRESH) & (~done))
        next_T = T * (1.0 - alpha)
        terminate = considered & (next_T <= T_EPS)
        contributes = considered & (~terminate)
        w = torch.where(contributes, alpha * T, zero)
        accum = accum + w[..., None] * colors[gidx].to(torch.float32)[
            :, None, :]
        T = torch.where(contributes, next_T, T)
        done = done | terminate

    img_tiles = accum + T[..., None] * background[None, None, :]
    return (tiles_to_image(img_tiles, ntx, nty, tile_size, width, height),
            tiles_to_image(1.0 - T, ntx, nty, tile_size, width, height))
