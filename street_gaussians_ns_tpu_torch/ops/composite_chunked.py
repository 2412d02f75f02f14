"""Chunk-vectorised tile compositing in plain PyTorch (counterpart of
street_gaussians_ns_tpu/ops/composite_chunked.py): one of the two
portable compositors, differentiated by autograd itself.

Splats are processed `chunk` at a time: the (chunk, pixels) alpha matrix,
the transmittance recurrence as a cumulative product along the chunk, the
skip / termination rules of ops.rasterize_ref reproduced with masks (a
splat that would push T <= 1e-4 contributes nothing, T freezes, and
everything behind it is dead), and the colours accumulated by one
contraction. Across chunks only the per-pixel transmittance and the done
flag survive. The JAX `lax.scan` over chunks is a Python loop here, cut
short after the densest tile's last chunk.

A tile renders at most `max_per_tile` (rounded up to whole chunks) of its
pairs and drops the rest, exactly as the JAX function does: callers hold
`bins.max_tile_count` against the budget. It runs on any device but is
slow and memory-hungry at full width by design; the kernel compositors
(ops.composite) are the production path.
"""
from __future__ import annotations

import torch

from .rasterize_ref import ALPHA_CLAMP, ALPHA_THRESH, SIGMA_MIN, T_EPS
from .tiles import TileBins


def composite_chunk(T_in, done_in, alpha, skip, colors):
    """One chunk of front-to-back compositing, vectorised over K.

    T_in, done_in (..., P); alpha (raw opacity * falloff, before the
    clamp) and skip (..., K, P); colors (..., K, C). Returns (accum_delta
    (..., P, C), T_out (..., P), done_out (..., P))."""
    alpha = torch.clamp(alpha, max=ALPHA_CLAMP)
    active = (~skip) & (alpha >= ALPHA_THRESH) & (~done_in[..., None, :])
    zero = torch.zeros_like(alpha)
    a_eff = torch.where(active, alpha, zero)
    # The running T with every active splat in: right up to the first
    # terminator, which is all that is read from it.
    T_naive = T_in[..., None, :] * torch.cumprod(1.0 - a_eff, dim=-2)
    term = active & (T_naive <= T_EPS)
    done = torch.cumsum(term.to(torch.int32), dim=-2) > 0
    contributes = active & (~done)

    a_c = torch.where(contributes, alpha, zero)
    om = 1.0 - a_c
    cum_incl = torch.cumprod(om, dim=-2)
    # T before splat k, relative to the chunk's entry; om >= 1e-3.
    T_before = T_in[..., None, :] * (cum_incl / om)
    w = a_c * T_before                                        # (..., K, P)
    accum_delta = torch.einsum("...kp,...kc->...pc", w, colors)
    T_out = T_in * cum_incl[..., -1, :]
    done_out = done_in | done[..., -1, :]
    return accum_delta, T_out, done_out


def composite_tiles(xys, conics, colors, opacities, bins: TileBins,
                    tile_ids: torch.Tensor, tile_size: int,
                    max_per_tile: int, chunk: int = 32):
    """Composite the tiles `tile_ids` (T_local,) of bins that carry
    gauss_idx. Returns (accum (T_local, P, C) premultiplied, alpha
    (T_local, P))."""
    if bins.gauss_idx is None:
        raise ValueError("these bins carry no gauss_idx: they must come "
                         "from ops.tiles.bin_gaussians")
    dev = xys.device
    ntx = bins.num_tiles_x
    P = tile_size * tile_size
    M = -(-max_per_tile // chunk) * chunk
    n = xys.shape[0]
    tile_ids = tile_ids.to(torch.int64)
    num_tiles = tile_ids.shape[0]
    C = colors.shape[-1]
    start = bins.tile_start.to(torch.int64)[tile_ids][:, None]
    count = bins.tile_count.to(torch.int64)[tile_ids][:, None]
    colors = colors.to(torch.float32)
    max_pairs = bins.gauss_idx.shape[0]

    lp = torch.arange(P, device=dev)
    px = (((tile_ids % ntx) * tile_size)[:, None] + (lp % tile_size)[None, :]
          ).to(torch.float32) + 0.5
    py = (((tile_ids // ntx) * tile_size)[:, None]
          + (lp // tile_size)[None, :]).to(torch.float32) + 0.5

    T = torch.ones((num_tiles, P), dtype=torch.float32, device=dev)
    done = torch.zeros((num_tiles, P), dtype=torch.bool, device=dev)
    accum = torch.zeros((num_tiles, P, C), dtype=torch.float32, device=dev)
    # Chunks past the densest tile's budgeted pairs change nothing.
    deepest = min(M, int(count.max())) if num_tiles else 0
    for c0 in range(0, deepest, chunk):
        m = torch.arange(c0, c0 + chunk, device=dev)[None, :]   # (1, K)
        ok = m < count                                          # (T, K)
        gidx = bins.gauss_idx[(start + m).clamp(0, max_pairs - 1)]
        gidx = gidx.to(torch.int64).clamp(0, n - 1)
        xy, con = xys[gidx], conics[gidx]
        dx = xy[..., 0:1] - px[:, None, :]                      # (T, K, P)
        dy = xy[..., 1:2] - py[:, None, :]
        a, b, c = con[..., 0:1], con[..., 1:2], con[..., 2:3]
        sigma = 0.5 * (a * dx * dx + c * dy * dy) + b * dx * dy
        alpha = opacities[gidx][..., None] * torch.exp(
            -torch.clamp(sigma, min=0.0))
        skip = (~ok[..., None]) | (sigma < SIGMA_MIN)
        delta, T, done = composite_chunk(T, done, alpha, skip, colors[gidx])
        accum = accum + delta
    return accum, 1.0 - T


def tiles_to_image(tiles: torch.Tensor, ntx: int, nty: int, tile_size: int,
                   width: int, height: int) -> torch.Tensor:
    """(T, P, C) or (T, P) tile-major layout -> cropped image."""
    squeeze = tiles.dim() == 2
    if squeeze:
        tiles = tiles[..., None]
    c = tiles.shape[-1]
    img = tiles.reshape(nty, ntx, tile_size, tile_size, c).permute(
        0, 2, 1, 3, 4).reshape(nty * tile_size, ntx * tile_size, c)
    img = img[:height, :width]
    return img[..., 0] if squeeze else img


def rasterize_tiles_chunked(xys, conics, colors, opacities, bins: TileBins,
                            width: int, height: int, tile_size: int,
                            background: torch.Tensor, max_per_tile: int,
                            chunk: int = 32):
    """Tile-parallel chunked compositing. Returns (img (H, W, C), alpha
    (H, W)); pairs past max_per_tile (rounded up to whole chunks) of a
    tile are dropped."""
    ntx, nty = bins.num_tiles_x, bins.num_tiles_y
    tile_ids = torch.arange(ntx * nty, device=xys.device)
    accum, alpha_t = composite_tiles(xys, conics, colors, opacities, bins,
                                     tile_ids, tile_size, max_per_tile, chunk)
    img_tiles = accum + (1.0 - alpha_t)[..., None] * background[None, None, :]
    return (tiles_to_image(img_tiles, ntx, nty, tile_size, width, height),
            tiles_to_image(alpha_t, ntx, nty, tile_size, width, height))
