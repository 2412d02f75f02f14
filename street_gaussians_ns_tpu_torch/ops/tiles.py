"""Tile binning with per-pair feature threading (counterpart of
street_gaussians_ns_tpu/ops/tiles.py: `TileBins`, `count_pairs`,
`bin_and_pack` = `_depth_sort_cols` + `_trim_full`/`_row_trim_counts` +
`_bin_sorted`, for precision="f32" and no depth slice).

Pipeline (the JAX package's, step for step, so pair enumeration and order
match it bit for bit):
  1. depth sort of the gaussians (`torch.sort(..., stable=True)` gives the
     JAX (depth, index) order), every per-gaussian column gathered into
     depth order by the permutation;
  2. row trim: per gaussian the first/last tile row its coverage ellipse
     touches and its exact pair count (core.projection.row_tile_range);
  3. level 1: gaussians -> (gaussian, tile-row) runs — scan (kernel A)
     and ragged expansion (kernel B) of 16 rows;
  4. level 2: runs -> (gaussian, tile) pairs — scan (A) and expansion (B)
     of 14 rows, already in depth order within every tile;
  5. pair sort by one packed int64 key tile_id * (n + 1) + depth_rank,
     the 10 feature columns gathered by the permutation (on the GPU a row
     gather is cheap, so the payloads do not ride the sort as on the TPU);
  6. per-tile [start, start + count) bounds by one searchsorted.
Integer quantities ride the expansions as float32 values, exact below
2^24, as in the JAX package.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core.projection import Projected, coverage_q, row_tile_range
from . import expand, scan

# Elements of one chunk of the (N, tile rows) row-trim broadcast: bounds
# its temporaries to some hundred MB at full width.
_TRIM_ELEMS = 1 << 23


@dataclasses.dataclass(frozen=True)
class TileBins:
    """Sorted (gaussian, tile) pairs + per-tile ranges.

    The JAX TileBins also carries gauss_idx and exp_slot, which only the
    unported unfused compositor reads; the fused path returns them
    zero-filled there, so they are left out here."""

    pair_valid: torch.Tensor   # (max_pairs,) bool
    tile_start: torch.Tensor   # (num_tiles,) int32 first sorted pair
    tile_count: torch.Tensor   # (num_tiles,) int32 pairs per tile
    num_pairs: torch.Tensor    # () int64 true pair count (may exceed
    #                            max_pairs)
    num_rowruns: torch.Tensor  # () int64 true run count (may exceed
    #                            max_rowruns)
    depth_order: torch.Tensor  # (N,) int32 depth rank -> gaussian index
    exp_starts: torch.Tensor   # (N,) int32 exclusive cumsum of exp_counts
    exp_counts: torch.Tensor   # (N,) int32 pairs per depth rank
    num_tiles_x: int
    num_tiles_y: int

    @property
    def max_tile_count(self) -> torch.Tensor:
        """() int32: the densest tile's pair count within capacity."""
        return torch.max(self.tile_count)


def _row_trim_counts(conics, xys, box, tile_size: int, max_h: int, q):
    """Per gaussian (first, last, count): box-relative indices of the
    first/last tile row of nonzero width (-1 if none) and the total pair
    count, from one (N, max_h) broadcast of the coverage predicate,
    evaluated in chunks of gaussians."""
    n = conics.shape[0]
    dev = conics.device
    first = torch.empty((n,), dtype=torch.int32, device=dev)
    last = torch.empty((n,), dtype=torch.int32, device=dev)
    cnt = torch.empty((n,), dtype=torch.int32, device=dev)
    i = torch.arange(max_h, dtype=torch.int32, device=dev)[None, :]
    step = max(1, _TRIM_ELEMS // max(max_h, 1))
    for lo in range(0, n, step):
        sl = slice(lo, lo + step)
        y0b = box[sl, 2]
        h = box[sl, 3] - y0b
        ty = y0b[:, None] + i
        x0, x1 = row_tile_range(conics[sl, None, :], xys[sl, None, :],
                                box[sl, None, :], ty, tile_size,
                                q[sl, None])
        w = torch.where(i < h[:, None], x1 - x0, 0)
        nz = w > 0
        any_nz = nz.any(dim=1)
        f = torch.where(nz, i, max_h).amin(dim=1)
        l_ = torch.where(nz, i, -1).amax(dim=1)
        first[sl] = torch.where(any_nz, f, -1)
        last[sl] = torch.where(any_nz, l_, -1)
        cnt[sl] = w.sum(dim=1, dtype=torch.int32)
    return first, last, cnt


def _depth_sort_cols(xys, conics, depth_key, colors, opacities,
                     last_color_is_depth: bool):
    """Depth sort of the gaussians. Returns (depth-sorted key, order
    (int64), depth-sorted float table (N, 10) = [x, y, ca, cb, cc, op,
    f0..f3]) with the colour columns zero-padded to 4; with
    last_color_is_depth the last colour is taken from the sorted key,
    +inf (invisible) sanitised to 0."""
    n = depth_key.shape[0]
    nc = colors.shape[-1]
    if nc > 4:
        raise ValueError(f"at most 4 colour channels, got {nc}")
    order = torch.sort(depth_key, stable=True).indices
    dk_s = depth_key[order]
    nc_ride = nc - 1 if (last_color_is_depth and nc > 0) else nc
    ftab = torch.cat([xys.to(torch.float32), conics.to(torch.float32),
                      opacities.to(torch.float32)[:, None],
                      colors[:, :nc_ride].to(torch.float32)], dim=1)
    cols = [ftab.index_select(0, order)]
    if nc_ride < nc:
        cols.append(torch.where(torch.isfinite(dk_s), dk_s,
                                torch.zeros_like(dk_s))[:, None])
    cols.append(torch.zeros((n, 4 - nc), dtype=torch.float32,
                            device=depth_key.device))
    return dk_s, order, torch.cat(cols, dim=1)


def bin_and_pack(
    xys: torch.Tensor,         # (N, 2) screen centers
    conics: torch.Tensor,      # (N, 3)
    tile_box: torch.Tensor,    # (N, 4) int [x0, x1, y0, y1)
    depth_key: torch.Tensor,   # (N,) f32; +inf marks invisible gaussians
    colors: torch.Tensor,      # (N, C<=4) per-splat colours
    opacities: torch.Tensor,   # (N,)
    width: int,
    height: int,
    tile_size: int,
    max_pairs: int,
    max_rowruns: int | None = None,
    last_color_is_depth: bool = False,
):
    """Fused binning: returns (TileBins, feats), feats being the 11
    sorted-pair float32 columns [x, y, ca, cb, cc, op, c0..c3, depth rank]
    (each (max_pairs,); invalid pairs hold zeros and rank N) that the
    compositor's stream packs. The per-pair depth rank is what the
    training slice's gradient reduce keys on."""
    dev = xys.device
    ntx = (width + tile_size - 1) // tile_size
    nty = (height + tile_size - 1) // tile_size
    num_tiles = ntx * nty
    if max_rowruns is None:
        max_rowruns = max_pairs // 2
    n = depth_key.shape[0]
    i32, f32 = torch.int32, torch.float32

    dk_s, order, fs = _depth_sort_cols(xys, conics, depth_key, colors,
                                       opacities, last_color_is_depth)
    box_s = tile_box.to(i32).index_select(0, order)
    x0_s, x1_s, y0_s = box_s[:, 0], box_s[:, 1], box_s[:, 2]
    op_s = fs[:, 5]

    first, last, count_g = _row_trim_counts(
        fs[:, 2:5], fs[:, 0:2], box_s, tile_size, nty, q=coverage_q(op_s))
    nz = torch.isfinite(dk_s) & (count_g > 0)
    count_g = torch.where(nz, count_g, 0)
    true_pairs = count_g.sum(dtype=torch.int64)
    y0t = torch.where(nz, y0_s + first, 0)
    y1t = torch.where(nz, y0_s + last + 1, 0)
    hrows = torch.where(nz, y1t - y0t, 0)
    rank = torch.arange(n, dtype=f32, device=dev)

    # Level 1: gaussians -> (gaussian, tile-row) runs.
    cum_r = scan.cumsum_flat(hrows)
    starts_r = cum_r - hrows
    src16 = torch.stack([
        fs[:, 0], fs[:, 1], rank, starts_r.to(f32),
        x0_s.to(f32), x1_s.to(f32), y0t.to(f32), y1t.to(f32),
        fs[:, 2], fs[:, 3], fs[:, 4], op_s,
        fs[:, 6], fs[:, 7], fs[:, 8], fs[:, 9],
    ])                                                  # (16, N)
    r = expand.expand_ragged(src16, starts_r, cum_r, max_rowruns)
    rr = torch.arange(max_rowruns, dtype=i32, device=dev)
    ty = r[6].to(i32) + (rr - r[3].to(i32))
    rbox = r[4:8].T.to(i32)
    total_r = (cum_r[-1].to(torch.int64) if n > 0
               else torch.zeros((), dtype=torch.int64, device=dev))
    rvalid = rr < torch.clamp(total_r, max=max_rowruns)
    x0r, x1r = row_tile_range(r[8:11].T, r[0:2].T, rbox, ty, tile_size,
                              coverage_q(r[11]))
    wr = torch.where(rvalid, x1r - x0r, 0)

    # Level 2: runs -> pairs.
    cum2 = scan.cumsum_flat(wr)
    starts2 = cum2 - wr
    total = cum2[-1]
    src14 = torch.cat([
        r[0:3],                                         # x, y, rank
        (ty * ntx + x0r).to(f32)[None],                 # first tile of run
        starts2.to(f32)[None],
        torch.ones((1, max_rowruns), dtype=f32, device=dev),   # hit flag
        r[8:16],                                        # ca..op, f0..f3
    ])                                                  # (14, MR)
    p = expand.expand_ragged(src14, starts2, cum2, max_pairs)
    slot = torch.arange(max_pairs, dtype=i32, device=dev)
    valid = (slot < total) & (p[5] > 0.5)
    tile_id = torch.where(valid, p[3].to(i32) + (slot - p[4].to(i32)),
                          num_tiles)

    count_g = torch.where(starts_r < max_rowruns, count_g, 0)
    exp_starts = scan.cumsum_flat(count_g) - count_g

    # (tile, depth rank) order as one int64 key; dead slots tie at
    # (num_tiles, n) and carry all-zero features.
    rank_col = torch.where(valid, p[2], float(n))
    key = tile_id.to(torch.int64) * (n + 1) + rank_col.to(torch.int64)
    key_s, perm = torch.sort(key, stable=True)
    tile_sorted = key_s // (n + 1)
    feat_rows = torch.tensor([0, 1, 6, 7, 8, 9, 10, 11, 12, 13], device=dev)
    pf = p.index_select(0, feat_rows).index_select(1, perm)  # (10, MP)
    feats = list(pf.unbind(0)) + [rank_col.index_select(0, perm)]

    bounds = torch.searchsorted(
        tile_sorted,
        torch.arange(num_tiles + 1, dtype=torch.int64, device=dev),
        side="left").to(i32)
    bins = TileBins(
        pair_valid=tile_sorted < num_tiles,
        tile_start=bounds[:-1],
        tile_count=bounds[1:] - bounds[:-1],
        num_pairs=true_pairs,
        num_rowruns=total_r,
        depth_order=order.to(i32),
        exp_starts=exp_starts,
        exp_counts=count_g,
        num_tiles_x=ntx,
        num_tiles_y=nty,
    )
    return bins, feats


def count_pairs(proj: Projected, width: int, height: int, tile_size: int,
                opacities: torch.Tensor | None = None):
    """Capacity-free exact (num_pairs, num_rowruns) for one camera, as
    0-d int64 tensors: the pair count of the fused binning and the
    untrimmed tile-row count (the larger convention, safe for sizing
    max_pairs / max_rowruns before a render)."""
    nty = (height + tile_size - 1) // tile_size
    n = proj.depths.shape[0]
    visible = proj.num_tiles_hit > 0
    op_col = (opacities.to(torch.float32) if opacities is not None
              else torch.ones((n,), dtype=torch.float32,
                              device=proj.depths.device))
    box = proj.tile_box.to(torch.int32)
    _, _, cnt = _row_trim_counts(proj.conics, proj.xys, box, tile_size, nty,
                                 q=coverage_q(op_col))
    nz = visible & (cnt > 0)
    rowruns = torch.where(visible, box[:, 3] - box[:, 2], 0)
    return (torch.where(nz, cnt, 0).sum(dtype=torch.int64),
            rowruns.sum(dtype=torch.int64))
