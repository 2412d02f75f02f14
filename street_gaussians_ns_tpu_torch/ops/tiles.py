"""Tile binning (counterpart of street_gaussians_ns_tpu/ops/tiles.py:
`TileBins`, `count_pairs`, the fused `bin_and_pack` = `_depth_sort_cols`
+ `_trim_full` + `_bin_sorted`, and the bins-shared `bin_gaussians` with
`_owner_by_scatter`).

Fused pipeline (the JAX package's, step for step, so pair enumeration and
order match it bit for bit):
  1. `_depth_sort_cols`: depth sort of the gaussians
     (`torch.sort(..., stable=True)` gives the JAX (depth, index) order),
     every per-gaussian column gathered into depth order; with
     precision="bf16" the conics, opacity and colours (and the depth
     copy of the last colour) are rounded to bf16 first (ops.packing),
     so binning, compositing and the backward all see the rounded
     values, as in the JAX package; xy and the depth key stay float32;
  2. `_trim_full`: per gaussian the first/last tile row its coverage
     ellipse touches and its exact pair count
     (core.projection.row_tile_range), kernel I on the card (one thread a
     gaussian, `csrc/row_trim.cu`), the chunked broadcast on the CPU;
  3. `_bin_sorted`, on all ranks or on a depth-rank window of them:
     level 1, gaussians -> (gaussian, tile-row) runs — scan (kernel A) and
     ragged expansion (kernel B) of 16 rows; level 2, runs -> (gaussian,
     tile) pairs — scan (A) and expansion (B) of 14 rows, already in depth
     order within every tile; the pair sort by one packed int64 key
     tile_id * (n + 1) + depth_rank, the 10 feature columns gathered by
     the permutation (on the GPU a row gather is cheap, so the payloads do
     not ride the sort as on the TPU); per-tile [start, start + count)
     bounds by one searchsorted.
Integer quantities ride the expansions as float32 values, exact below
2^24, as in the JAX package.

`bin_gaussians` enumerates the same pairs without threading features: the
slot -> owner maps come from a unique-index scatter and a cumulative max
(kernel A's max mode), the box rows are not trimmed, and the bins carry
`gauss_idx` and `exp_slot` for the compositors that gather features per
pair (ops.composite.rasterize_tiles_pallas, ops.composite_chunked,
ops.composite_scan).
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import numpy as np
import torch

from ..core.projection import Projected, coverage_q, row_tile_range
from ..utils.profiling import span, spanned
from . import _cuda, expand, scan
from .packing import round_bf16

PRECISIONS = ("f32", "bf16")

# Elements of one chunk of the (N, tile rows) row-trim broadcast: bounds
# its temporaries to some hundred MB at full width.
_TRIM_ELEMS = 1 << 23


@dataclasses.dataclass(frozen=True)
class TileBins:
    """Sorted (gaussian, tile) pairs + per-tile ranges.

    A field is None where the path that made the bins has no valid value
    for it: the fused path threads features instead of `gauss_idx` and
    `exp_slot`, and the depth-sliced path has one pair list per slice, so
    its public bins carry only the aggregate `tile_count`, the demand
    counts and `depth_order`."""

    pair_valid: Optional[torch.Tensor]  # (max_pairs,) bool
    tile_start: Optional[torch.Tensor]  # (num_tiles,) int32 first sorted pair
    tile_count: torch.Tensor   # (num_tiles,) int32 pairs per tile
    num_pairs: torch.Tensor    # () int64 true pair count (may exceed
    #                            max_pairs)
    num_rowruns: torch.Tensor  # () int64 true run count (may exceed
    #                            max_rowruns)
    depth_order: torch.Tensor  # (N,) int32 depth rank -> gaussian index
    exp_starts: Optional[torch.Tensor]  # (N,) int32 exclusive cumsum of
    #                                     exp_counts
    exp_counts: Optional[torch.Tensor]  # (N,) int32 pairs per depth rank
    num_tiles_x: int
    num_tiles_y: int
    gauss_idx: Optional[torch.Tensor] = None  # (max_pairs,) int32 gaussian
    #                                           of each sorted pair
    exp_slot: Optional[torch.Tensor] = None   # (max_pairs,) int32 pre-sort
    #                                           slot; max_pairs if invalid

    @property
    def max_tile_count(self) -> torch.Tensor:
        """() int32: the densest tile's pair count within capacity. The
        portable compositors render at most `max_per_tile` pairs of a tile
        and drop the rest, so their callers hold this against it."""
        return torch.max(self.tile_count)


_TENSOR_FIELDS = ("pair_valid", "tile_start", "tile_count", "num_pairs",
                  "num_rowruns", "depth_order", "exp_starts", "exp_counts",
                  "gauss_idx", "exp_slot")


def bins_from_numpy(arrays: dict, device="cuda") -> TileBins:
    """TileBins from a mapping of field name -> numpy array (every field
    of the JAX package's TileBins, the two tile-grid sizes included), on
    the card unless the caller asks for another device."""
    fields = {}
    for name in _TENSOR_FIELDS:
        a = np.asarray(arrays[name])
        if name in ("num_pairs", "num_rowruns"):
            a = a.astype(np.int64)
        fields[name] = torch.from_numpy(np.array(a)).to(device)
    return TileBins(num_tiles_x=int(arrays["num_tiles_x"]),
                    num_tiles_y=int(arrays["num_tiles_y"]), **fields)


TRIM_KERNEL = _cuda.register(_cuda.Kernel(
    name="row_trim",
    source="row_trim.cu",
    replaces="none: street_gaussians_ns_tpu/ops/tiles.py:93 "
             "_row_trim_counts is jnp code that XLA fuses",
    entries={"sg_row_trim": (ctypes.c_void_p, ctypes.c_longlong,
                             ctypes.c_void_p, ctypes.c_longlong,
                             ctypes.c_void_p, ctypes.c_void_p,
                             ctypes.c_void_p, ctypes.c_void_p,
                             ctypes.c_void_p, ctypes.c_longlong,
                             ctypes.c_int, ctypes.c_int, ctypes.c_void_p)},
))


def _row_trim_counts_plain(conics, xys, box, tile_size: int, max_h: int, q):
    """_row_trim_counts as one (N, max_h) broadcast of the coverage
    predicate, evaluated in chunks of gaussians: kernel I's specification,
    and what the CPU runs."""
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


def _row_trim_kernel(conics, xys, box, tile_size: int, max_h: int, q):
    """Kernel I: one launch on the current stream. conics (N, 3) and xys
    (N, 2) float32 may be row-strided views (a unit column stride), as the
    columns of the depth-sorted table are; box (N, 4) int32 contiguous, q
    (N,) float32."""
    n = conics.shape[0]
    _cuda.check(conics, "conics", torch.float32, shape=(n, 3),
                strided_rows=True)
    _cuda.check(xys, "xys", torch.float32, shape=(n, 2), strided_rows=True)
    _cuda.check(box, "box", torch.int32, shape=(n, 4))
    _cuda.check(q, "q", torch.float32, shape=(n,))
    if box.data_ptr() % 16:
        raise ValueError("box: must start on a 16-byte boundary")
    # Three allocations, not one (3, N): a caller that drops the count
    # early frees it, as with the plain version.
    first, last, cnt = (torch.empty((n,), dtype=torch.int32,
                                    device=conics.device) for _ in range(3))
    TRIM_KERNEL.launch("sg_row_trim", _cuda.ptr(conics), conics.stride(0),
                       _cuda.ptr(xys), xys.stride(0), _cuda.ptr(box),
                       _cuda.ptr(q), _cuda.ptr(first), _cuda.ptr(last),
                       _cuda.ptr(cnt), n, tile_size, max_h,
                       _cuda.stream(conics))
    return first, last, cnt


@spanned("tiles.row_trim")
def _row_trim_counts(conics, xys, box, tile_size: int, max_h: int, q):
    """Per gaussian (first, last, count): box-relative indices of the
    first/last tile row of nonzero width (-1 if none) and the total pair
    count, over the box's first max_h rows. CUDA tensors launch kernel I
    (`csrc/row_trim.cu`), CPU tensors run the plain broadcast; the two
    agree bit for bit on the card."""
    if _cuda.is_cpu(conics, xys, box, q):
        return _row_trim_counts_plain(conics, xys, box, tile_size, max_h, q)
    return _row_trim_kernel(conics, xys, box, tile_size, max_h, q)


@spanned("tiles.depth_sort")
def _depth_sort_cols(xys, conics, tile_box, depth_key, colors, opacities,
                     last_color_is_depth: bool, precision: str = "f32"):
    """Depth sort of the gaussians, paid once however many windows are
    binned from it. Returns cols = (depth-sorted key, order (int64),
    depth-sorted float table (N, 10) = [x, y, ca, cb, cc, op, f0..f3],
    depth-sorted int32 tile boxes (N, 4)) with the colour columns
    zero-padded to 4; with last_color_is_depth the last colour is taken
    from the sorted key, +inf (invisible) sanitised to 0. precision="bf16"
    rounds every column of the table but x and y to bf16 (the JAX
    package's packed sort payloads, unpacked)."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision={precision!r}: expected one of "
                         f"{PRECISIONS}")
    rnd = round_bf16 if precision == "bf16" else (lambda x: x)
    n = depth_key.shape[0]
    nc = colors.shape[-1]
    if nc > 4:
        raise ValueError(f"at most 4 colour channels, got {nc}")
    order = torch.sort(depth_key, stable=True).indices
    dk_s = depth_key[order]
    nc_ride = nc - 1 if (last_color_is_depth and nc > 0) else nc
    ftab = torch.cat([xys.to(torch.float32),
                      rnd(torch.cat([conics.to(torch.float32),
                                     opacities.to(torch.float32)[:, None],
                                     colors[:, :nc_ride].to(torch.float32)],
                                    dim=1))], dim=1)
    cols = [ftab.index_select(0, order)]
    if nc_ride < nc:
        cols.append(rnd(torch.where(torch.isfinite(dk_s), dk_s,
                                    torch.zeros_like(dk_s)))[:, None])
    cols.append(torch.zeros((n, 4 - nc), dtype=torch.float32,
                            device=depth_key.device))
    box_s = tile_box.to(torch.int32).index_select(0, order)
    return dk_s, order, torch.cat(cols, dim=1), box_s


def _trim_full(cols, tile_size: int, nty: int):
    """Row trim over all the depth-sorted gaussians (see
    _row_trim_counts); windowed binning passes it to _bin_sorted(trim=)
    so k windows do not redo the (N, tile rows) broadcast."""
    _, _, fs, box_s = cols
    return _row_trim_counts(fs[:, 2:5], fs[:, 0:2], box_s, tile_size, nty,
                            q=coverage_q(fs[:, 5]))


def _bin_sorted(cols, depth_slice, width: int, height: int, tile_size: int,
                max_pairs: int, max_rowruns: int,
                with_gauss_idx: bool = False, rank_window=None, trim=None,
                local_window=None):
    """Row trim -> two ragged expansions -> pair sort -> tile ranges of
    the depth-sorted columns `cols` (from _depth_sort_cols), everything
    pair-shaped sized by max_rowruns / max_pairs. Returns (TileBins,
    feats): the sorted-pair float32 columns [x, y, ca, cb, cc, op, c0..c3]
    and, unless with_gauss_idx, the pair's depth rank as an 11th (each
    (max_pairs,); invalid pairs hold zeros and rank N).

    A depth-rank window restricts the binning, in one of two ways:
      * depth_slice=(start, size): the `size` ranks from `start` (an int
        or a 0-d device tensor, clamped so the window stays inside the
        array) are cut out of every column; the ranks the pairs carry stay
        global, so a window's gradients land in the full-N rank arrays;
      * rank_window=(lo, hi): 0-d device tensors over the full columns,
        applied as a mask on the counts (the windows' sizes depend on the
        data). Ranks outside keep zero counts.
    local_window=(lo, hi), with depth_slice: only local rows [lo, hi) of
    the cut-out window are live. `trim` passes a precomputed _trim_full
    result (full N; windowed here with the columns).

    with_gauss_idx: the pairs carry the gaussian's original index instead
    of its depth rank, and the bins get `gauss_idx` and `exp_slot`."""
    if depth_slice is not None and rank_window is not None:
        raise ValueError("depth_slice and rank_window exclude each other")
    dk_s, order, fs, box_s = cols
    dev = dk_s.device
    ntx = (width + tile_size - 1) // tile_size
    nty = (height + tile_size - 1) // tile_size
    num_tiles = ntx * nty
    n = dk_s.shape[0]
    i32, f32 = torch.int32, torch.float32

    if depth_slice is not None:
        sl_start, nloc = depth_slice
        rank0 = torch.clamp(torch.as_tensor(sl_start, device=dev).to(
            torch.int64), 0, max(n - nloc, 0))
        window = rank0 + torch.arange(nloc, device=dev)

        def dsl(a):
            return a.index_select(0, window)

        dk_s, fs, box_s, idx_s = map(dsl, (dk_s, fs, box_s, order))
        if trim is not None:
            trim = tuple(map(dsl, trim))
    else:
        rank0, nloc, idx_s = 0, n, order
    x0_s, x1_s, y0_s = box_s[:, 0], box_s[:, 1], box_s[:, 2]
    op_s = fs[:, 5]

    first, last, count_g = (trim if trim is not None else _row_trim_counts(
        fs[:, 2:5], fs[:, 0:2], box_s, tile_size, nty, q=coverage_q(op_s)))
    with span("tiles.bin_rest"):
        nz = torch.isfinite(dk_s) & (count_g > 0)
        if rank_window is not None:
            ridx = torch.arange(n, dtype=i32, device=dev)
            nz = nz & (ridx >= rank_window[0]) & (ridx < rank_window[1])
        if local_window is not None:
            lidx = torch.arange(nloc, dtype=i32, device=dev)
            nz = nz & (lidx >= local_window[0]) & (lidx < local_window[1])
        count_g = torch.where(nz, count_g, 0)
        true_pairs = count_g.sum(dtype=torch.int64)
        y0t = torch.where(nz, y0_s + first, 0)
        y1t = torch.where(nz, y0_s + last + 1, 0)
        hrows = torch.where(nz, y1t - y0t, 0)
        # What a pair carries to say whose it is: the original index when
        # gauss_idx is asked for, else the (global) depth rank.
        ident = (idx_s if with_gauss_idx
                 else rank0 + torch.arange(nloc, device=dev)).to(f32)

        # Level 1: gaussians -> (gaussian, tile-row) runs.
        cum_r = scan.cumsum_flat(hrows)
        starts_r = cum_r - hrows
        src16 = torch.stack([
            fs[:, 0], fs[:, 1], ident, starts_r.to(f32),
            x0_s.to(f32), x1_s.to(f32), y0t.to(f32), y1t.to(f32),
            fs[:, 2], fs[:, 3], fs[:, 4], op_s,
            fs[:, 6], fs[:, 7], fs[:, 8], fs[:, 9],
        ])                                                  # (16, N)
        r = expand.expand_ragged(src16, starts_r, cum_r, max_rowruns)
        rr = torch.arange(max_rowruns, dtype=i32, device=dev)
        ty = r[6].to(i32) + (rr - r[3].to(i32))
        rbox = r[4:8].T.to(i32)
        total_r = (cum_r[-1].to(torch.int64) if nloc > 0
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
            r[0:3],                                         # x, y, ident
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

        def feat_rows(perm):
            # x, y, ca..op, f0..f3 in pair order
            return torch.cat([p[0:2], p[6:14]]).index_select(1, perm)

        if with_gauss_idx:
            # (tile, slot) order: a stable sort by tile keeps the slots, which
            # ascend, in order.
            tile_sorted, perm = torch.sort(tile_id, stable=True)
            pair_valid = tile_sorted < num_tiles
            feats = list(feat_rows(perm).unbind(0))
            g = torch.where(valid, p[2].to(i32), n)
            extra = dict(gauss_idx=g.index_select(0, perm),
                         exp_slot=torch.where(pair_valid, perm.to(i32),
                                              max_pairs))
        else:
            # (tile, depth rank) order as one int64 key; dead slots tie at
            # (num_tiles, n) and carry all-zero features.
            rank_col = torch.where(valid, p[2], float(n))
            key = tile_id.to(torch.int64) * (n + 1) + rank_col.to(torch.int64)
            key_s, perm = torch.sort(key, stable=True)
            tile_sorted = key_s // (n + 1)
            pair_valid = tile_sorted < num_tiles
            pf = feat_rows(perm)                                # (10, MP)
            feats = list(pf.unbind(0)) + [rank_col.index_select(0, perm)]
            extra = {}

        bounds = torch.searchsorted(
            tile_sorted,
            torch.arange(num_tiles + 1, dtype=tile_sorted.dtype, device=dev),
            side="left").to(i32)
        bins = TileBins(
            pair_valid=pair_valid,
            tile_start=bounds[:-1],
            tile_count=bounds[1:] - bounds[:-1],
            num_pairs=true_pairs,
            num_rowruns=total_r,
            # The full depth order even for a window: the gradient reduce
            # un-sorts full-N rank sums with it.
            depth_order=order.to(i32),
            exp_starts=exp_starts,
            exp_counts=count_g,
            num_tiles_x=ntx,
            num_tiles_y=nty,
            **extra,
        )
        return bins, feats


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
    with_gauss_idx: bool = False,
    depth_slice=None,
    precision: str = "f32",
):
    """Fused binning: returns (TileBins, feats), feats being the 11
    sorted-pair float32 columns [x, y, ca, cb, cc, op, c0..c3, depth rank]
    (each (max_pairs,); invalid pairs hold zeros and rank N) that the
    compositor's stream packs. The per-pair depth rank is what the
    training slice's gradient reduce keys on. with_gauss_idx and
    depth_slice=(start, size) as in _bin_sorted, precision as in
    _depth_sort_cols."""
    if max_rowruns is None:
        max_rowruns = max_pairs // 2
    cols = _depth_sort_cols(xys, conics, tile_box, depth_key, colors,
                            opacities, last_color_is_depth, precision)
    return _bin_sorted(cols, depth_slice, width, height, tile_size,
                       max_pairs, max_rowruns, with_gauss_idx)


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


def _owner_by_scatter(starts: torch.Tensor, capacity: int) -> torch.Tensor:
    """slot -> index of the owning run, (capacity,) int32: for runs with
    exclusive-cumsum `starts` (callers pass a sentinel >= capacity for
    zero-length runs), owner[s] = the largest run index whose start <= s,
    -1 before the first run. Every live run's start is marked with its
    index (the starts are distinct; sentinels fall into a spare slot that
    is cut off) and a cumulative max (kernel A, max mode) fills the run."""
    n = starts.shape[0]
    dev = starts.device
    mark = torch.full((capacity + 1,), -1, dtype=torch.int32, device=dev)
    mark.scatter_(0, starts.clamp(0, capacity).to(torch.int64),
                  torch.arange(n, dtype=torch.int32, device=dev))
    return scan.cummax_flat(mark[:capacity].contiguous())


@torch.no_grad()
def bin_gaussians(proj: Projected, width: int, height: int, tile_size: int,
                  max_pairs: int, max_rowruns: int | None = None,
                  opacities: torch.Tensor | None = None) -> TileBins:
    """Bins shared by the compositors that gather features per pair: each
    (gaussian, tile-row) run enumerates the tile columns its coverage
    ellipse covers in that row (opacity-aware when `opacities` is given:
    pass the values the compositor receives, and build `proj` with them so
    the tile box matches). Two-level ragged expansion, both levels an
    owner scatter + flat cummax + row gather. The box rows are not
    trimmed, so `num_rowruns` counts every row of every visible box (more
    than the fused binning's). The bins are topology: nothing here is
    differentiated."""
    dev = proj.depths.device
    ntx = (width + tile_size - 1) // tile_size
    nty = (height + tile_size - 1) // tile_size
    num_tiles = ntx * nty
    if max_rowruns is None:
        max_rowruns = max_pairs // 2
    n = proj.depths.shape[0]
    i32, f32 = torch.int32, torch.float32
    zero = torch.zeros((), dtype=i32, device=dev)

    visible = proj.num_tiles_hit > 0
    depth_key = torch.where(visible, proj.depths,
                            torch.full_like(proj.depths, float("inf")))
    order = torch.sort(depth_key, stable=True).indices
    op_col = (opacities.to(f32) if opacities is not None
              else torch.ones((n,), dtype=f32, device=dev))
    # One (N, 11) row gather brings every per-gaussian quantity into depth
    # order (the ints are exact in float32).
    tab = torch.cat([
        proj.xys, proj.conics, proj.tile_box.to(f32), op_col[:, None],
        torch.arange(n, dtype=f32, device=dev)[:, None]], dim=-1)
    tab_s = tab.index_select(0, order)
    box_s = tab_s[:, 5:9].to(i32)
    hrows = torch.where(visible.index_select(0, order),
                        box_s[:, 3] - box_s[:, 2], 0)

    # Level 1: gaussians -> (gaussian, tile-row) runs.
    cum_r = scan.cumsum_flat(hrows)
    starts_r = cum_r - hrows
    total_r = cum_r[-1] if n > 0 else zero
    owner1 = _owner_by_scatter(
        torch.where(hrows > 0, starts_r, max_rowruns), max_rowruns
    ).clamp(0, max(n - 1, 0)).to(torch.int64)
    rr = torch.arange(max_rowruns, dtype=i32, device=dev)
    rtab = torch.cat([tab_s, starts_r.to(f32)[:, None]],
                     dim=-1).index_select(0, owner1)     # (MR, 12)
    rbox = rtab[:, 5:9].to(i32)
    ty = rbox[:, 2] + (rr - rtab[:, 11].to(i32))
    rvalid = rr < torch.clamp(total_r, max=max_rowruns)
    rq = coverage_q(rtab[:, 9]) if opacities is not None else 9.0
    x0r, x1r = row_tile_range(rtab[:, 2:5], rtab[:, 0:2], rbox, ty,
                              tile_size, rq)
    wr = torch.where(rvalid, x1r - x0r, 0)

    # Level 2: runs -> pairs.
    cum2 = scan.cumsum_flat(wr)
    starts2 = cum2 - wr
    total = cum2[-1]
    owner2 = _owner_by_scatter(
        torch.where(wr > 0, starts2, max_pairs), max_pairs
    ).clamp(0, max_rowruns - 1).to(torch.int64)
    rtab_i = torch.stack([rtab[:, 10].to(i32), ty * ntx + x0r, starts2],
                         dim=-1)
    ptab = rtab_i.index_select(0, owner2)                # (MP, 3)
    slot = torch.arange(max_pairs, dtype=i32, device=dev)
    valid = slot < total
    tile_id = torch.where(valid, ptab[:, 1] + (slot - ptab[:, 2]),
                          num_tiles)

    # A rank's runs are contiguous, so its pair count is a difference of
    # the level-2 cumsum; the starts are an exclusive cumsum of the counts
    # so that empty ranks stay contiguous.
    in_cap = (hrows > 0) & (starts_r < max_rowruns)
    last_r = (starts_r + hrows - 1).clamp(0, max_rowruns - 1).to(torch.int64)
    first_r = starts_r.clamp(0, max_rowruns - 1).to(torch.int64)
    count_g = torch.where(in_cap, cum2[last_r] - starts2[first_r], 0)
    exp_starts = scan.cumsum_flat(count_g) - count_g

    # (tile, slot) order: a stable sort by tile keeps the ascending slots
    # in order, which is depth order within each tile.
    tile_sorted, perm = torch.sort(tile_id, stable=True)
    pair_valid = tile_sorted < num_tiles
    bounds = torch.searchsorted(
        tile_sorted, torch.arange(num_tiles + 1, dtype=i32, device=dev),
        side="left").to(i32)
    return TileBins(
        pair_valid=pair_valid,
        tile_start=bounds[:-1],
        tile_count=bounds[1:] - bounds[:-1],
        # Exact while the runs fit; a lower bound when they overflow,
        # which num_rowruns (always exact) detects.
        num_pairs=total.to(torch.int64),
        num_rowruns=total_r.to(torch.int64),
        depth_order=order.to(i32),
        exp_starts=exp_starts,
        exp_counts=count_g,
        num_tiles_x=ntx,
        num_tiles_y=nty,
        gauss_idx=ptab[:, 0].index_select(0, perm),
        exp_slot=torch.where(pair_valid, perm.to(i32), max_pairs),
    )
