"""The kernel compositors, forward and backward — kernels C, D and E
(counterpart of street_gaussians_ns_tpu/ops/composite_pallas.py:
`_pack_feat_cols`, `_fwd_call`, `_bwd_call`, `_tiles_to_image`,
`_img_to_tiles`, `_bwd_from_tiles`, `_reduce_pair_grads_ranked`,
`_reduce_pair_grads`, `_unsort_rank_sums`, `_build_feat`, and its four
rasterizers, each one `torch.autograd.Function`):

  rasterize_tiles_fused       bin + pack + composite
                              (`rasterize_tiles_pallas_fused`), whole or
                              in `depth_slices` depth-rank windows
                              composited one after another;
  rasterize_tiles_pallas      composite over bins the caller shares
                              (`ops.tiles.bin_gaussians`), the features
                              gathered per pair (`rasterize_tiles_pallas`);
  composite_tiles_fused       bin + pack + composite of a strip of tiles
                              [tile0, tile0 + n_tiles), optionally of one
                              depth window, in tile layout
                              (`composite_tiles_pallas_fused`): the body a
                              device of a sharded render runs, with the
                              pair-balanced depth windows of a model
                              group (`_balanced_window`).

`precision="bf16"` reaches the fused routes only (ops.tiles.
_depth_sort_cols rounds the feature columns); the shared-bins route
ignores it, as in the JAX package. The backward stays float32 (the JAX
package packs its gradient reduce in bf16 only on a TPU).

Kernel C, `pack_feat_cols` (replaces `composite_pallas.py:_pack_kernel`,
CUDA in `csrc/pack.cu`): interleaves the sorted-pair feature columns into
the (rows_pad, 16, 128) stream, the JAX layout kept bit for bit; rows past
the pair capacity are zero sentinels. Bound by memory bandwidth.

Kernel D, `composite_fwd` (replaces `composite_pallas.py:_fwd_kernel`,
CUDA in `csrc/composite_fwd.cu`): one CTA per 16x16 tile, a running
transmittance product per pixel, the CTA exits when all its pixels are
done. Its bound is the larger of the needed pairs' bytes and ~16 float32
operations per evaluated (pixel, pair); on the card it is bound by
instruction issue, so, as in kernel E, a thread owns four pixels of its
tile (64 threads a tile) and evaluates them branch-free, a pair's features
are staged as 12 adjacent floats (three 16-byte loads), pairs come in
batches of 64 and a warp leaves a batch once its pixels are done.

Kernel E, `composite_bwd` (replaces `composite_pallas.py:_bwd_kernel`,
CUDA in `csrc/composite_bwd.cu`): the forward replayed per pixel up to its
n_contrib, the 6 + nc gradient terms of every pair reduced over the tile's
256 pixels and stored without atomics in the stream's layout, the pair's
depth rank copied into row 10. Its bound is the larger of the visited
pairs' bytes and its float32 operations: the forward's ~16 per evaluated
(pixel, pair) and ~51 more per evaluation that contributes. On the card it
is bound by instruction issue, so its design cuts what is issued beside
that arithmetic: a thread owns four pixels of its tile (64 threads a
tile), replays them branch-free and adds their terms in registers before
one folding shuffle tree a warp; the gradient terms use fused
multiply-adds, one fast division and three moments for the five geometry
rows; a pair's features are staged as 12 adjacent floats (three 16-byte
loads) in batches double-buffered with cp.async; g . accum is formed in
the kernel; the fused routes leave the rows nobody reads unwritten
(`zero_fill=False`).

Kernels D and E take an incoming transmittance `t_in` (a later depth
window continues the earlier ones' chain) and a strip offset `tile0`.

The gradient reduce around kernel F (`ops.segreduce.rank_rowsum`) is plain
PyTorch: the visited pairs are gathered out of the gradient stream by
their tile intervals (a tile's backward visits the first max(n_contrib)
pairs of its range, so no mask pass over the stream is needed), sorted by
rank, summed per rank by kernel F and un-sorted by `depth_order`. The JAX
package's cap ladder and nested conds exist for XLA's static shapes and
have no counterpart. The unfused rasterizer's reduce (`_reduce_pair_grads`)
goes through expansion order and kernel G
(`ops.segreduce.segment_rowsum`) instead.

Each wrapper runs its plain PyTorch version for CPU tensors and launches
its kernel for CUDA tensors.
"""
from __future__ import annotations

import ctypes

import torch

from . import _cuda
from .rasterize_ref import ALPHA_CLAMP, ALPHA_THRESH, SIGMA_MIN, T_EPS
from . import scan
from .segreduce import rank_rowsum, segment_rowsum
from .tiles import (TileBins, _bin_sorted, _depth_sort_cols, _trim_full,
                    bin_and_pack)

TILE = 16
PIX = TILE * TILE     # pixels per tile
K = 128               # pairs per stream row
NFEAT = 16            # feature rows per stream row
RANK_ROW = 10         # stream row that carries the pair's depth rank
NGRAD = 10            # gradient rows: x, y, conic (3), opacity, 4 colours
FWD_THREADS = PIX // 4    # kernel D's CTA: four pixels a thread
BWD_THREADS = PIX // 4    # kernel E's CTA: four pixels a thread

PACK_KERNEL = _cuda.register(_cuda.Kernel(
    name="pack_feat_cols",
    source="pack.cu",
    replaces="street_gaussians_ns_tpu/ops/composite_pallas.py:1469 "
             "_pack_kernel",
    entries={"sg_pack_feat_cols": (ctypes.c_void_p, ctypes.c_int,
                                   ctypes.c_longlong, ctypes.c_longlong,
                                   ctypes.c_void_p, ctypes.c_void_p)},
))

FWD_KERNEL = _cuda.register(_cuda.Kernel(
    name="composite_fwd",
    source="composite_fwd.cu",
    replaces="street_gaussians_ns_tpu/ops/composite_pallas.py:222 "
             "_fwd_kernel",
    entries={"sg_composite_fwd": (ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                  ctypes.c_int, ctypes.c_int,
                                  ctypes.c_void_p, ctypes.c_int,
                                  ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.c_void_p)},
))

BWD_KERNEL = _cuda.register(_cuda.Kernel(
    name="composite_bwd",
    source="composite_bwd.cu",
    replaces="street_gaussians_ns_tpu/ops/composite_pallas.py:414 "
             "_bwd_kernel",
    entries={"sg_composite_bwd": (ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                  ctypes.c_int, ctypes.c_int,
                                  ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.c_void_p)},
))


# ---------------------------------------------------------------------------
# Kernel C: feature pack.
# ---------------------------------------------------------------------------

def pack_feat_cols_plain(feats, max_pairs: int) -> torch.Tensor:
    rows_true = max_pairs // K
    cols = list(feats) + [torch.zeros_like(feats[0])] * (NFEAT - len(feats))
    feat = torch.stack(cols, dim=-1).reshape(rows_true, K, NFEAT)
    feat = feat.transpose(1, 2)
    return torch.cat([feat, torch.zeros((1, NFEAT, K), dtype=feat.dtype,
                                        device=feat.device)], dim=0)


def pack_feat_cols(feats, max_pairs: int) -> torch.Tensor:
    """Sorted-pair columns (each (max_pairs,) float32, at most 16) -> the
    (max_pairs // 128 + 1, 16, 128) stream; column f fills feature row f,
    the other rows and the last (sentinel) row are zero."""
    if max_pairs % K:
        raise ValueError(f"max_pairs must be a multiple of {K}, got "
                         f"{max_pairs}")
    if not 0 < len(feats) <= NFEAT:
        raise ValueError(f"1..{NFEAT} feature columns, got {len(feats)}")
    for i, c in enumerate(feats):
        if c.dtype != torch.float32 or tuple(c.shape) != (max_pairs,):
            raise ValueError(f"feats[{i}] must be ({max_pairs},) float32, "
                             f"got {c.dtype} {tuple(c.shape)}")
    if _cuda.is_cpu(*feats):
        return pack_feat_cols_plain(feats, max_pairs)
    for i, c in enumerate(feats):
        _cuda.check(c, f"feats[{i}]", torch.float32)
    rows_true = max_pairs // K
    rows_pad = rows_true + 1
    out = torch.empty((rows_pad, NFEAT, K), dtype=torch.float32,
                      device=feats[0].device)
    col_ptrs = (ctypes.c_void_p * len(feats))(*[c.data_ptr() for c in feats])
    PACK_KERNEL.launch("sg_pack_feat_cols", col_ptrs, len(feats), rows_true,
                       rows_pad, _cuda.ptr(out), _cuda.stream(out))
    return out


# ---------------------------------------------------------------------------
# Kernel D: forward compositor.
# ---------------------------------------------------------------------------

def _pixel_centers(num_tiles: int, ntx: int, device, tile0: int = 0):
    """(num_tiles, PIX) pixel-center x and y of the pixels of tiles
    [tile0, tile0 + num_tiles)."""
    t = torch.arange(tile0, tile0 + num_tiles, device=device)[:, None]
    lp = torch.arange(PIX, device=device)[None, :]
    px = ((t % ntx) * TILE + lp % TILE).to(torch.float32) + 0.5
    py = ((t // ntx) * TILE + lp // TILE).to(torch.float32) + 0.5
    return px, py


def _modes(t_in, tile0: int):
    return (("t_in",) if t_in is not None else ()) + (
        ("tile0",) if tile0 else ())


def _initial_state(num_tiles: int, device, t_in):
    """(T, done) a compositing loop starts from: 1 and not done, or the
    magnitude of the incoming transmittance, done where that is <= T_EPS
    or carries a minus sign (composite_fwd's mark_done)."""
    if t_in is None:
        return (torch.ones((num_tiles, PIX), dtype=torch.float32,
                           device=device),
                torch.zeros((num_tiles, PIX), dtype=torch.bool,
                            device=device))
    return t_in.abs(), t_in <= T_EPS


def composite_fwd_plain(feat, tile_start, tile_count, ntx: int, nc: int,
                        t_in=None, tile0: int = 0, mark_done: bool = False):
    """The compositing loop vectorised over all tiles and pixels, one
    Python iteration per within-tile pair index."""
    num_tiles = tile_start.shape[0]
    dev = feat.device
    flat = feat.reshape(-1, NFEAT, K)
    px, py = _pixel_centers(num_tiles, ntx, dev, tile0)
    T, done = _initial_state(num_tiles, dev, t_in)
    accum = torch.zeros((num_tiles, PIX, nc), dtype=torch.float32,
                        device=dev)
    ncon = torch.zeros((num_tiles, PIX), dtype=torch.int32, device=dev)
    start = tile_start.to(torch.int64)
    count = tile_count.to(torch.int64)
    n_iter = int(count.max()) if num_tiles else 0
    for j in range(n_iter):
        live = j < count                                   # (T,)
        idx = torch.where(live, start + j, 0)
        f = flat[idx // K, :, idx % K]                     # (T, NFEAT)
        dx = f[:, 0:1] - px
        dy = f[:, 1:2] - py
        sigma = (0.5 * (f[:, 2:3] * dx * dx + f[:, 4:5] * dy * dy)
                 + f[:, 3:4] * dx * dy)
        alpha = torch.clamp(
            f[:, 5:6] * torch.exp(-torch.clamp(sigma, min=0.0)),
            max=ALPHA_CLAMP)
        considered = (live[:, None] & (sigma >= SIGMA_MIN)
                      & (alpha >= ALPHA_THRESH) & ~done)
        next_T = T * (1.0 - alpha)
        terminate = considered & (next_T <= T_EPS)
        contrib = considered & ~terminate
        w = torch.where(contrib, alpha * T, torch.zeros_like(T))
        accum += w[..., None] * f[:, None, 6:6 + nc]
        T = torch.where(contrib, next_T, T)
        ncon = torch.where(contrib, j + 1, ncon)
        done |= terminate
        if j % 64 == 63 and bool(done[count > j + 1].all()):
            break
    if mark_done:
        T = torch.where(done, -T, T)
    return accum, T, ncon


def composite_fwd(feat, tile_start, tile_count, ntx: int, nc: int,
                  evals: torch.Tensor | None = None,
                  t_in: torch.Tensor | None = None, tile0: int = 0,
                  mark_done: bool = False):
    """Front-to-back alpha compositing of every 16x16 tile's sorted pair
    range of the packed stream `feat` (rows, 16, 128).

    tile_start/tile_count (T,) int32. Returns accum (T, 256, nc)
    premultiplied colours, T_final (T, 256), n_contrib (T, 256) int32
    (within-tile index after the last contributing pair).

    t_in (T, 256), when given, is the transmittance every pixel starts
    from instead of 1: accum then comes out premultiplied by it and
    T_final continues it. A pixel is done when a pair would push its T to
    1e-4 or below, and keeps the larger T it had before that pair, so the
    magnitude cannot say that it has ended: with mark_done, T_final comes
    back negated for the pixels that are done, and a t_in value that is
    negative (or <= 1e-4) starts its pixel done with T = |t_in|. A chain
    of launches that hands T_final on as the next t_in then ends every
    pixel where one launch over all the pairs would.
    tile0 places the T tiles at [tile0, tile0 + T) of the image's tile
    grid; the ranges and outputs stay indexed from 0. `evals` (a (2 + T,)
    int64 CUDA tensor), when given, has the evaluated (pixel, pair) count
    added to [0], the pairs the tiles needed (per tile the most any pixel
    evaluated) added to [1], and tile t's own need written to [2 + t]; it
    is a measurement aid, CUDA only."""
    if feat.dim() != 3 or tuple(feat.shape[1:]) != (NFEAT, K):
        raise ValueError(f"feat must be (rows, {NFEAT}, {K}), got "
                         f"{tuple(feat.shape)}")
    if not 1 <= nc <= 4:
        raise ValueError(f"1..4 colour channels, got {nc}")
    num_tiles = tile_start.shape[0]
    _cuda.check(feat, "feat", torch.float32)
    for name, t in (("tile_start", tile_start), ("tile_count", tile_count)):
        if t.dtype != torch.int32 or tuple(t.shape) != (num_tiles,):
            raise ValueError(f"{name} must be ({num_tiles},) int32")
    tensors = [feat, tile_start, tile_count]
    if t_in is not None:
        _cuda.check(t_in, "t_in", torch.float32, shape=(num_tiles, PIX))
        tensors.append(t_in)
    if _cuda.is_cpu(*tensors):
        if evals is not None:
            raise ValueError("evals counting needs the CUDA kernel")
        return composite_fwd_plain(feat, tile_start, tile_count, ntx, nc,
                                   t_in, tile0, mark_done)
    for name, t in (("tile_start", tile_start), ("tile_count", tile_count)):
        _cuda.check(t, name, torch.int32)
    if evals is not None:
        _cuda.check(evals, "evals", torch.int64, shape=(2 + num_tiles,))
    dev = feat.device
    accum = torch.empty((num_tiles, PIX, nc), dtype=torch.float32,
                        device=dev)
    tfin = torch.empty((num_tiles, PIX), dtype=torch.float32, device=dev)
    ncon = torch.empty((num_tiles, PIX), dtype=torch.int32, device=dev)
    if num_tiles == 0:
        return accum, tfin, ncon
    FWD_KERNEL.launch(
        "sg_composite_fwd", _cuda.ptr(feat), _cuda.ptr(tile_start),
        _cuda.ptr(tile_count), num_tiles, ntx, nc, tile0,
        _cuda.ptr(t_in) if t_in is not None else None, int(mark_done),
        _cuda.ptr(accum), _cuda.ptr(tfin), _cuda.ptr(ncon),
        _cuda.ptr(evals) if evals is not None else None, _cuda.stream(feat),
        modes=_modes(t_in, tile0))
    return accum, tfin, ncon


# ---------------------------------------------------------------------------
# Kernel E: backward compositor.
# ---------------------------------------------------------------------------

def composite_bwd_plain(feat, tile_start, tile_count, ntx: int, nc: int,
                        g_accum, g_t, tfin, ncon, gdotacc, t_in=None,
                        tile0: int = 0):
    """The forward replay vectorised over all tiles and pixels, one Python
    iteration per within-tile pair index, with kernel E's formulas."""
    num_tiles = tile_start.shape[0]
    dev = feat.device
    flat = feat.reshape(-1, NFEAT, K)
    gpair = torch.zeros_like(flat)
    if num_tiles == 0:
        return gpair
    ng = 6 + nc
    px, py = _pixel_centers(num_tiles, ntx, dev, tile0)
    T, done = _initial_state(num_tiles, dev, t_in)
    cum_u = torch.zeros_like(T)
    zero = torch.zeros_like(T)
    start = tile_start.to(torch.int64)
    my_n = torch.minimum(ncon.to(torch.int64),
                         tile_count.to(torch.int64)[:, None])
    nmax = my_n.amax(dim=1)
    gt_tfin = g_t * tfin
    for j in range(int(nmax.max())):
        live = j < nmax                                    # (T,)
        idx = torch.where(live, start + j, 0)
        f = flat[idx // K, :, idx % K]                     # (T, NFEAT)
        dx = f[:, 0:1] - px
        dy = f[:, 1:2] - py
        ca, cb, cc = f[:, 2:3], f[:, 3:4], f[:, 4:5]
        sigma = 0.5 * (ca * dx * dx + cc * dy * dy) + cb * dx * dy
        falloff = torch.exp(-torch.clamp(sigma, min=0.0))
        alpha = torch.clamp(f[:, 5:6] * falloff, max=ALPHA_CLAMP)
        considered = ((j < my_n) & (sigma >= SIGMA_MIN)
                      & (alpha >= ALPHA_THRESH) & ~done)
        next_T = T * (1.0 - alpha)
        terminate = considered & (next_T <= T_EPS)
        contrib = considered & ~terminate
        w = torch.where(contrib, alpha * T, zero)
        gc = zero
        for c in range(nc):
            gc = gc + g_accum[..., c] * f[:, 6 + c:7 + c]
        cum_u = cum_u + torch.where(contrib, gc * w, zero)
        om = 1.0 - alpha
        dl_da = torch.where(
            contrib & (alpha < ALPHA_CLAMP),
            gc * T - (gdotacc - cum_u) / om - gt_tfin / om, zero)
        dl_ds = torch.where(sigma > 0.0, -alpha * dl_da, zero)
        cols = [dl_ds * (ca * dx + cb * dy), dl_ds * (cc * dy + cb * dx),
                dl_ds * (0.5 * dx * dx), dl_ds * (dx * dy),
                dl_ds * (0.5 * dy * dy), dl_da * falloff]
        cols += [w * g_accum[..., c] for c in range(nc)]
        vals = torch.stack(cols, dim=-1).sum(dim=1)        # (T, ng)
        rows, lanes = (idx // K)[live], (idx % K)[live]
        gpair[rows, :ng, lanes] = vals[live]
        gpair[rows, RANK_ROW, lanes] = f[live, RANK_ROW]
        T = torch.where(contrib, next_T, T)
        done |= terminate
    return gpair


def visited_counts(ncon: torch.Tensor,
                   tile_count: torch.Tensor) -> torch.Tensor:
    """(T,) int32: the pairs each tile's backward visits, the first
    max(n_contrib) of its range."""
    return torch.minimum(ncon.amax(dim=1), tile_count)


def _poison_unvisited(gpair, tile_start, tile_count, ncon) -> torch.Tensor:
    """gpair with NaN wherever kernel E writes nothing: every pair slot
    no tile visited, and rows 11..15 of all of them."""
    pair = _visited_pairs(tile_start, visited_counts(ncon, tile_count))
    out = torch.full_like(gpair, float("nan"))
    rows, lanes = pair // K, pair % K
    out[rows, :RANK_ROW + 1, lanes] = gpair[rows, :RANK_ROW + 1, lanes]
    return out


def composite_bwd(feat, tile_start, tile_count, ntx: int, nc: int,
                  g_accum, g_t, tfin, ncon, accum,
                  evals: torch.Tensor | None = None,
                  t_in: torch.Tensor | None = None,
                  tile0: int = 0,
                  zero_fill: bool = True) -> torch.Tensor:
    """Per-pair gradients of the compositor, in the stream's layout.

    feat, tile_start, tile_count, ntx, nc, t_in, tile0 as composite_fwd
    took them;
    g_accum (T, 256, nc) and g_t (T, 256) are the cotangents of its accum
    and T_final; tfin, ncon, accum are its outputs. Returns gpair (rows,
    16, 128) float32 in sorted pair order: rows 0..5+nc hold dL/d[x, y,
    conic a, b, c, opacity, colour 0..nc-1] summed over the tile's pixels,
    row 10 the pair's depth rank copied from the stream, and zeros
    wherever no pixel of the tile reached the pair. With zero_fill=False
    only rows 0..10 of the visited pairs (a tile's first `visited_counts`
    pairs) are defined: the kernel writes into uninitialised memory and spares the
    fill of the whole stream, and the CPU version puts NaN there so that a
    reader of an undefined row shows. `evals` (a (3,) int64
    CUDA tensor), when given, has the evaluated (pixel, pair) count added
    to [0], the visited pairs to [1] and the evaluations that contributed
    to [2]."""
    if feat.dim() != 3 or tuple(feat.shape[1:]) != (NFEAT, K):
        raise ValueError(f"feat must be (rows, {NFEAT}, {K}), got "
                         f"{tuple(feat.shape)}")
    if not 1 <= nc <= 4:
        raise ValueError(f"1..4 colour channels, got {nc}")
    num_tiles = tile_start.shape[0]
    f32, i32 = torch.float32, torch.int32
    operands = (("feat", feat, f32, None),
                ("tile_start", tile_start, i32, (num_tiles,)),
                ("tile_count", tile_count, i32, (num_tiles,)),
                ("g_accum", g_accum, f32, (num_tiles, PIX, nc)),
                ("g_t", g_t, f32, (num_tiles, PIX)),
                ("tfin", tfin, f32, (num_tiles, PIX)),
                ("ncon", ncon, i32, (num_tiles, PIX)),
                ("accum", accum, f32, (num_tiles, PIX, nc)))
    if t_in is not None:
        operands += (("t_in", t_in, f32, (num_tiles, PIX)),)
    for name, t, dtype, shape in operands:
        _cuda.check(t, name, dtype, shape=shape)
    if _cuda.is_cpu(*(t for _, t, _, _ in operands)):
        if evals is not None:
            raise ValueError("evals counting needs the CUDA kernel")
        gdotacc = torch.sum(g_accum * accum, dim=-1)
        gpair = composite_bwd_plain(feat, tile_start, tile_count, ntx, nc,
                                    g_accum, g_t, tfin, ncon, gdotacc, t_in,
                                    tile0)
        return gpair if zero_fill else _poison_unvisited(
            gpair, tile_start, tile_count, ncon)
    if evals is not None:
        _cuda.check(evals, "evals", torch.int64, shape=(3,))
    gpair = torch.zeros_like(feat) if zero_fill else torch.empty_like(feat)
    if num_tiles == 0:
        return gpair
    BWD_KERNEL.launch(
        "sg_composite_bwd", _cuda.ptr(feat), _cuda.ptr(tile_start),
        _cuda.ptr(tile_count), num_tiles, ntx, nc, tile0,
        _cuda.ptr(t_in) if t_in is not None else None, _cuda.ptr(g_accum),
        _cuda.ptr(g_t), _cuda.ptr(tfin), _cuda.ptr(ncon), _cuda.ptr(accum),
        _cuda.ptr(gpair), _cuda.ptr(evals) if evals is not None else None,
        _cuda.stream(feat), modes=_modes(t_in, tile0))
    return gpair


# ---------------------------------------------------------------------------
# The gradient reduces: per-pair rows -> per-gaussian sums.
# ---------------------------------------------------------------------------

def _unsort_rank_sums(rank_sums: torch.Tensor,
                      depth_order: torch.Tensor) -> torch.Tensor:
    """(G, N) depth-rank sums -> (N, G) gradients in the gaussians'
    original order (depth_order is a permutation: rank -> index)."""
    out = torch.empty((rank_sums.shape[1], rank_sums.shape[0]),
                      dtype=rank_sums.dtype, device=rank_sums.device)
    out[depth_order.to(torch.int64)] = rank_sums.T
    return out


def _visited_pairs(tile_start, nvis) -> torch.Tensor:
    """Sorted-pair indices of every tile's first nvis pairs, tile by tile
    (int64). The total is read from the device."""
    num_tiles = tile_start.shape[0]
    dev = tile_start.device
    nvis = nvis.to(torch.int64)
    tile_of = torch.repeat_interleave(
        torch.arange(num_tiles, device=dev), nvis)
    first = torch.cumsum(nvis, 0) - nvis
    within = torch.arange(tile_of.shape[0], device=dev) - first[tile_of]
    return tile_start.to(torch.int64)[tile_of] + within


def _reduce_pair_grads_ranked(gpair, tile_start, nvis, depth_order,
                              num_gaussians: int,
                              unsort: bool = True) -> torch.Tensor:
    """Rank-keyed gradient reduction of the fused paths: gpair (rows, 16,
    128) from composite_bwd, nvis (T,) the pairs each tile's backward
    visited -> (N, 10) per-gaussian gradients, or with unsort=False the
    (10, N) sums per depth rank. Only the visited pairs are gathered and
    sorted: everything else in gpair is zero."""
    pair = _visited_pairs(tile_start, nvis)
    g = gpair[pair // K, :RANK_ROW + 1, pair % K]           # (L, 11)
    # Stable, so pairs of one rank stay in pair order and the sums repeat
    # from run to run.
    rank_s, perm = torch.sort(g[:, RANK_ROW].to(torch.int32), stable=True)
    rows11 = g.index_select(0, perm).T.contiguous()          # (11, L)
    rank_sums = rank_rowsum(rows11, rank_s, num_gaussians)
    return _unsort_rank_sums(rank_sums, depth_order) if unsort else rank_sums


def _reduce_pair_grads(gpair: torch.Tensor, bins: TileBins,
                       nc: int) -> torch.Tensor:
    """Gradient reduction over shared bins: gpair (rows, 16, 128) from
    composite_bwd -> (N, 6 + nc) per-gaussian gradients. The live rows go
    back to expansion order, where every depth rank's pairs are one
    contiguous run [exp_starts, exp_starts + exp_counts), kernel G sums
    the runs, and depth_order un-sorts the sums. exp_slot is a permutation
    on the valid pairs, so the way back is a scatter by it (the JAX
    package sorts by it, which XLA does faster than it scatters); invalid
    pairs carry the sentinel max_pairs and fall into a spare column. Row
    10 of gpair (the fused paths' rank) is not read."""
    max_pairs = bins.exp_slot.shape[0]
    ng = 6 + nc
    cols = gpair[:max_pairs // K, :ng].permute(1, 0, 2).reshape(ng, max_pairs)
    rows_cm = torch.zeros((ng, max_pairs + 1), dtype=torch.float32,
                          device=gpair.device)
    rows_cm.index_copy_(1, bins.exp_slot.to(torch.int64), cols)
    starts = bins.exp_starts.clamp(0, max_pairs)
    ends = (bins.exp_starts + bins.exp_counts).clamp(0, max_pairs)
    rank_sums = segment_rowsum(rows_cm[:, :max_pairs].contiguous(), starts,
                               ends)                          # (ng, N)
    return _unsort_rank_sums(rank_sums, bins.depth_order)


# ---------------------------------------------------------------------------
# Tile layout <-> image, and the pieces the rasterizers share.
# ---------------------------------------------------------------------------

def _tiles_to_image(tiles: torch.Tensor, ntx: int, nty: int, width: int,
                    height: int) -> torch.Tensor:
    """(T, PIX, C) or (T, PIX) tile layout -> (H, W, ...) image crop."""
    squeeze = tiles.dim() == 2
    if squeeze:
        tiles = tiles[..., None]
    c = tiles.shape[-1]
    img = tiles.reshape(nty, ntx, TILE, TILE, c).permute(0, 2, 1, 3, 4)
    img = img.reshape(nty * TILE, ntx * TILE, c)[:height, :width]
    return img[..., 0] if squeeze else img


def _img_to_tiles(img: torch.Tensor, c: int, ntx: int, nty: int, width: int,
                  height: int) -> torch.Tensor:
    """(H, W[, C]) image -> (T, PIX, C) tile layout, zero-padded to whole
    tiles."""
    img = img.reshape(height, width, c)
    img = torch.nn.functional.pad(
        img, (0, 0, 0, ntx * TILE - width, 0, nty * TILE - height))
    return img.reshape(nty, TILE, ntx, TILE, c).permute(0, 2, 1, 3, 4).reshape(
        ntx * nty, PIX, c).contiguous()


def _grid(width: int, height: int):
    return (width + TILE - 1) // TILE, (height + TILE - 1) // TILE


def _cotangent_tiles(g_img, g_alpha, dims, device):
    """Image cotangents -> (g_accum (T, PIX, C), g_t (T, PIX)) in tile
    layout; alpha = 1 - T_final, so dL/dT_final = -g_alpha. A missing
    cotangent counts as zeros."""
    ntx, nty, width, height, nc = dims
    if g_img is None:
        g_img = torch.zeros((height, width, nc), dtype=torch.float32,
                            device=device)
    if g_alpha is None:
        g_alpha = torch.zeros((height, width), dtype=torch.float32,
                              device=device)
    g_accum = _img_to_tiles(g_img.to(torch.float32), nc, ntx, nty, width,
                            height)
    g_t = -_img_to_tiles(g_alpha.to(torch.float32), 1, ntx, nty, width,
                         height)[..., 0]
    return g_accum, g_t.contiguous()


def _input_grads(seg: torch.Tensor, nc: int, colors_dtype):
    """(N, 6 + nc) per-gaussian sums -> the gradients of (xys, conics,
    colors, opacities)."""
    return (seg[:, 0:2], seg[:, 2:5], seg[:, 6:6 + nc].to(colors_dtype),
            seg[:, 5])


def _bwd_from_tiles(feat, tile_start, tile_count, ntx: int, accum, tfin,
                    ncon, g_accum, g_t, depth_order, num_gaussians: int,
                    unsort: bool = True, t_in=None,
                    tile0: int = 0) -> torch.Tensor:
    """Backward from tile-layout cotangents (g_accum (T, PIX, C) of the
    premultiplied accum, g_t (T, PIX) of T_final): kernel E, then the
    rank-keyed reduce -> (N, 10) per-gaussian gradients, or with
    unsort=False the (10, N) sums per depth rank (the sliced path adds its
    windows' sums and un-sorts once). t_in, tile0 as composite_fwd took
    them. The reduce reads the visited pairs only, so kernel E is not
    asked to define the rest of the stream."""
    nc = accum.shape[-1]
    nvis = visited_counts(ncon, tile_count)
    gpair = composite_bwd(feat, tile_start, tile_count, ntx, nc, g_accum,
                          g_t, tfin, ncon, accum, t_in=t_in, tile0=tile0,
                          zero_fill=False)
    return _reduce_pair_grads_ranked(gpair, tile_start, nvis, depth_order,
                                     num_gaussians, unsort=unsort)


def _depth_key(proj) -> torch.Tensor:
    """The depth-sort key: +inf marks the gaussians that hit no tile."""
    return torch.where(proj.num_tiles_hit > 0, proj.depths,
                       torch.full_like(proj.depths, float("inf"))).detach()


def _check_tile_size(tile_size: int) -> None:
    if tile_size != TILE:
        raise ValueError(f"the compositor is specialised to {TILE}x{TILE} "
                         f"tiles, got {tile_size}")


# ---------------------------------------------------------------------------
# The fused rasterizer.
# ---------------------------------------------------------------------------

class _FusedRasterize(torch.autograd.Function):
    """Binning + feature threading + compositing as one autograd node, so
    the sorts and expansions that move the feature columns are never
    differentiated: the pair enumeration is a constant of the backward,
    and the gradients of xys, conics, colours and opacities come from the
    replayed compositor (kernel E) and the rank-keyed reduce (kernel F).
    depth_key and tile_box get no gradient."""

    @staticmethod
    def forward(ctx, xys, conics, colors, opacities, depth_key, tile_box,
                width, height, max_pairs, max_rowruns, last_color_is_depth,
                precision):
        ntx, nty = _grid(width, height)
        nc = colors.shape[-1]
        bins, feats = bin_and_pack(
            xys, conics, tile_box, depth_key, colors.to(torch.float32),
            opacities, width, height, TILE, max_pairs, max_rowruns,
            last_color_is_depth=last_color_is_depth, precision=precision)
        feat = pack_feat_cols(feats, max_pairs)
        accum, tfin, ncon = composite_fwd(feat, bins.tile_start,
                                          bins.tile_count, ntx, nc)
        ctx.save_for_backward(feat, bins.tile_start, bins.tile_count, accum,
                              tfin, ncon, bins.depth_order)
        ctx.dims = (ntx, nty, width, height, nc)
        ctx.colors_dtype = colors.dtype
        img = _tiles_to_image(accum, ntx, nty, width, height)
        alpha = 1.0 - _tiles_to_image(tfin, ntx, nty, width, height)
        return img, alpha, bins

    @staticmethod
    def backward(ctx, g_img, g_alpha, _g_bins):
        feat, tile_start, tile_count, accum, tfin, ncon, depth_order = \
            ctx.saved_tensors
        ntx, nc = ctx.dims[0], ctx.dims[4]
        g_accum, g_t = _cotangent_tiles(g_img, g_alpha, ctx.dims,
                                        feat.device)
        seg = _bwd_from_tiles(feat, tile_start, tile_count, ntx, accum, tfin,
                              ncon, g_accum, g_t, depth_order,
                              depth_order.shape[0])
        return (*_input_grads(seg, nc, ctx.colors_dtype),
                None, None, None, None, None, None, None, None)


# ---------------------------------------------------------------------------
# The depth-sliced fused rasterizer.
# ---------------------------------------------------------------------------

def _slice_caps(max_pairs: int, max_rowruns: int | None, n_slices: int):
    """A slice's pair and run capacities: its share of the totals, rounded
    up to a multiple of 8192."""
    if max_rowruns is None:
        max_rowruns = max_pairs // 2
    mp = (-(-max_pairs // n_slices) + 8191) // 8192 * 8192
    mr = (-(-max_rowruns // n_slices) + 8191) // 8192 * 8192
    return mp, mr


class _SlicedRasterize(torch.autograd.Function):
    """_FusedRasterize in k depth-rank windows (max_pairs / max_rowruns
    are the totals, split evenly). The gaussians are depth-sorted and
    row-trimmed once; the windows' bounds sit at the pair-count quantiles
    of the sorted order, so the windows hold about the same number of
    pairs; each window is binned, packed and composited on its own, a
    later one continuing the transmittance and the done state the earlier
    ones left (kernel D's t_in and mark_done), so the windows' accums add
    up to the unsliced image, every pixel ends at the pair where the
    unsliced render ends it, and a pixel that has ended costs the later
    windows nothing; a tile whose every pixel has ended drops its count.
    (The JAX package hands on the transmittance alone and tests it
    against 1e-4, which a pixel that has ended never falls to: there a
    pixel ended by one window may take pairs of the next.)

    The bins it returns report num_pairs / num_rowruns as the capacity
    demand, k times the largest window's true count (at least the true
    total), so a caller that grows the capacities by them keeps every
    window from dropping pairs; tile_count is the sum of the windows'
    counts before any tile was dropped (the scene's true densest tile);
    the per-window fields are None."""

    @staticmethod
    def forward(ctx, xys, conics, colors, opacities, depth_key, tile_box,
                width, height, max_pairs, max_rowruns, n_slices,
                last_color_is_depth, precision):
        ntx, nty = _grid(width, height)
        nc = colors.shape[-1]
        n = depth_key.shape[0]
        dev = xys.device
        mp_s, mr_s = _slice_caps(max_pairs, max_rowruns, n_slices)
        cols = _depth_sort_cols(xys, conics, tile_box, depth_key,
                                colors.to(torch.float32), opacities,
                                last_color_is_depth, precision)
        trim = _trim_full(cols, TILE, nty)
        cnt_full = torch.where(torch.isfinite(cols[0]) & (trim[2] > 0),
                               trim[2], 0)
        # int64 for the quantiles: s * total passes 2^31 at a few slices
        # of a few hundred million pairs. The bounds stay on the device.
        cum = scan.cumsum_flat(cnt_full).to(torch.int64)
        total = cum[-1] if n > 0 else torch.zeros((), dtype=torch.int64,
                                                  device=dev)
        qs = torch.stack([(s * total) // n_slices
                          for s in range(1, n_slices)])
        inner = torch.searchsorted(cum, qs, side="left")
        bounds = [torch.zeros((), dtype=torch.int64, device=dev),
                  *inner.unbind(0),
                  torch.full((), n, dtype=torch.int64, device=dev)]

        c_agg = None
        t_prev = None
        tile_count_true = None
        saved, demand_p, demand_r = [], [], []
        for s in range(n_slices):
            bins_s, feats_s = _bin_sorted(
                cols, None, width, height, TILE, mp_s, mr_s,
                rank_window=(bounds[s], bounds[s + 1]), trim=trim)
            tile_count = bins_s.tile_count
            tile_count_true = (tile_count if tile_count_true is None
                               else tile_count_true + tile_count)
            if s > 0:
                # t_prev carries a minus sign on the pixels that are done.
                t_done = t_prev.amax(dim=1) <= T_EPS
                tile_count = torch.where(t_done, 0, tile_count)
            feat_s = pack_feat_cols(feats_s, mp_s)
            accum_s, t_signed, ncon_s = composite_fwd(
                feat_s, bins_s.tile_start, tile_count, ntx, nc, t_in=t_prev,
                mark_done=True)
            tfin_s = t_signed.abs()
            c_agg = accum_s if c_agg is None else c_agg + accum_s
            saved += [feat_s, bins_s.tile_start, tile_count, accum_s, tfin_s,
                      ncon_s]
            demand_p.append(bins_s.num_pairs)
            demand_r.append(bins_s.num_rowruns)
            t_prev = t_signed

        depth_order = cols[1].to(torch.int32)
        ctx.save_for_backward(depth_order, *saved)
        ctx.dims = (ntx, nty, width, height, nc)
        ctx.colors_dtype = colors.dtype
        img = _tiles_to_image(c_agg, ntx, nty, width, height)
        alpha = 1.0 - _tiles_to_image(tfin_s, ntx, nty, width, height)
        bins = TileBins(
            pair_valid=None, tile_start=None, tile_count=tile_count_true,
            num_pairs=n_slices * torch.stack(demand_p).max(),
            num_rowruns=n_slices * torch.stack(demand_r).max(),
            depth_order=depth_order, exp_starts=None, exp_counts=None,
            num_tiles_x=ntx, num_tiles_y=nty)
        return img, alpha, bins

    @staticmethod
    def backward(ctx, g_img, g_alpha, _g_bins):
        depth_order, *saved = ctx.saved_tensors
        per_slice = [saved[i:i + 6] for i in range(0, len(saved), 6)]
        ntx, nc = ctx.dims[0], ctx.dims[4]
        n = depth_order.shape[0]
        g_c, g_t = _cotangent_tiles(g_img, g_alpha, ctx.dims,
                                    depth_order.device)
        # The composite is a chain: window s maps (T_in_s, its stream) to
        # (accum_s, T_out_s) with T_in_{s+1} = T_out_s, C = sum_s accum_s,
        # alpha = 1 - T_out_{k-1}. dL/daccum_s = g_C for every window;
        # dL/dT_out goes backward through each window's linearity in its
        # T_in (with the termination pattern held, accum_s and T_out_s are
        # T_in times their values from T_in = 1):
        #   dL/dT_in_s = (<g_C, accum_s> + g_T_out_s T_out_s) / T_in_s,
        # passed through unchanged where T_in_s <= T_EPS (the window added
        # nothing there and T_out = T_in). The ranks are global and the
        # windows' rank sets disjoint, so the k windows' rank sums (one
        # launch of kernel F each, over that window's visited pairs) add
        # exactly, and the un-sort is paid once.
        rank_sums = None
        for s in range(len(per_slice) - 1, -1, -1):
            feat_s, tile_start, tile_count, accum_s, tfin_s, ncon_s = \
                per_slice[s]
            t_in_s = per_slice[s - 1][4] if s > 0 else None
            rs = _bwd_from_tiles(feat_s, tile_start, tile_count, ntx,
                                 accum_s, tfin_s, ncon_s, g_c, g_t,
                                 depth_order, n, unsort=False, t_in=t_in_s)
            rank_sums = rs if rank_sums is None else rank_sums + rs
            if s > 0:
                gdota = torch.sum(g_c * accum_s, dim=-1)
                g_t = torch.where(
                    t_in_s > T_EPS,
                    (gdota + g_t * tfin_s) / t_in_s.clamp(min=T_EPS), g_t)
        seg = _unsort_rank_sums(rank_sums, depth_order)
        return (*_input_grads(seg, nc, ctx.colors_dtype),
                None, None, None, None, None, None, None, None, None)


def rasterize_tiles_fused(proj, colors: torch.Tensor,
                          opacities: torch.Tensor, width: int, height: int,
                          tile_size: int, background: torch.Tensor,
                          max_pairs: int, max_rowruns: int | None = None,
                          last_color_is_depth: bool = False,
                          precision: str = "f32", depth_slices: int = 1):
    """Bin (ops.tiles.bin_and_pack) + pack (kernel C) + composite
    (kernel D), differentiable in proj.xys, proj.conics, colors and
    opacities through kernels E and F; returns (img (H, W, C), alpha
    (H, W), bins). depth_slices > 1 composites that many depth-rank
    windows one after another (_SlicedRasterize): the same image, each
    sort over a share of the pairs. precision="bf16" rounds the feature
    columns to bf16 before the pairs are enumerated (ops.tiles.
    _depth_sort_cols). The background blend stays outside the autograd
    node."""
    _check_tile_size(tile_size)
    if depth_slices < 1:
        raise ValueError(f"depth_slices must be >= 1, got {depth_slices}")
    if depth_slices > 1:
        img, alpha, bins = _SlicedRasterize.apply(
            proj.xys, proj.conics, colors, opacities, _depth_key(proj),
            proj.tile_box, width, height, max_pairs, max_rowruns,
            depth_slices, last_color_is_depth, precision)
    else:
        img, alpha, bins = _FusedRasterize.apply(
            proj.xys, proj.conics, colors, opacities, _depth_key(proj),
            proj.tile_box, width, height, max_pairs, max_rowruns,
            last_color_is_depth, precision)
    img = img + (1.0 - alpha[..., None]) * background[None, None, :]
    return img, alpha, bins


# ---------------------------------------------------------------------------
# The unfused rasterizer: bins shared by the caller.
# ---------------------------------------------------------------------------

def _build_feat(xys, conics, colors, opacities, bins: TileBins):
    """Splat attributes gathered into sorted pair order and packed as the
    (max_pairs // 128 + 1, 16, 128) stream: row r, lane j = sorted pair
    r * 128 + j, the last row zeros. A per-gaussian (N + 1, 16) table is
    packed first so that the per-pair gather reads one 64-byte row; its
    row N is all zero, and invalid pairs gather it (alpha 0). Feature
    rows 6 + nc .. 15 are zero: this stream carries no depth rank."""
    nc = colors.shape[-1]
    max_pairs = bins.gauss_idx.shape[0]
    n = xys.shape[0]
    if max_pairs % K:
        raise ValueError(f"max_pairs must be a multiple of {K}, got "
                         f"{max_pairs}")
    f32 = torch.float32
    table = torch.cat([
        xys.to(f32), conics.to(f32), opacities.to(f32)[:, None],
        colors.to(f32),
        torch.zeros((n, NFEAT - 6 - nc), dtype=f32, device=xys.device)],
        dim=-1)
    table = torch.cat([table, torch.zeros((1, NFEAT), dtype=f32,
                                          device=xys.device)])
    idx = torch.where(bins.pair_valid, bins.gauss_idx, n).to(torch.int64)
    rows = table.index_select(0, idx)                        # (P, NFEAT)
    feat = rows.reshape(max_pairs // K, K, NFEAT).transpose(1, 2)
    return torch.cat([feat, torch.zeros((1, NFEAT, K), dtype=f32,
                                        device=xys.device)]).contiguous()


class _UnfusedRasterize(torch.autograd.Function):
    """Compositing over bins that are a constant of the node: the stream
    is gathered per pair (_build_feat), kernel D composites it, and the
    backward is kernel E on that stream (its row 10 zero) and the
    expansion-order reduce through kernel G (_reduce_pair_grads)."""

    @staticmethod
    def forward(ctx, xys, conics, colors, opacities, bins, width, height):
        ntx, nty = bins.num_tiles_x, bins.num_tiles_y
        nc = colors.shape[-1]
        feat = _build_feat(xys, conics, colors, opacities, bins)
        accum, tfin, ncon = composite_fwd(feat, bins.tile_start,
                                          bins.tile_count, ntx, nc)
        ctx.save_for_backward(feat, accum, tfin, ncon)
        ctx.bins = bins
        ctx.dims = (ntx, nty, width, height, nc)
        ctx.colors_dtype = colors.dtype
        img = _tiles_to_image(accum, ntx, nty, width, height)
        alpha = 1.0 - _tiles_to_image(tfin, ntx, nty, width, height)
        return img, alpha

    @staticmethod
    def backward(ctx, g_img, g_alpha):
        feat, accum, tfin, ncon = ctx.saved_tensors
        bins = ctx.bins
        ntx, nc = ctx.dims[0], ctx.dims[4]
        g_accum, g_t = _cotangent_tiles(g_img, g_alpha, ctx.dims,
                                        feat.device)
        gpair = composite_bwd(feat, bins.tile_start, bins.tile_count, ntx,
                              nc, g_accum, g_t, tfin, ncon, accum)
        seg = _reduce_pair_grads(gpair, bins, nc)
        return (*_input_grads(seg, nc, ctx.colors_dtype), None, None, None)


def rasterize_tiles_pallas(xys, conics, colors, opacities, bins: TileBins,
                           width: int, height: int, tile_size: int,
                           background: torch.Tensor):
    """The kernel compositor over shared bins (ops.tiles.bin_gaussians),
    with no per-tile cap; same contract as
    ops.composite_chunked.rasterize_tiles_chunked: returns (img (H, W, C),
    alpha (H, W)). It keeps the name of the JAX function it ports."""
    _check_tile_size(tile_size)
    if bins.gauss_idx is None or bins.exp_slot is None:
        raise ValueError("these bins carry no gauss_idx / exp_slot: they "
                         "must come from ops.tiles.bin_gaussians")
    img, alpha = _UnfusedRasterize.apply(xys, conics, colors, opacities,
                                         bins, width, height)
    img = img + (1.0 - alpha[..., None]) * background[None, None, :]
    return img, alpha


# ---------------------------------------------------------------------------
# Fused compositing of a strip of tiles.
# ---------------------------------------------------------------------------

def _balanced_window(cols, n: int, sl0: int, slice_size: int, nty: int,
                     gather):
    """Pair-balanced depth window of one device of a model group
    (JAX composite_pallas.py `_balanced_window`). Each device row-trims
    its equal-count window [sl0, sl0 + slice_size) of the depth order the
    group shares; `gather` (x -> the group's x concatenated along dim 0 in
    device order; every device of the group calls it) all-gathers the
    (first, last, count) columns (the equal windows partition the order,
    so the gather is the full-N trim), takes the cumulative pair count (kernel A) and sets
    the window bounds at its quantiles, clamped so every window fits the
    static size s_cap = min(2 slice_size, n) and the windows left can
    still cover the tail; every device computes the same bounds. Returns
    (anchor, s_cap, (local_lo, local_hi), full trim): the device's ranks
    are [anchor + local_lo, anchor + local_hi) of the window [anchor,
    anchor + s_cap), anchored at min(b_m, n - s_cap) so that the window
    never has to be shifted back from the tail (which would move the
    ranks it composites). Bounds are int64."""
    window = slice(sl0, sl0 + slice_size)
    dk_s, order, fs, box_s = cols
    first_l, last_l, cnt_l = _trim_full(
        (dk_s[window], order[window], fs[window], box_s[window]), TILE, nty)
    firsts, lasts, cnts = (gather(x) for x in (first_l, last_l, cnt_l))
    m_size = firsts.shape[0] // slice_size
    cnt_full = torch.where(torch.isfinite(dk_s) & (cnts > 0), cnts, 0)
    cum = scan.cumsum_flat(cnt_full).to(torch.int64)
    total = cum[-1]
    s_cap = min(2 * slice_size, n)
    dev = dk_s.device
    bounds = [torch.zeros((), dtype=torch.int64, device=dev)]
    for j in range(1, m_size):
        q = torch.searchsorted(cum, ((j * total) // m_size).reshape(1),
                               side="left")[0]
        lo = torch.clamp(bounds[-1], min=n - (m_size - j) * s_cap)
        bounds.append(torch.minimum(torch.maximum(q, lo), bounds[-1] + s_cap))
    bounds.append(torch.full((), n, dtype=torch.int64, device=dev))
    m = sl0 // slice_size
    anchor = torch.clamp(bounds[m], max=n - s_cap)
    off = bounds[m] - anchor
    return anchor, s_cap, (off, off + bounds[m + 1] - bounds[m]), (
        firsts, lasts, cnts)


class _StripFusedRasterize(torch.autograd.Function):
    """_FusedRasterize for the tiles [tile0, tile0 + n_tiles) only, in
    tile layout: the scene (or the depth window depth_slice=(start, size)
    of it, pair-balanced through `balance_gather` when one is given) is binned
    whole, then kernels D and E run on the strip's slice of the tile
    ranges with the strip's offset. Tiles past the image's grid are
    empty."""

    @staticmethod
    def forward(ctx, xys, conics, colors, opacities, depth_key, tile_box,
                tile0, n_tiles, width, height, max_pairs, max_rowruns,
                last_color_is_depth, depth_slice, precision, balance_gather):
        ntx, nty = _grid(width, height)
        nc = colors.shape[-1]
        if max_rowruns is None:
            max_rowruns = max_pairs // 2
        cols = _depth_sort_cols(xys, conics, tile_box, depth_key,
                                colors.to(torch.float32), opacities,
                                last_color_is_depth, precision)
        if depth_slice is not None and balance_gather is not None:
            anchor, s_cap, local, trim = _balanced_window(
                cols, depth_key.shape[0], int(depth_slice[0]),
                depth_slice[1], nty, balance_gather)
            bins, feats = _bin_sorted(cols, (anchor, s_cap), width, height,
                                      TILE, max_pairs, max_rowruns,
                                      trim=trim, local_window=local)
        else:
            bins, feats = _bin_sorted(cols, depth_slice, width, height,
                                      TILE, max_pairs, max_rowruns)
        feat = pack_feat_cols(feats, max_pairs)
        # Pad tiles start at the end of the pairs and hold none.
        end = bins.tile_start[-1] + bins.tile_count[-1]
        starts = torch.cat([bins.tile_start, end.expand(n_tiles)])[
            tile0:tile0 + n_tiles].contiguous()
        counts = torch.nn.functional.pad(bins.tile_count, (0, n_tiles))[
            tile0:tile0 + n_tiles].contiguous()
        accum, tfin, ncon = composite_fwd(feat, starts, counts, ntx, nc,
                                          tile0=tile0)
        ctx.save_for_backward(feat, starts, counts, accum, tfin, ncon,
                              bins.depth_order)
        ctx.strip = (ntx, nc, tile0)
        ctx.colors_dtype = colors.dtype
        return accum, 1.0 - tfin, bins

    @staticmethod
    def backward(ctx, g_accum, g_alpha, _g_bins):
        feat, starts, counts, accum, tfin, ncon, depth_order = \
            ctx.saved_tensors
        ntx, nc, tile0 = ctx.strip
        if g_accum is None:
            g_accum = torch.zeros_like(accum)
        g_t = (torch.zeros_like(tfin) if g_alpha is None
               else -g_alpha.to(torch.float32))
        seg = _bwd_from_tiles(feat, starts, counts, ntx, accum, tfin, ncon,
                              g_accum.to(torch.float32).contiguous(),
                              g_t.contiguous(), depth_order,
                              depth_order.shape[0], tile0=tile0)
        return (*_input_grads(seg, nc, ctx.colors_dtype),
                None, None, None, None, None, None, None, None, None, None,
                None, None)


def composite_tiles_fused(proj, colors: torch.Tensor,
                          opacities: torch.Tensor, tile0: int, n_tiles: int,
                          width: int, height: int, max_pairs: int,
                          max_rowruns: int | None = None,
                          last_color_is_depth: bool = False,
                          precision: str = "f32", slice0=0,
                          slice_size: int | None = None,
                          balance_gather=None):
    """Fused bin + pack + composite of the tile strip [tile0, tile0 +
    n_tiles): returns (accum (n_tiles, 256, C) premultiplied, alpha
    (n_tiles, 256), bins), differentiable as rasterize_tiles_fused is.
    With slice_size, only the depth window of that many gaussians from
    depth rank slice0 is binned and composited; alpha is then that
    layer's opacity 1 - T, and layers merge front to back by (C, T) |>
    (C', T') = (C + T C', T T') (parallel.sharded._combine_layers). With
    balance_gather too (x -> the all-gather of x along dim 0 over the
    group of devices that share the depth order, in device order; slice0
    must then be an int, the device's place in the group times
    slice_size), the window is pair-balanced across the group instead
    (_balanced_window): every device of the group must make this call. This is what one device of
    a render sharded over tiles or depth runs."""
    if tile0 < 0 or n_tiles < 0:
        raise ValueError(f"tile0 and n_tiles must be >= 0, got {tile0}, "
                         f"{n_tiles}")
    if balance_gather is not None and slice_size is None:
        raise ValueError("balance_gather needs slice_size")
    depth_slice = None if slice_size is None else (slice0, slice_size)
    return _StripFusedRasterize.apply(
        proj.xys, proj.conics, colors, opacities, _depth_key(proj),
        proj.tile_box, tile0, n_tiles, width, height, max_pairs, max_rowruns,
        last_color_is_depth, depth_slice, precision, balance_gather)
