"""Fused bin + pack + composite, forward and backward — kernels C, D and
E (counterpart of street_gaussians_ns_tpu/ops/composite_pallas.py:
`_pack_feat_cols`, `_fwd_call`, `_bwd_call`, `_tiles_to_image`,
`_img_to_tiles`, `_bwd_from_tiles`, `_reduce_pair_grads_ranked`,
`_unsort_rank_sums`, and `rasterize_tiles_pallas_fused` with
depth_slices=1 as one `torch.autograd.Function`).

Kernel C, `pack_feat_cols` (replaces `composite_pallas.py:_pack_kernel`,
CUDA in `csrc/pack.cu`): interleaves the sorted-pair feature columns into
the (rows_pad, 16, 128) stream, the JAX layout kept bit for bit; rows past
the pair capacity are zero sentinels. Bound by memory bandwidth.

Kernel D, `composite_fwd` (replaces `composite_pallas.py:_fwd_kernel`,
CUDA in `csrc/composite_fwd.cu`): one CTA per 16x16 tile, one thread per
pixel, a running transmittance product per pixel, pairs staged through
shared memory, the CTA exits when all its pixels are done. Its bound is
the larger of the stream's bytes and ~16 float32 operations per evaluated
(pixel, pair); at full width the bytes are larger, and the kernel runs
~4x above them, its densest tiles (18k pairs) each serialized on one SM.

Kernel E, `composite_bwd` (replaces `composite_pallas.py:_bwd_kernel`,
CUDA in `csrc/composite_bwd.cu`): the forward replayed per pixel up to its
n_contrib, the 6 + nc gradient terms of every pair reduced over the tile's
256 pixels (warp shuffles, then shared memory) and stored without atomics
in the stream's layout, the pair's depth rank copied into row 10. Its
bound is the larger of the visited pairs' bytes and its float32
operations: the forward's ~16 per evaluated (pixel, pair) and ~51 more per
evaluation that contributes.

The gradient reduce around kernel F (`ops.segreduce.rank_rowsum`) is plain
PyTorch: the visited pairs are gathered out of the gradient stream by
their tile intervals (a tile's backward visits the first max(n_contrib)
pairs of its range, so no mask pass over the stream is needed), sorted by
rank, summed per rank by kernel F and un-sorted by `depth_order`. The JAX
package's cap ladder and nested conds exist for XLA's static shapes and
have no counterpart.

Each wrapper runs its plain PyTorch version for CPU tensors and launches
its kernel for CUDA tensors.
"""
from __future__ import annotations

import ctypes

import torch

from . import _cuda
from .rasterize_ref import ALPHA_CLAMP, ALPHA_THRESH, SIGMA_MIN, T_EPS
from .segreduce import rank_rowsum
from .tiles import bin_and_pack

TILE = 16
PIX = TILE * TILE     # pixels per tile
K = 128               # pairs per stream row
NFEAT = 16            # feature rows per stream row
RANK_ROW = 10         # stream row that carries the pair's depth rank
NGRAD = 10            # gradient rows: x, y, conic (3), opacity, 4 colours

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
                                  ctypes.c_int, ctypes.c_void_p,
                                  ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.c_void_p, ctypes.c_void_p)},
))

BWD_KERNEL = _cuda.register(_cuda.Kernel(
    name="composite_bwd",
    source="composite_bwd.cu",
    replaces="street_gaussians_ns_tpu/ops/composite_pallas.py:414 "
             "_bwd_kernel",
    entries={"sg_composite_bwd": (ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                  ctypes.c_int, ctypes.c_void_p,
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

def _pixel_centers(num_tiles: int, ntx: int, device):
    """(num_tiles, PIX) pixel-center x and y of every tile's pixels."""
    t = torch.arange(num_tiles, device=device)[:, None]
    lp = torch.arange(PIX, device=device)[None, :]
    px = ((t % ntx) * TILE + lp % TILE).to(torch.float32) + 0.5
    py = ((t // ntx) * TILE + lp // TILE).to(torch.float32) + 0.5
    return px, py


def composite_fwd_plain(feat, tile_start, tile_count, ntx: int, nc: int):
    """The compositing loop vectorised over all tiles and pixels, one
    Python iteration per within-tile pair index."""
    num_tiles = tile_start.shape[0]
    dev = feat.device
    flat = feat.reshape(-1, NFEAT, K)
    px, py = _pixel_centers(num_tiles, ntx, dev)
    T = torch.ones((num_tiles, PIX), dtype=torch.float32, device=dev)
    accum = torch.zeros((num_tiles, PIX, nc), dtype=torch.float32,
                        device=dev)
    ncon = torch.zeros((num_tiles, PIX), dtype=torch.int32, device=dev)
    done = torch.zeros((num_tiles, PIX), dtype=torch.bool, device=dev)
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
    return accum, T, ncon


def composite_fwd(feat, tile_start, tile_count, ntx: int, nc: int,
                  evals: torch.Tensor | None = None):
    """Front-to-back alpha compositing of every 16x16 tile's sorted pair
    range of the packed stream `feat` (rows, 16, 128).

    tile_start/tile_count (T,) int32. Returns accum (T, 256, nc)
    premultiplied colours, T_final (T, 256), n_contrib (T, 256) int32
    (within-tile index after the last contributing pair). `evals` (a (2,)
    int64 CUDA tensor), when given, has the evaluated (pixel, pair) count
    added to [0] and the pairs the tiles needed (per tile the most any
    pixel evaluated) to [1]; it is a measurement aid, CUDA only."""
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
    if _cuda.is_cpu(feat, tile_start, tile_count):
        if evals is not None:
            raise ValueError("evals counting needs the CUDA kernel")
        return composite_fwd_plain(feat, tile_start, tile_count, ntx, nc)
    for name, t in (("tile_start", tile_start), ("tile_count", tile_count)):
        _cuda.check(t, name, torch.int32)
    if evals is not None:
        _cuda.check(evals, "evals", torch.int64, shape=(2,))
    dev = feat.device
    accum = torch.empty((num_tiles, PIX, nc), dtype=torch.float32,
                        device=dev)
    tfin = torch.empty((num_tiles, PIX), dtype=torch.float32, device=dev)
    ncon = torch.empty((num_tiles, PIX), dtype=torch.int32, device=dev)
    if num_tiles == 0:
        return accum, tfin, ncon
    FWD_KERNEL.launch(
        "sg_composite_fwd", _cuda.ptr(feat), _cuda.ptr(tile_start),
        _cuda.ptr(tile_count), num_tiles, ntx, nc, _cuda.ptr(accum),
        _cuda.ptr(tfin), _cuda.ptr(ncon),
        _cuda.ptr(evals) if evals is not None else None, _cuda.stream(feat))
    return accum, tfin, ncon


# ---------------------------------------------------------------------------
# Kernel E: backward compositor.
# ---------------------------------------------------------------------------

def composite_bwd_plain(feat, tile_start, tile_count, ntx: int, nc: int,
                        g_accum, g_t, tfin, ncon, gdotacc):
    """The forward replay vectorised over all tiles and pixels, one Python
    iteration per within-tile pair index, with kernel E's formulas."""
    num_tiles = tile_start.shape[0]
    dev = feat.device
    flat = feat.reshape(-1, NFEAT, K)
    gpair = torch.zeros_like(flat)
    if num_tiles == 0:
        return gpair
    ng = 6 + nc
    px, py = _pixel_centers(num_tiles, ntx, dev)
    T = torch.ones((num_tiles, PIX), dtype=torch.float32, device=dev)
    cum_u = torch.zeros_like(T)
    done = torch.zeros((num_tiles, PIX), dtype=torch.bool, device=dev)
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


def composite_bwd(feat, tile_start, tile_count, ntx: int, nc: int,
                  g_accum, g_t, tfin, ncon, accum,
                  evals: torch.Tensor | None = None) -> torch.Tensor:
    """Per-pair gradients of the compositor, in the stream's layout.

    feat, tile_start, tile_count, ntx, nc as composite_fwd took them;
    g_accum (T, 256, nc) and g_t (T, 256) are the cotangents of its accum
    and T_final; tfin, ncon, accum are its outputs. Returns gpair (rows,
    16, 128) float32 in sorted pair order: rows 0..5+nc hold dL/d[x, y,
    conic a, b, c, opacity, colour 0..nc-1] summed over the tile's pixels,
    row 10 the pair's depth rank copied from the stream, and zeros
    wherever no pixel of the tile reached the pair. `evals` (a (3,) int64
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
    for name, t, dtype, shape in operands:
        _cuda.check(t, name, dtype, shape=shape)
    gdotacc = torch.sum(g_accum * accum, dim=-1)
    if _cuda.is_cpu(*(t for _, t, _, _ in operands)):
        if evals is not None:
            raise ValueError("evals counting needs the CUDA kernel")
        return composite_bwd_plain(feat, tile_start, tile_count, ntx, nc,
                                   g_accum, g_t, tfin, ncon, gdotacc)
    if evals is not None:
        _cuda.check(evals, "evals", torch.int64, shape=(3,))
    gpair = torch.zeros_like(feat)
    if num_tiles == 0:
        return gpair
    BWD_KERNEL.launch(
        "sg_composite_bwd", _cuda.ptr(feat), _cuda.ptr(tile_start),
        _cuda.ptr(tile_count), num_tiles, ntx, nc, _cuda.ptr(g_accum),
        _cuda.ptr(g_t), _cuda.ptr(tfin), _cuda.ptr(ncon), _cuda.ptr(gdotacc),
        _cuda.ptr(gpair), _cuda.ptr(evals) if evals is not None else None,
        _cuda.stream(feat))
    return gpair


# ---------------------------------------------------------------------------
# The gradient reduce: per-pair rows -> per-gaussian sums.
# ---------------------------------------------------------------------------

def _unsort_rank_sums(rank_sums: torch.Tensor,
                      depth_order: torch.Tensor) -> torch.Tensor:
    """(10, N) depth-rank sums -> (N, 10) gradients in the gaussians'
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
                              num_gaussians: int) -> torch.Tensor:
    """Rank-keyed gradient reduction of the fused path: gpair (rows, 16,
    128) from composite_bwd, nvis (T,) the pairs each tile's backward
    visited -> (N, 10) per-gaussian gradients. Only the visited pairs are
    gathered and sorted: everything else in gpair is zero."""
    pair = _visited_pairs(tile_start, nvis)
    g = gpair[pair // K, :RANK_ROW + 1, pair % K]           # (L, 11)
    # Stable, so pairs of one rank stay in pair order and the sums repeat
    # from run to run.
    rank_s, perm = torch.sort(g[:, RANK_ROW].to(torch.int32), stable=True)
    rows11 = g.index_select(0, perm).T.contiguous()          # (11, L)
    return _unsort_rank_sums(rank_rowsum(rows11, rank_s, num_gaussians),
                             depth_order)


# ---------------------------------------------------------------------------
# The fused rasterizer.
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


def _bwd_from_tiles(feat, tile_start, tile_count, ntx: int, accum, tfin,
                    ncon, g_accum, g_t, depth_order,
                    num_gaussians: int) -> torch.Tensor:
    """Backward from tile-layout cotangents (g_accum (T, PIX, C) of the
    premultiplied accum, g_t (T, PIX) of T_final): kernel E, then the
    rank-keyed reduce -> (N, 10) per-gaussian gradients."""
    nc = accum.shape[-1]
    gpair = composite_bwd(feat, tile_start, tile_count, ntx, nc, g_accum,
                          g_t, tfin, ncon, accum)
    nvis = torch.minimum(ncon.amax(dim=1), tile_count)
    return _reduce_pair_grads_ranked(gpair, tile_start, nvis, depth_order,
                                     num_gaussians)


class _FusedRasterize(torch.autograd.Function):
    """Binning + feature threading + compositing as one autograd node, so
    the sorts and expansions that move the feature columns are never
    differentiated: the pair enumeration is a constant of the backward,
    and the gradients of xys, conics, colours and opacities come from the
    replayed compositor (kernel E) and the rank-keyed reduce (kernel F).
    depth_key and tile_box get no gradient."""

    @staticmethod
    def forward(ctx, xys, conics, colors, opacities, depth_key, tile_box,
                width, height, max_pairs, max_rowruns, last_color_is_depth):
        ntx = (width + TILE - 1) // TILE
        nty = (height + TILE - 1) // TILE
        nc = colors.shape[-1]
        bins, feats = bin_and_pack(
            xys, conics, tile_box, depth_key, colors.to(torch.float32),
            opacities, width, height, TILE, max_pairs, max_rowruns,
            last_color_is_depth=last_color_is_depth)
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
        ntx, nty, width, height, nc = ctx.dims
        dev = feat.device
        if g_img is None:
            g_img = torch.zeros((height, width, nc), dtype=torch.float32,
                                device=dev)
        if g_alpha is None:
            g_alpha = torch.zeros((height, width), dtype=torch.float32,
                                  device=dev)
        g_accum = _img_to_tiles(g_img.to(torch.float32), nc, ntx, nty,
                                width, height)
        # alpha = 1 - T_final, so dL/dT_final = -g_alpha.
        g_t = -_img_to_tiles(g_alpha.to(torch.float32), 1, ntx, nty, width,
                             height)[..., 0]
        seg = _bwd_from_tiles(feat, tile_start, tile_count, ntx, accum, tfin,
                              ncon, g_accum, g_t.contiguous(), depth_order,
                              depth_order.shape[0])
        return (seg[:, 0:2], seg[:, 2:5],
                seg[:, 6:6 + nc].to(ctx.colors_dtype), seg[:, 5],
                None, None, None, None, None, None, None)


def rasterize_tiles_fused(proj, colors: torch.Tensor,
                          opacities: torch.Tensor, width: int, height: int,
                          tile_size: int, background: torch.Tensor,
                          max_pairs: int, max_rowruns: int | None = None,
                          last_color_is_depth: bool = False,
                          precision: str = "f32", depth_slices: int = 1):
    """Bin (ops.tiles.bin_and_pack) + pack (kernel C) + composite
    (kernel D), differentiable in proj.xys, proj.conics, colors and
    opacities through kernels E and F; returns (img (H, W, C), alpha
    (H, W), bins). The background blend stays outside the autograd node."""
    if tile_size != TILE:
        raise ValueError(f"the compositor is specialised to {TILE}x{TILE} "
                         f"tiles, got {tile_size}")
    if precision != "f32":
        raise ValueError(f"precision={precision!r} is not ported yet "
                         f"(ROADMAP.md); use 'f32'")
    if depth_slices != 1:
        raise ValueError(f"depth_slices={depth_slices} is not ported yet "
                         f"(ROADMAP.md); use 1")
    depth_key = torch.where(proj.num_tiles_hit > 0, proj.depths,
                            torch.full_like(proj.depths, float("inf")))
    img, alpha, bins = _FusedRasterize.apply(
        proj.xys, proj.conics, colors, opacities, depth_key.detach(),
        proj.tile_box, width, height, max_pairs, max_rowruns,
        last_color_is_depth)
    img = img + (1.0 - alpha[..., None]) * background[None, None, :]
    return img, alpha, bins
