"""Fused bin + pack + composite forward — kernels C and D (counterpart of
street_gaussians_ns_tpu/ops/composite_pallas.py, forward only:
`_pack_feat_cols`, `_fwd_call`, `_tiles_to_image`,
`rasterize_tiles_pallas_fused` with depth_slices=1).

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

Each wrapper runs its plain PyTorch version for CPU tensors and launches
its kernel for CUDA tensors.
"""
from __future__ import annotations

import ctypes

import torch

from . import _cuda
from .rasterize_ref import ALPHA_CLAMP, ALPHA_THRESH, SIGMA_MIN, T_EPS
from .tiles import bin_and_pack

TILE = 16
PIX = TILE * TILE     # pixels per tile
K = 128               # pairs per stream row
NFEAT = 16            # feature rows per stream row

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


def rasterize_tiles_fused(proj, colors: torch.Tensor,
                          opacities: torch.Tensor, width: int, height: int,
                          tile_size: int, background: torch.Tensor,
                          max_pairs: int, max_rowruns: int | None = None,
                          last_color_is_depth: bool = False,
                          precision: str = "f32", depth_slices: int = 1):
    """Bin (ops.tiles.bin_and_pack) + pack (kernel C) + composite
    (kernel D); returns (img (H, W, C), alpha (H, W), bins)."""
    if tile_size != TILE:
        raise ValueError(f"the compositor is specialised to {TILE}x{TILE} "
                         f"tiles, got {tile_size}")
    if precision != "f32":
        raise ValueError(f"precision={precision!r} is not ported yet "
                         f"(ROADMAP.md); use 'f32'")
    if depth_slices != 1:
        raise ValueError(f"depth_slices={depth_slices} is not ported yet "
                         f"(ROADMAP.md); use 1")
    ntx = (width + TILE - 1) // TILE
    nty = (height + TILE - 1) // TILE
    nc = colors.shape[-1]
    depth_key = torch.where(proj.num_tiles_hit > 0, proj.depths,
                            torch.full_like(proj.depths, float("inf")))
    bins, feats = bin_and_pack(
        proj.xys, proj.conics, proj.tile_box, depth_key,
        colors.to(torch.float32), opacities, width, height, TILE,
        max_pairs, max_rowruns, last_color_is_depth=last_color_is_depth)
    feat = pack_feat_cols(feats, max_pairs)
    accum, tfin, _ = composite_fwd(feat, bins.tile_start, bins.tile_count,
                                   ntx, nc)
    img = _tiles_to_image(accum, ntx, nty, width, height)
    alpha = 1.0 - _tiles_to_image(tfin, ntx, nty, width, height)
    img = img + (1.0 - alpha[..., None]) * background[None, None, :]
    return img, alpha, bins
