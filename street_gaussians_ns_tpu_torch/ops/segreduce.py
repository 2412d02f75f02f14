"""Row sums per gaussian — kernels F and G (counterpart of
street_gaussians_ns_tpu/ops/segreduce_pallas.py, `rank_rowsum` and
`segment_rowsum`).

The fused rasterizer's backward emits one gradient row per (gaussian,
tile) pair; `rank_rowsum` sums them per gaussian, keyed by the depth rank
that rides the feature stream. It replaces
`segreduce_pallas.py:_ranksum_kernel`, a rank-equality one-hot matmul on
the MXU. The CUDA kernel (`csrc/ranksum.cu`) uses that the ranks are
sorted, so every rank's pairs are one contiguous run: it zeroes the output
and launches over the pairs, a block owning the runs that start in its
span of 1,024 pairs, and a segmented scan keyed on the run heads sums each
run in one fixed order (coalesced loads, no search per rank). It is bound
by memory bandwidth (the rows once, the sums once) and uses no atomics,
so its sums do not change from run to run.

The JAX package's shared-bins route brings its gradient rows back to
expansion order, where every gaussian's pairs are one contiguous run
whose bounds the bins carry, and sums the runs; `segment_rowsum` is that
sum, which no route of the port calls. It replaces
`segreduce_pallas.py:_segsum_kernel` (a one-hot of the bounds contracted
on the MXU, bf16 inputs). The CUDA kernel (`csrc/segsum.cu`) is kernel
F's design without its search: a block takes 128 consecutive segments,
its warps take the windows of 128 pairs of their covered span in turn,
each summing the runs whose head lies in it, coalesced, with the run
heads and ends marked from the bounds and the same segmented scan in one
fixed order; empty runs are written as 0 by the thread that loads them. Bound by
memory bandwidth; every output written once, so no memset and no atomics.
"""
from __future__ import annotations

import ctypes

import torch

from . import _cuda

KERNEL = _cuda.register(_cuda.Kernel(
    name="rank_rowsum",
    source="ranksum.cu",
    replaces="street_gaussians_ns_tpu/ops/segreduce_pallas.py:92 "
             "_ranksum_kernel",
    entries={"sg_rank_rowsum": (ctypes.c_void_p, ctypes.c_void_p,
                                ctypes.c_void_p, ctypes.c_int,
                                ctypes.c_longlong, ctypes.c_int,
                                ctypes.c_void_p)},
))


def rank_rowsum_plain(rows: torch.Tensor, ranks: torch.Tensor,
                      num_out: int) -> torch.Tensor:
    """`index_add_` into a (C - 1, num_out + 1) buffer whose last column
    is the discard bucket (the JAX fallback's segment_sum)."""
    ng = rows.shape[0] - 1
    buf = torch.zeros((ng, num_out + 1), dtype=torch.float32,
                      device=rows.device)
    buf.index_add_(1, ranks.to(torch.int64).clamp(0, num_out), rows[:ng])
    return buf[:, :num_out].contiguous()


def rank_rowsum(rows: torch.Tensor, ranks: torch.Tensor,
                num_out: int) -> torch.Tensor:
    """out[:, r] = sum of rows[:, p] over the pairs p with ranks[p] == r.

    rows (C, P) float32, whose last row must be `ranks` as float32 (the
    layout the gradient stream arrives in); ranks (P,) int32 sorted
    ascending in [0, num_out], num_out being the discard bucket. Returns
    (C - 1, num_out) float32."""
    if rows.dim() != 2 or rows.dtype != torch.float32 or rows.shape[0] < 2:
        raise ValueError(f"rows must be (C >= 2, P) float32, got "
                         f"{rows.dtype} {tuple(rows.shape)}")
    c, p_len = rows.shape
    if ranks.dtype != torch.int32 or tuple(ranks.shape) != (p_len,):
        raise ValueError(f"ranks must be ({p_len},) int32, got "
                         f"{ranks.dtype} {tuple(ranks.shape)}")
    if num_out < 0:
        raise ValueError(f"num_out must be >= 0, got {num_out}")
    if _cuda.is_cpu(rows, ranks):
        return rank_rowsum_plain(rows, ranks, num_out)
    _cuda.check(rows, "rows", torch.float32)
    _cuda.check(ranks, "ranks", torch.int32)
    out = torch.empty((c - 1, num_out), dtype=torch.float32,
                      device=rows.device)
    if num_out == 0:
        return out
    KERNEL.launch("sg_rank_rowsum", _cuda.ptr(rows), _cuda.ptr(ranks),
                  _cuda.ptr(out), c - 1, p_len, num_out, _cuda.stream(rows))
    return out


SEG_KERNEL = _cuda.register(_cuda.Kernel(
    name="segment_rowsum",
    source="segsum.cu",
    replaces="street_gaussians_ns_tpu/ops/segreduce_pallas.py:42 "
             "_segsum_kernel",
    entries={"sg_segment_rowsum": (ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_int, ctypes.c_longlong,
                                   ctypes.c_int, ctypes.c_void_p)},
))


def segment_rowsum_plain(rows: torch.Tensor, starts: torch.Tensor,
                         ends: torch.Tensor) -> torch.Tensor:
    """Every covered pair gets its segment's id (`repeat_interleave` of
    the run lengths) and the rows are `index_add_`ed per id. (The JAX
    fallback's difference of prefix sums loses precision on prefixes
    millions of pairs long.)"""
    c, p_len = rows.shape
    s = starts.shape[0]
    dev = rows.device
    lo = starts.to(torch.int64).clamp(0, p_len)
    hi = torch.maximum(ends.to(torch.int64).clamp(0, p_len), lo)
    lens = hi - lo
    seg = torch.repeat_interleave(torch.arange(s, device=dev), lens)
    first = torch.cumsum(lens, 0) - lens
    pos = lo[seg] + (torch.arange(seg.shape[0], device=dev) - first[seg])
    out = torch.zeros((c, s), dtype=torch.float32, device=dev)
    return out.index_add_(1, seg, rows.index_select(1, pos))


def segment_rowsum(rows: torch.Tensor, starts: torch.Tensor,
                   ends: torch.Tensor) -> torch.Tensor:
    """out[:, i] = sum of rows[:, p] over p in [starts[i], ends[i]).

    rows (C, P) float32; starts, ends (S,) int32: contiguous, ascending,
    non-overlapping runs, empty ones (start == end) allowed anywhere; the
    bounds are clipped to [0, P]. Returns (C, S) float32."""
    if rows.dim() != 2 or rows.dtype != torch.float32:
        raise ValueError(f"rows must be (C, P) float32, got {rows.dtype} "
                         f"{tuple(rows.shape)}")
    c, p_len = rows.shape
    s = starts.shape[0]
    for name, t in (("starts", starts), ("ends", ends)):
        if t.dtype != torch.int32 or tuple(t.shape) != (s,):
            raise ValueError(f"{name} must be ({s},) int32, got {t.dtype} "
                             f"{tuple(t.shape)}")
    if _cuda.is_cpu(rows, starts, ends):
        return segment_rowsum_plain(rows, starts, ends)
    _cuda.check(rows, "rows", torch.float32)
    _cuda.check(starts, "starts", torch.int32)
    _cuda.check(ends, "ends", torch.int32)
    out = torch.empty((c, s), dtype=torch.float32, device=rows.device)
    if s == 0 or c == 0:
        return out
    SEG_KERNEL.launch("sg_segment_rowsum", _cuda.ptr(rows),
                      _cuda.ptr(starts), _cuda.ptr(ends), _cuda.ptr(out), c,
                      p_len, s, _cuda.stream(rows))
    return out
