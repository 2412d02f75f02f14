"""Rank-keyed row sum — kernel F (counterpart of
street_gaussians_ns_tpu/ops/segreduce_pallas.py, `rank_rowsum`).

The fused rasterizer's backward emits one gradient row per (gaussian,
tile) pair; `rank_rowsum` sums them per gaussian, keyed by the depth rank
that rides the feature stream. It replaces
`segreduce_pallas.py:_ranksum_kernel`, a rank-equality one-hot matmul on
the MXU. The CUDA kernel (`csrc/ranksum.cu`) uses that the ranks are
sorted: one thread per output rank finds its contiguous run by binary
search and sums it in pair order, a warp sharing the long runs. It is
bound by memory bandwidth (the rows once, the sums once) and uses no
atomics, so its sums do not change from run to run.
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
