"""Inclusive scans — kernels A and H (counterpart of
street_gaussians_ns_tpu/ops/scan_pallas.py, `cumsum_flat`/`cummax_flat`
and `cumsum_rows`/`cummax_rows`).

Replaces `scan_pallas.py:_flat_scan_kernel`. The CUDA kernel is
`csrc/scan.cu`: a three-phase tree scan (block scans with warp shuffles
writing block totals, a scan of the totals, then the offsets), since GPU
blocks cannot carry a total from one to the next as the TPU's sequential
grid does. It is bound by memory bandwidth (read M, write M, plus one more
pass over the output for the offsets). The plain versions are
`torch.cumsum` / `torch.cummax`; the wrapper runs them only for CPU
tensors.

Kernel H, `cumsum_rows`/`cummax_rows`, scans a row-major (M, C) array
along axis 0 and replaces `scan_pallas.py:_scan_kernel`, whose one carry
row passes from grid step to grid step. The CUDA kernel
(`csrc/scan_rows.cu`) is the same three-phase tree over slabs of rows
staged through shared memory; int32 results are exact (sums wrap), the
float32 sum's association differs from a serial sum's. No render path of
either package calls the row scans.
"""
from __future__ import annotations

import ctypes

import torch

from . import _cuda

TILE = 512 * 8     # elements per block of csrc/scan.cu

KERNEL = _cuda.register(_cuda.Kernel(
    name="flat_scan",
    source="scan.cu",
    replaces="street_gaussians_ns_tpu/ops/scan_pallas.py:34 _flat_scan_kernel",
    entries={"sg_flat_scan": (ctypes.c_void_p, ctypes.c_void_p,
                              ctypes.c_void_p, ctypes.c_longlong,
                              ctypes.c_int, ctypes.c_int, ctypes.c_void_p)},
))

_DTYPES = {torch.int32: 0, torch.float32: 1}
_OPS = {"add": 0, "max": 1}


def _scratch_len(n: int) -> int:
    """Block totals of every recursion level of csrc/scan.cu:scan_rec."""
    total = 0
    while n > TILE:
        n = -(-n // TILE)
        total += n
    return max(total, 1)


def _check(x: torch.Tensor) -> None:
    if x.dim() != 1:
        raise ValueError(f"flat scan takes a 1-D tensor, got {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"flat scan takes int32 or float32, got {x.dtype}")


def cumsum_flat_plain(x: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(x, dim=0, dtype=x.dtype)


def cummax_flat_plain(x: torch.Tensor) -> torch.Tensor:
    return torch.cummax(x, dim=0).values


def _scan(x: torch.Tensor, op: str) -> torch.Tensor:
    _cuda.check(x, "x", x.dtype, ndim=1)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    scratch = torch.empty(_scratch_len(x.numel()), dtype=x.dtype,
                          device=x.device)
    KERNEL.launch("sg_flat_scan", _cuda.ptr(x), _cuda.ptr(out),
                  _cuda.ptr(scratch), x.numel(), _DTYPES[x.dtype], _OPS[op],
                  _cuda.stream(x))
    return out


def cumsum_flat(x: torch.Tensor) -> torch.Tensor:
    """Inclusive cumulative sum of a flat (M,) int32/float32 tensor."""
    _check(x)
    if _cuda.is_cpu(x):
        return cumsum_flat_plain(x)
    return _scan(x, "add")


def cummax_flat(x: torch.Tensor) -> torch.Tensor:
    """Inclusive cumulative max of a flat (M,) int32/float32 tensor."""
    _check(x)
    if _cuda.is_cpu(x):
        return cummax_flat_plain(x)
    return _scan(x, "max")


# ---------------------------------------------------------------------------
# Kernel H: scans along axis 0 of (M, C).
# ---------------------------------------------------------------------------

ROWS_KERNEL = _cuda.register(_cuda.Kernel(
    name="scan_rows",
    source="scan_rows.cu",
    replaces="street_gaussians_ns_tpu/ops/scan_pallas.py:126 _scan_kernel",
    entries={"sg_scan_rows": (ctypes.c_void_p, ctypes.c_void_p,
                              ctypes.c_void_p, ctypes.c_longlong,
                              ctypes.c_int, ctypes.c_int, ctypes.c_int,
                              ctypes.c_void_p)},
))

ROWS_MAX_C = 16
_ROWS_THREADS, _ROWS_PER_THREAD = 256, 32   # csrc/scan_rows.cu


def _rows_scratch_len(m: int, c: int) -> int:
    """Column totals of every recursion level of
    csrc/scan_rows.cu:scan_rows_rec."""
    rows_per_block = _ROWS_THREADS * (_ROWS_PER_THREAD // c)
    total = 0
    while m > rows_per_block:
        m = -(-m // rows_per_block)
        total += m * c
    return max(total, 1)


def _check_rows(x: torch.Tensor) -> None:
    if x.dim() != 2 or not 1 <= x.shape[1] <= ROWS_MAX_C:
        raise ValueError(f"row scan takes (M, 1..{ROWS_MAX_C}), got "
                         f"{tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"row scan takes int32 or float32, got {x.dtype}")


def cumsum_rows_plain(x: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(x, dim=0, dtype=x.dtype)


def cummax_rows_plain(x: torch.Tensor) -> torch.Tensor:
    return torch.cummax(x, dim=0).values


def _scan_rows(x: torch.Tensor, op: str) -> torch.Tensor:
    _cuda.check(x, "x", x.dtype, ndim=2)
    out = torch.empty_like(x)
    m, c = x.shape
    if m == 0:
        return out
    scratch = torch.empty(_rows_scratch_len(m, c), dtype=x.dtype,
                          device=x.device)
    ROWS_KERNEL.launch("sg_scan_rows", _cuda.ptr(x), _cuda.ptr(out),
                       _cuda.ptr(scratch), m, c, _DTYPES[x.dtype], _OPS[op],
                       _cuda.stream(x))
    return out


def cumsum_rows(x: torch.Tensor) -> torch.Tensor:
    """Inclusive cumulative sum along axis 0 of an (M, C <= 16)
    int32/float32 tensor."""
    _check_rows(x)
    if _cuda.is_cpu(x):
        return cumsum_rows_plain(x)
    return _scan_rows(x, "add")


def cummax_rows(x: torch.Tensor) -> torch.Tensor:
    """Inclusive cumulative max along axis 0 of an (M, C <= 16)
    int32/float32 tensor."""
    _check_rows(x)
    if _cuda.is_cpu(x):
        return cummax_rows_plain(x)
    return _scan_rows(x, "max")
