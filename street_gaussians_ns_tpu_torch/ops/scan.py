"""Inclusive flat scans — kernel A (counterpart of
street_gaussians_ns_tpu/ops/scan_pallas.py, `cumsum_flat`/`cummax_flat`).

Replaces `scan_pallas.py:_flat_scan_kernel`. The CUDA kernel is
`csrc/scan.cu`: a three-phase tree scan (block scans with warp shuffles
writing block totals, a scan of the totals, then the offsets), since GPU
blocks cannot carry a total from one to the next as the TPU's sequential
grid does. It is bound by memory bandwidth (read M, write M, plus one more
pass over the output for the offsets). The plain versions are
`torch.cumsum` / `torch.cummax`; the wrapper runs them only for CPU
tensors.
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
