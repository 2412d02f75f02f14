"""Inclusive scans — kernels A and H (counterpart of
street_gaussians_ns_tpu/ops/scan_pallas.py, `cumsum_flat`/`cummax_flat`
and `cumsum_rows`/`cummax_rows`).

Kernel A replaces `scan_pallas.py:_flat_scan_kernel`. The CUDA kernel is
`csrc/scan.cu`: one launch, a single-pass scan with decoupled look-back.
A block takes a tile of 4,096 elements by an atomic ticket, scans it in
registers, publishes the tile's total as one 64-bit {status, value}
descriptor and looks back over its predecessors' descriptors until it
meets a total that already includes everything before it; the output is
written once. On this card the scan is bound by its launch, not its bytes
(8-17 MB a call on the render path, a few microseconds of memory time), so
the design spends one launch and nothing else: the descriptors live in a
scratch kept per (device, stream) that the last block of a launch zeroes
again, so a call allocates and clears nothing. A scratch is never shared
between streams (two launches in flight would race on it); launches on one
stream run one after another. int32 add, int32 max and float32 max are
exact and the same from launch to launch; the float32 add combines its
predecessors' totals in one fixed order, so two launches are bit-equal
there too, at a cost in descriptor reads that grows with the square of
the tile count (no caller scans float32). The max mode (`cummax_flat`)
is the JAX package's owner scatter of its shared-bins binning, which no
route of the port calls. The plain versions are `torch.cumsum` /
`torch.cummax`; the wrapper runs them only for CPU tensors.

Kernel H, `cumsum_rows`/`cummax_rows`, scans a row-major (M, C) array
along axis 0 and replaces `scan_pallas.py:_scan_kernel`, whose one carry
row passes from grid step to grid step. The CUDA kernel
(`csrc/scan_rows.cu`) is kernel A's design for rows: one launch, tiles of
256 x (32 // C) rows taken by ticket and staged through shared memory,
each tile's C column totals published as one 8-byte {tag, state, value}
word a column and its prefix found by looking back; the output is
written once. Its scratch is kept per (device, stream) as A's is; the
descriptors carry the launch's tag, so only the two counter words are
reset (by the last block), and a call allocates and clears nothing. int32 results are exact (sums wrap);
the float32 sum folds the tile totals left to right from the nearest
published running total, so it is the same from launch to launch (its
association differs from a serial sum's). No render path of either
package calls the row scans.
"""
from __future__ import annotations

import ctypes

import torch

from . import _cuda

TILE = 256 * 16    # elements per block of csrc/scan.cu
_MIN_SCRATCH = 4096 + 1     # words of a stream's first scratch (16.8 M elements)

KERNEL = _cuda.register(_cuda.Kernel(
    name="flat_scan",
    source="scan.cu",
    replaces="street_gaussians_ns_tpu/ops/scan_pallas.py:34 _flat_scan_kernel",
    entries={"sg_flat_scan": (ctypes.c_void_p, ctypes.c_void_p,
                              ctypes.c_void_p, ctypes.c_longlong,
                              ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                              ctypes.c_void_p)},
))

_DTYPES = {torch.int32: 0, torch.float32: 1}
_OPS = {"add": 0, "max": 1}


def _scratch_len(n: int) -> int:
    """8-byte words of look-back scratch a scan of n elements needs: one
    word of counters and one descriptor per tile of csrc/scan.cu; none
    where a single block scans the whole array."""
    tiles = -(-n // TILE)
    return tiles + 1 if tiles > 1 else 0


# (device index, stream handle) -> the stream's zeroed scratch. A launch
# leaves it zeroed, so it is cleared once, when it is made.
_scratch: dict = {}


def _scratch_for(device: torch.device, stream: int, words: int,
                 table: dict | None = None) -> torch.Tensor:
    """The calling stream's scratch, grown to at least `words` 8-byte
    words, from `table` (kernel A's `_scratch` unless given). It is
    allocated (and zeroed) on the current stream, which is the stream it
    is keyed by."""
    table = _scratch if table is None else table
    key = (device.index, stream)
    buf = table.get(key)
    if buf is None or buf.numel() < words:
        size = max(_MIN_SCRATCH, 1 << (words - 1).bit_length())
        buf = torch.zeros(size, dtype=torch.int64, device=device)
        table[key] = buf
    return buf


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
    n = x.numel()
    if n == 0:
        return out
    stream = torch.cuda.current_stream(x.device).cuda_stream
    words = _scratch_len(n)
    scratch = _scratch_for(x.device, stream, words) if words else None
    KERNEL.launch("sg_flat_scan", x.data_ptr(), out.data_ptr(),
                  scratch.data_ptr() if words else None,
                  scratch.numel() if words else 0, n, _DTYPES[x.dtype],
                  _OPS[op], stream)
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
                              ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                              ctypes.c_int, ctypes.c_void_p)},
))

ROWS_MAX_C = 16
# csrc/scan_rows.cu: threads a block, elements a thread at most, counter
# words, descriptor words a tile.
_ROWS_THREADS, _ROWS_PER_THREAD, _ROWS_HEAD, _ROWS_SLOTS = 256, 32, 2, 16

# (device index, stream handle) -> the stream's row-scan scratch, kept as
# kernel A's is.
_rows_scratch: dict = {}


def rows_per_tile(c: int) -> int:
    return _ROWS_THREADS * (_ROWS_PER_THREAD // c)


def _rows_scratch_len(m: int, c: int) -> int:
    """8-byte words of look-back scratch an (m, c) scan needs: two counter
    words and 16 descriptor words a tile; none where one tile holds the
    array."""
    tiles = -(-m // rows_per_tile(c))
    return _ROWS_HEAD + _ROWS_SLOTS * tiles if tiles > 1 else 0


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
    stream = torch.cuda.current_stream(x.device).cuda_stream
    words = _rows_scratch_len(m, c)
    scratch = (_scratch_for(x.device, stream, words, _rows_scratch)
               if words else None)
    ROWS_KERNEL.launch("sg_scan_rows", _cuda.ptr(x), _cuda.ptr(out),
                       scratch.data_ptr() if words else None,
                       scratch.numel() if words else 0, m, c,
                       _DTYPES[x.dtype], _OPS[op], stream)
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
