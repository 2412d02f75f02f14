"""Ragged expansion — kernel B (counterpart of
street_gaussians_ns_tpu/ops/expand_pallas.py, `expand_ragged`).

Replaces `expand_pallas.py:_expand_kernel`, a one-hot MXU matmul over a
window of runs with a bf16x3 split to stay exact. The CUDA kernel
(`csrc/expand.cu`) is a gather: one thread per output slot finds its run
by binary search of `ends` and copies the C rows, coalesced along the
slot axis. It is bound by memory bandwidth. A copy is exact, so every
slot a run covers is correct (the TPU kernel may zero slots past its
window margin; its contract allows "zero or correct").
"""
from __future__ import annotations

import ctypes

import torch

from . import _cuda

KERNEL = _cuda.register(_cuda.Kernel(
    name="expand_ragged",
    source="expand.cu",
    replaces="street_gaussians_ns_tpu/ops/expand_pallas.py:60 _expand_kernel",
    entries={"sg_expand_ragged": (ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.c_int, ctypes.c_longlong,
                                  ctypes.c_longlong, ctypes.c_void_p)},
))


def expand_ragged_plain(src: torch.Tensor, starts: torch.Tensor,
                        ends: torch.Tensor, out_len: int) -> torch.Tensor:
    s = src.shape[1]
    slot = torch.arange(out_len, dtype=torch.int32, device=src.device)
    owner = torch.clamp(torch.searchsorted(ends, slot, right=True), 0, s - 1)
    hit = (starts[owner] <= slot) & (slot < ends[owner])
    return torch.where(hit[None, :], src[:, owner],
                       torch.zeros((), dtype=src.dtype, device=src.device))


def expand_ragged(src: torch.Tensor, starts: torch.Tensor, ends: torch.Tensor,
                  out_len: int, n_exact: int | None = None) -> torch.Tensor:
    """Ragged repeat: out[:, s] = src[:, i] for the unique i with
    starts[i] <= s < ends[i]; uncovered slots are 0.

    src (C, S) float32; starts/ends (S,) int32, the exclusive/inclusive
    cumsum of per-run counts (ends non-decreasing). Returns (C, out_len).
    `n_exact` is accepted for signature parity with the JAX package and
    ignored: a copy is exact for every row."""
    del n_exact
    if src.dim() != 2 or src.dtype != torch.float32:
        raise ValueError(f"src must be (C, S) float32, got {src.dtype} "
                         f"{tuple(src.shape)}")
    c, s = src.shape
    for name, t in (("starts", starts), ("ends", ends)):
        if t.dtype != torch.int32 or tuple(t.shape) != (s,):
            raise ValueError(f"{name} must be ({s},) int32, got {t.dtype} "
                             f"{tuple(t.shape)}")
    if s == 0:
        raise ValueError("expand_ragged needs at least one run")
    if _cuda.is_cpu(src, starts, ends):
        return expand_ragged_plain(src, starts, ends, out_len)
    for name, t in (("src", src), ("starts", starts), ("ends", ends)):
        _cuda.check(t, name, t.dtype)
    out = torch.empty((c, out_len), dtype=torch.float32, device=src.device)
    if out_len == 0 or c == 0:
        return out
    KERNEL.launch("sg_expand_ragged", _cuda.ptr(src), _cuda.ptr(starts),
                  _cuda.ptr(ends), _cuda.ptr(out), c, s, out_len,
                  _cuda.stream(src))
    return out
