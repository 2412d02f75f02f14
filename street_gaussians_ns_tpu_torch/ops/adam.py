"""Kernel K: one Adam step of every leaf of every optimizer group in one
launch (`csrc/adam.cu`), behind engine.optimizers.adam_step for CUDA
tensors. Its specification, and what CPU tensors run, is the plain version
engine.optimizers._adam_plain after the row mask
(engine.optimizers.mask_rows).

`adam_leaves` takes up to 32 leaves, each (p, g, m, v, active, hyper):
float32 contiguous tensors of one shape, an optional bool row mask whose
shape leads theirs, and the eight float32 numbers of its group (`hyper`).
It allocates p', m', v' with torch.empty_like, launches once on the
current stream and returns them; its arguments are not written."""
from __future__ import annotations

import ctypes

import torch

from . import _cuda

MAX_LEAVES = 32

ADAM_KERNEL = _cuda.register(_cuda.Kernel(
    name="adam",
    source="adam.cu",
    replaces="none: street_gaussians_ns_tpu/engine/optimizers.py:72 "
             "adam_update is jnp code that XLA fuses",
    entries={"sg_adam": (ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                         ctypes.c_void_p, ctypes.c_void_p,
                         ctypes.c_void_p)},
))


def _check_leaf(i: int, p, g, m, v, active) -> None:
    shape = p.shape
    for name, t in (("p", p), ("g", g), ("m", m), ("v", v)):
        if (t.dtype != torch.float32 or t.shape != shape
                or not t.is_contiguous()):
            _cuda.check(t, f"leaf {i} {name}", torch.float32,
                        shape=tuple(shape))
    if p.numel() >= 2 ** 31:
        raise ValueError(f"leaf {i}: {p.numel()} elements, the kernel "
                         f"takes fewer than 2^31")
    if active is not None:
        _cuda.check(active, f"leaf {i} active", torch.bool,
                    shape=tuple(shape[:active.dim()]))


def adam_leaves(leaves):
    """Kernel K over `leaves` (see the module docstring): hyper = (lr, b1,
    1 - b1, b2, 1 - b2, eps, 1 / c1, 1 / c2) as float32 numbers. Returns
    [(p', m', v')], one launch (none when every leaf is empty)."""
    leaves = list(leaves)
    if not 1 <= len(leaves) <= MAX_LEAVES:
        raise ValueError(f"kernel K takes 1 to {MAX_LEAVES} leaves, got "
                         f"{len(leaves)}")
    for i, (p, g, m, v, active, h) in enumerate(leaves):
        _check_leaf(i, p, g, m, v, active)
        if len(h) != 8:
            raise ValueError(f"leaf {i}: 8 numbers a group, got {len(h)}")
    if _cuda.is_cpu(*[t for lf in leaves for t in lf[:5] if t is not None]):
        raise ValueError("kernel K takes CUDA tensors; the CPU runs "
                         "engine.optimizers._adam_plain")
    ptrs, numel, row, hyper, out = [], [], [], [], []
    for p, g, m, v, active, h in leaves:
        new = tuple(torch.empty_like(p) for _ in range(3))
        out.append(new)
        ptrs += [t.data_ptr() for t in (p, g, m, v) + new]
        ptrs.append(active.data_ptr() if active is not None else None)
        numel.append(p.numel())
        row.append(p.numel() // active.numel()
                   if active is not None and active.numel() else 1)
        hyper += [float(x) for x in h]
    if sum(numel):
        n = len(leaves)
        ADAM_KERNEL.launch(
            "sg_adam", n, (ctypes.c_void_p * (8 * n))(*ptrs),
            (ctypes.c_longlong * n)(*numel), (ctypes.c_int * n)(*row),
            (ctypes.c_float * (8 * n))(*hyper),
            _cuda.stream(leaves[0][0]))
    return out
