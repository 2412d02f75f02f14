"""Kernel J: the SH colour of every slot in one launch forward and one
backward (`csrc/sh_colors.cu`), behind models.splatfacto.sh_colors for
CUDA tensors. Its specification, and what CPU tensors run, is the plain
version models.splatfacto._sh_colors_plain.

`sh_colors_cuda` is an autograd Function: the forward launches once and,
where DC or rest is differentiated, keeps one byte a slot (which of the
three channels were >= 0 before the clamp); the backward launches once
and returns the gradients of DC (N, 3) and rest (N, K - 1, 3), none for
the centres or the camera (the view directions are detached, as in the
plain version)."""
from __future__ import annotations

import ctypes

import torch

from ..utils.profiling import span
from . import _cuda

SH_KERNEL = _cuda.register(_cuda.Kernel(
    name="sh_colors",
    source="sh_colors.cu",
    replaces="none: street_gaussians_ns_tpu/core/sh.py eval_sh is jnp "
             "code that XLA fuses",
    entries={
        "sg_sh_colors_fwd": (ctypes.c_void_p, ctypes.c_longlong,
                             ctypes.c_void_p, ctypes.c_longlong,
                             ctypes.c_void_p, ctypes.c_void_p,
                             ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                             ctypes.c_void_p, ctypes.c_void_p,
                             ctypes.c_longlong, ctypes.c_void_p),
        "sg_sh_colors_bwd": (ctypes.c_void_p, ctypes.c_longlong,
                             ctypes.c_void_p, ctypes.c_longlong,
                             ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                             ctypes.c_longlong, ctypes.c_longlong,
                             ctypes.c_void_p, ctypes.c_void_p,
                             ctypes.c_void_p, ctypes.c_longlong,
                             ctypes.c_void_p)},
))

_NULL = ctypes.c_void_p(None)


def sh_degree_of(k: int) -> int:
    """The largest degree D of K = (D + 1)^2 coefficients, D <= 4."""
    d = int(round(k ** 0.5)) - 1
    if (d + 1) ** 2 != k or not 0 <= d <= 4:
        raise ValueError(f"bad SH coefficient count {k}")
    return d


def _live(active_degree: int, k: int) -> int:
    """The bases of degree <= active_degree among K, as eval_sh masks."""
    return min((int(active_degree) + 1) ** 2, k)


def _check_center(center: torch.Tensor) -> None:
    if center.dtype != torch.float32:
        raise TypeError(f"center: expected torch.float32, got {center.dtype}")
    if tuple(center.shape) != (3,):
        raise ValueError(f"center: expected shape (3,), got "
                         f"{tuple(center.shape)}")


def sh_fwd(means, dc, rest, center, active_degree: int, keep_mask: bool):
    """One forward launch on the current stream: (rgb (N, 3), mask (N,)
    uint8 or None). means and dc (N, 3) float32 may be row-strided views
    (a unit column stride); rest (N, K - 1, 3) float32 contiguous; center
    (3,) float32, any stride (a column of c2w)."""
    n = means.shape[0]
    _cuda.check(means, "means", torch.float32, shape=(n, 3),
                strided_rows=True)
    _cuda.check(dc, "features_dc_t", torch.float32, shape=(n, 3),
                strided_rows=True)
    _cuda.check(rest, "features_rest", torch.float32, ndim=3)
    if rest.shape[0] != n or rest.shape[2] != 3:
        raise ValueError(f"features_rest: expected shape ({n}, K - 1, 3), "
                         f"got {tuple(rest.shape)}")
    _check_center(center)
    k = rest.shape[1] + 1
    degree = sh_degree_of(k)
    live = _live(active_degree, k)
    rgb = torch.empty((n, 3), dtype=torch.float32, device=means.device)
    mask = (torch.empty((n,), dtype=torch.uint8, device=means.device)
            if keep_mask else None)
    SH_KERNEL.launch("sg_sh_colors_fwd", _cuda.ptr(means), means.stride(0),
                     _cuda.ptr(dc), dc.stride(0), _cuda.ptr(rest),
                     _cuda.ptr(center), center.stride(0), degree, live,
                     _cuda.ptr(rgb),
                     _cuda.ptr(mask) if mask is not None else _NULL, n,
                     _cuda.stream(means))
    return rgb, mask


def sh_bwd(means, center, k: int, active_degree: int, mask, grad):
    """One backward launch on the current stream: (d_dc (N, 3), d_rest
    (N, K - 1, 3)) from the forward's mask and the gradient of rgb, (N, 3)
    float32 with any strides."""
    n = means.shape[0]
    _cuda.check(means, "means", torch.float32, shape=(n, 3),
                strided_rows=True)
    _check_center(center)
    _cuda.check(mask, "mask", torch.uint8, shape=(n,))
    if grad.dtype != torch.float32 or tuple(grad.shape) != (n, 3):
        raise ValueError(f"grad: expected float32 ({n}, 3), got "
                         f"{grad.dtype} {tuple(grad.shape)}")
    degree = sh_degree_of(k)
    live = _live(active_degree, k)
    d_dc = torch.empty((n, 3), dtype=torch.float32, device=means.device)
    d_rest = torch.empty((n, k - 1, 3), dtype=torch.float32,
                         device=means.device)
    SH_KERNEL.launch("sg_sh_colors_bwd", _cuda.ptr(means), means.stride(0),
                     _cuda.ptr(center), center.stride(0), degree, live,
                     _cuda.ptr(grad), grad.stride(0), grad.stride(1),
                     _cuda.ptr(mask), _cuda.ptr(d_dc), _cuda.ptr(d_rest), n,
                     _cuda.stream(means), modes=("bwd",))
    return d_dc, d_rest


class _ShColors(torch.autograd.Function):
    """Kernel J forward and backward as one autograd node: inputs DC and
    rest are differentiated; means and the camera centre come in
    detached."""

    @staticmethod
    def forward(ctx, dc, rest, means, center, active_degree, keep):
        rgb, mask = sh_fwd(means, dc, rest, center, active_degree, keep)
        if keep:
            ctx.save_for_backward(means, center, mask)
            ctx.k = rest.shape[1] + 1
            ctx.active_degree = active_degree
        return rgb

    @staticmethod
    def backward(ctx, g_rgb):
        means, center, mask = ctx.saved_tensors
        with span("scene.sh_bwd"):
            d_dc, d_rest = sh_bwd(means, center, ctx.k, ctx.active_degree,
                                  mask, g_rgb)
        return d_dc, d_rest, None, None, None, None


def sh_colors_cuda(means, features_dc_t, features_rest, center,
                   active_degree: int) -> torch.Tensor:
    """Per-slot RGB by kernel J: clamp(SH colour + 0.5, 0) of the
    direction from `center` ((3,), e.g. c2w[:3, 3]) to each centre, the
    bases above `active_degree` masked out. Differentiable in
    features_dc_t and features_rest."""
    keep = torch.is_grad_enabled() and (features_dc_t.requires_grad
                                        or features_rest.requires_grad)
    return _ShColors.apply(features_dc_t, features_rest, means.detach(),
                           center.detach(), int(active_degree), keep)
