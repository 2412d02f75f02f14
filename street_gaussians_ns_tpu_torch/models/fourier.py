"""Time-Fourier diffuse colour features (counterpart of
street_gaussians_ns_tpu/models/fourier.py)."""
from __future__ import annotations

import math

import torch


def idft_basis(t: torch.Tensor, dim: int) -> torch.Tensor:
    """IDFT row (..., dim) at time t (...,): even k -> cos(t k 2pi/dim),
    odd k -> sin(t (k+1) 2pi/dim)."""
    t = torch.as_tensor(t, dtype=torch.float32)[..., None]
    k = torch.arange(dim, dtype=torch.float32, device=t.device)
    is_even = (torch.arange(dim, device=t.device) % 2) == 0
    ang_even = t * k * (2.0 * math.pi / dim)
    ang_odd = t * (k + 1.0) * (2.0 * math.pi / dim)
    return torch.where(is_even, torch.cos(ang_even), torch.sin(ang_odd))


def fourier_dc(features_dc: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Collapse Fourier coefficients (..., N, F, 3) at time t (...,) to SH
    DC (..., N, 3); leading object axes of features_dc match t's shape."""
    basis = idft_basis(t, features_dc.shape[-2])          # (..., F)
    return torch.einsum("...nfc,...f->...nc", features_dc, basis)
