"""Fixed-capacity Gaussian parameter store (counterpart of
street_gaussians_ns_tpu/models/gaussians.py).

Parameters live in preallocated (CAP, ...) tensors with an `active` mask,
exactly the JAX package's layout, so its checkpoints load unchanged:
means raw, scales log (exp activation), quats raw wxyz, opacities logit
(sigmoid), features_dc (CAP, F, 3) Fourier SH-DC coefficients,
features_rest (CAP, K-1, 3) higher SH bands.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class GaussianParams:
    """Per-gaussian parameters (each (CAP, ...); objects add a leading
    object axis)."""

    means: torch.Tensor          # (CAP, 3)
    scales: torch.Tensor         # (CAP, 3) log-scale
    quats: torch.Tensor          # (CAP, 4) wxyz
    features_dc: torch.Tensor    # (CAP, F, 3)
    features_rest: torch.Tensor  # (CAP, K-1, 3)
    opacities: torch.Tensor      # (CAP, 1) logit

    @property
    def capacity(self) -> int:
        return self.means.shape[-2]


@dataclasses.dataclass(frozen=True)
class GaussianStore:
    """Params + activity mask + the densification statistics the JAX
    trainer keeps (carried so checkpoints round-trip; rendering ignores
    them)."""

    params: GaussianParams
    active: torch.Tensor         # (CAP,) bool
    xys_grad_norm: torch.Tensor  # (CAP,)
    vis_counts: torch.Tensor     # (CAP,)
    max_2dsize: torch.Tensor     # (CAP,)

    @property
    def capacity(self) -> int:
        return self.params.capacity


def activated_opacities(params: GaussianParams,
                        active: torch.Tensor) -> torch.Tensor:
    """(CAP,) sigmoid opacities, zero for inactive slots."""
    op = torch.sigmoid(params.opacities[..., 0])
    return torch.where(active, op, torch.zeros_like(op))


def activated_scales(params: GaussianParams) -> torch.Tensor:
    return torch.exp(params.scales)
