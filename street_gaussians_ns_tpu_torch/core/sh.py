"""Real spherical harmonics evaluation (degree <= 4) in PyTorch
(counterpart of street_gaussians_ns_tpu/core/sh.py).

Coefficients are laid out (N, num_sh_bases(max_degree), 3); only bases up
to the active degree contribute; the caller adds +0.5 and clamps.
"""
from __future__ import annotations

import torch

SH_C0 = 0.28209479177387814


def rgb2sh(rgb: torch.Tensor) -> torch.Tensor:
    return (rgb - 0.5) / SH_C0


def num_sh_bases(degree: int) -> int:
    """(degree + 1)^2, e.g. 16 for degree 3."""
    return (degree + 1) ** 2


_C1 = 0.4886025119029199
_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
       -1.0925484305920792, 0.5462742152960396)
_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
       0.3731763325901154, -0.4570457994644658, 1.445305721320277,
       -0.5900435899266435)
_C4 = (2.5033429417967046, -1.7701307697799304, 0.9461746957575601,
       -0.6690465435572892, 0.10578554691520431, -0.6690465435572892,
       0.47308734787878004, -1.7701307697799304, 0.6258357354491761)


def sh_basis(dirs: torch.Tensor, max_degree: int) -> torch.Tensor:
    """Real SH basis (..., K), K = (max_degree + 1)^2, of unit dirs (..., 3)."""
    if not 0 <= max_degree <= 4:
        raise ValueError(f"SH degree must be in [0, 4], got {max_degree}")
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    out = [SH_C0 * torch.ones_like(x)]
    if max_degree >= 1:
        out += [-_C1 * y, _C1 * z, -_C1 * x]
    if max_degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        out += [
            _C2[0] * xy,
            _C2[1] * yz,
            _C2[2] * (2.0 * zz - xx - yy),
            _C2[3] * xz,
            _C2[4] * (xx - yy),
        ]
    if max_degree >= 3:
        out += [
            _C3[0] * y * (3.0 * xx - yy),
            _C3[1] * xy * z,
            _C3[2] * y * (4.0 * zz - xx - yy),
            _C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
            _C3[4] * x * (4.0 * zz - xx - yy),
            _C3[5] * z * (xx - yy),
            _C3[6] * x * (xx - 3.0 * yy),
        ]
    if max_degree >= 4:
        out += [
            _C4[0] * xy * (xx - yy),
            _C4[1] * yz * (3.0 * xx - yy),
            _C4[2] * xy * (7.0 * zz - 1.0),
            _C4[3] * yz * (7.0 * zz - 3.0),
            _C4[4] * (zz * (35.0 * zz - 30.0) + 3.0),
            _C4[5] * xz * (7.0 * zz - 3.0),
            _C4[6] * (xx - yy) * (7.0 * zz - 1.0),
            _C4[7] * xz * (xx - 3.0 * yy),
            _C4[8] * (xx * (xx - 3.0 * yy) - yy * (3.0 * xx - yy)),
        ]
    return torch.stack(out, dim=-1)


def eval_sh(active_degree: int, dirs: torch.Tensor,
            coeffs: torch.Tensor) -> torch.Tensor:
    """SH colour sum_k coeffs[:, k, :] * basis_k(dir) over the bases of
    degree <= active_degree. dirs (N, 3) unit, coeffs (N, K, 3) -> (N, 3)
    raw colour (the caller applies +0.5 and the clamp)."""
    k = coeffs.shape[-2]
    max_degree = int(round(k ** 0.5)) - 1
    if num_sh_bases(max_degree) != k:
        raise ValueError(f"bad SH coefficient count {k}")
    basis = sh_basis(dirs, max_degree)
    # The bases of degree <= d are the first (d + 1)^2.
    live = torch.arange(k, device=dirs.device) < (int(active_degree) + 1) ** 2
    basis = basis * live.to(basis.dtype)
    return torch.einsum("nk,nkc->nc", basis, coeffs)
