"""Inputs of the SH colour (models/splatfacto.sh_colors) and its plain
formulation in k order, shared by the CPU tests and the card tests of
kernel J (ops/sh_colors.py). numpy and PyTorch only: the card machine has
no JAX.

`inputs` draws slots as the scene graph holds them: centres around a
camera, DC and rest coefficients at the spread training gives them; then,
cycling over the rows, the edges the kernel must get right: a pre-clamp
value of exactly 0 (its gradient passes), one below 0 (its gradient
stops), a NaN coefficient, a NaN centre, a centre on the camera (the
1e-12 clamp) and one far off."""
import numpy as np
import torch

from street_gaussians_ns_tpu_torch.core.sh import SH_C0, sh_basis

EDGE_KINDS = 8


def _dc_at_minus_half() -> np.float32:
    """A float32 DC whose product with float32(SH_C0) rounds to -0.5, so a
    slot with zero rest coefficients has a pre-clamp value of exactly 0."""
    c0 = np.float32(SH_C0)
    d = np.float32(-0.5) / c0
    for _ in range(64):
        p = c0 * d
        if p == np.float32(-0.5):
            return d
        d = np.nextafter(d, np.float32(np.inf if p < -0.5 else -np.inf),
                         dtype=np.float32)
    raise AssertionError("no float32 DC gives -0.5")


def inputs(rng, n: int, degree: int = 3, edges: bool = True):
    """means (n, 3), dc (n, 3), rest (n, (degree + 1)^2 - 1, 3) float32 and
    c2w (3, 4) float32."""
    k = (degree + 1) ** 2
    c2w = np.concatenate([np.eye(3), rng.uniform(-2.0, 2.0, (3, 1))], 1)
    means = (rng.standard_normal((n, 3)) * 20.0 + c2w[:, 3]).astype(
        np.float32)
    dc = (rng.standard_normal((n, 3)) * 0.8).astype(np.float32)
    rest = (rng.standard_normal((n, k - 1, 3)) * 0.2).astype(np.float32)
    if edges:
        for i in range(min(n, 4 * EDGE_KINDS)):
            kind = i % EDGE_KINDS
            if kind == 0:                    # v exactly 0: rgb 0, grad on
                dc[i] = _dc_at_minus_half()
                rest[i] = 0.0
            elif kind == 1:                  # v below 0: rgb 0, grad off
                dc[i] = -4.0
                rest[i] = 0.0
            elif kind == 2 and k > 1:        # NaN on the last basis
                rest[i, -1, i % 3] = np.nan
            elif kind == 3:                  # NaN DC
                dc[i, (i + 1) % 3] = np.nan
            elif kind == 4:                  # NaN centre
                means[i, i % 3] = np.nan
            elif kind == 5:                  # on the camera: 0 / 1e-12
                means[i] = c2w[:, 3]
            elif kind == 6:                  # far: squares overflow
                means[i] = (2e19, -3e19, 1e19)
            # kind 7: a drawn slot
    return means, dc, rest, c2w.astype(np.float32)


def k_order(means, dc, rest, center, active_degree: int,
            clamp: bool = True):
    """clamp(SH colour + 0.5, 0) as kernel J adds it: the masked basis of
    core.sh.sh_basis, then basis 0 x DC plus basis k x rest[k - 1] in k
    order, each product and sum rounded on its own. clamp=False: the
    value before the clamp."""
    k = rest.shape[1] + 1
    d = int(round(k ** 0.5)) - 1
    v = means.detach() - center.detach()
    v = v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True),
                        min=1e-12)
    live = torch.arange(k, device=v.device) < (int(active_degree) + 1) ** 2
    b = sh_basis(v, d) * live.to(v.dtype)
    acc = b[:, 0:1] * dc
    for i in range(1, k):
        acc = acc + b[:, i:i + 1] * rest[:, i - 1]
    return torch.clamp(acc + 0.5, min=0.0) if clamp else acc + 0.5
