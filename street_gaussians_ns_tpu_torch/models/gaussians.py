"""Fixed-capacity Gaussian parameter store (counterpart of
street_gaussians_ns_tpu/models/gaussians.py).

Parameters live in preallocated (CAP, ...) tensors with an `active` mask,
exactly the JAX package's layout, so its checkpoints load unchanged:
means raw, scales log (exp activation), quats raw wxyz, opacities logit
(sigmoid), features_dc (CAP, F, 3) Fourier SH-DC coefficients,
features_rest (CAP, K-1, 3) higher SH bands. A temporal store (the
Periodic Vibration Gaussian model, models.pvg) adds three leaves: tau
(CAP, 1) each gaussian's life peak, s_beta (CAP, 1) its log lifespan and
velocity (CAP, 3) its vibration direction; every other store leaves them
None, so its leaves, checkpoints and the JAX package's stores are as
they were. `init_gaussians` builds a store from seed points or a random
cloud.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from ..core import quaternions as quat
from ..core.sh import num_sh_bases, rgb2sh


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
    # The temporal leaves (models.pvg); None outside a temporal store.
    tau: Optional[torch.Tensor] = None        # (CAP, 1) life peak
    s_beta: Optional[torch.Tensor] = None     # (CAP, 1) log lifespan
    velocity: Optional[torch.Tensor] = None   # (CAP, 3)

    @property
    def capacity(self) -> int:
        return self.means.shape[-2]

    @property
    def temporal(self) -> bool:
        return self.tau is not None

    def as_dict(self):
        """The leaves, in field order; a temporal store's three more last,
        the others' left out."""
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)
                if getattr(self, f.name) is not None}


@dataclasses.dataclass(frozen=True)
class GaussianStore:
    """Params + activity mask + the densification statistics
    (models.refinement keeps them; rendering ignores them)."""

    params: GaussianParams
    active: torch.Tensor         # (CAP,) bool
    xys_grad_norm: torch.Tensor  # (CAP,)
    vis_counts: torch.Tensor     # (CAP,)
    max_2dsize: torch.Tensor     # (CAP,)

    @property
    def capacity(self) -> int:
        return self.params.capacity

    @property
    def num_active(self) -> torch.Tensor:
        return self.active.sum()


def zeros_stats(cap: int, device="cuda"):
    """The three densification statistics of an empty store: accumulated
    screen-space gradient norm, visibility count, largest screen size."""
    return tuple(torch.zeros((cap,), dtype=torch.float32, device=device)
                 for _ in range(3))


def knn_avg_dist(points: np.ndarray, k: int = 3) -> np.ndarray:
    """Mean distance to the k nearest neighbours (self excluded): the
    scale initialisation. Host-side numpy; initialisation is offline."""
    from scipy.spatial import cKDTree

    d, _ = cKDTree(points).query(points, k=k + 1)
    return d[:, 1:].mean(axis=1).astype(np.float32)


def draw_init_noise(n: int, generator: torch.Generator,
                    device="cuda", temporal: bool = False) -> dict:
    """The uniform draws of one `init_gaussians` call for n gaussians:
    {"means": (n, 3), "quats": (3, n), "dc": (n, 3)} in [0, 1), and for
    a temporal store "tau": (n,) after them."""
    def u(*shape):
        return torch.rand(shape, dtype=torch.float32, device=device,
                          generator=generator)

    out = {"means": u(n, 3), "quats": u(3, n), "dc": u(n, 3)}
    if temporal:
        out["tau"] = u(n)
    return out


def init_gaussians(capacity: int, seed_points, seed_colors, *,
                   sh_degree: int = 3, fourier_dim: int = 1,
                   num_random: int = 50000, random_scale: float = 10.0,
                   noise: dict | None = None, seed: int = 0,
                   temporal: tuple | None = None,
                   device="cuda") -> GaussianStore:
    """A store from SfM/LiDAR seeds ((N, 3) points, (N, 3) colours in
    [0, 255]) or, with seed_points None, from a random cloud, zero-padded
    to `capacity`: log scales from the 3-nearest-neighbour distance,
    random quaternions, logit(0.1) opacities, the seed colours as SH DC in
    Fourier row 0 (a random cloud takes raw uniform DC). `noise`: see
    draw_init_noise (for min(N or num_random, capacity) gaussians); drawn
    from a generator seeded with `seed` when None.

    `temporal` = (t0, t1, lifespan) makes a temporal store (models.pvg):
    life peaks uniform over [t0, t1] (noise["tau"]), every lifespan
    `lifespan` (s_beta = log lifespan), zero velocities."""
    if seed_points is not None:
        pts = np.asarray(seed_points, np.float32)
        if pts.shape[0] > capacity:
            keep = np.random.RandomState(0).choice(pts.shape[0], capacity,
                                                   replace=False)
            pts = pts[keep]
            if seed_colors is not None:
                seed_colors = np.asarray(seed_colors)[keep]
        n = pts.shape[0]
    else:
        n = min(num_random, capacity)
    if noise is None:
        noise = draw_init_noise(
            n, torch.Generator(device=device).manual_seed(seed), device,
            temporal=temporal is not None)
    f32 = dict(dtype=torch.float32, device=device)

    dc_rows = None
    if seed_points is None:
        pts = ((noise["means"].cpu().numpy() - np.float32(0.5))
               * np.float32(random_scale))
        dc_rows = noise["dc"]
    elif seed_colors is not None:
        dc_rows = rgb2sh(torch.as_tensor(
            np.asarray(seed_colors, np.float32) / 255.0, **f32))
    avg = knn_avg_dist(pts) if n > 1 else np.ones((n,), np.float32)
    log_scales = np.log(np.maximum(avg, 1e-7)).astype(np.float32)

    means = torch.zeros((capacity, 3), **f32)
    means[:n] = torch.as_tensor(pts, **f32)
    scales = torch.zeros((capacity, 3), **f32)
    scales[:n] = torch.as_tensor(log_scales, **f32)[:, None]
    features_dc = torch.zeros((capacity, fourier_dim, 3), **f32)
    if dc_rows is not None:
        features_dc[:n, 0, :] = dc_rows.to(**f32)
    quats = torch.zeros((capacity, 4), **f32)
    quats[:, 0] = 1.0
    quats[:n] = quat.shoemake_quats(noise["quats"].to(**f32))
    active = torch.zeros((capacity,), dtype=torch.bool, device=device)
    active[:n] = True
    time_leaves = {}
    if temporal is not None:
        t0, t1, lifespan = (float(x) for x in temporal)
        tau = torch.zeros((capacity, 1), **f32)
        tau[:n, 0] = t0 + (t1 - t0) * noise["tau"].to(**f32)
        time_leaves = dict(
            tau=tau, velocity=torch.zeros((capacity, 3), **f32),
            s_beta=torch.full((capacity, 1), math.log(lifespan), **f32))
    params = GaussianParams(
        means=means, scales=scales, quats=quats, features_dc=features_dc,
        features_rest=torch.zeros(
            (capacity, num_sh_bases(sh_degree) - 1, 3), **f32),
        opacities=torch.full((capacity, 1), math.log(0.1 / 0.9), **f32),
        **time_leaves)
    g, v, m = zeros_stats(capacity, device)
    return GaussianStore(params=params, active=active, xys_grad_norm=g,
                         vis_counts=v, max_2dsize=m)


def activated_opacities(params: GaussianParams,
                        active: torch.Tensor) -> torch.Tensor:
    """(CAP,) sigmoid opacities, zero for inactive slots."""
    op = torch.sigmoid(params.opacities[..., 0])
    return torch.where(active, op, torch.zeros_like(op))


def activated_scales(params: GaussianParams) -> torch.Tensor:
    return torch.exp(params.scales)
