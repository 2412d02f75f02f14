"""Geometric eval: LiDAR-vs-Gaussian chamfer distance (counterpart of
street_gaussians_ns_tpu/ops/chamfer.py).

The aggregated LiDAR cloud goes into model space (the GL<->CV swap and the
dataparser transform / scale, geometric_metric.py:90-92), and the chamfer
distance between it and the Gaussian means is reported in units of 1e-4
(CD_UNIT, :5). Nearest neighbours come from a chunked (N, M) distance
sweep in plain PyTorch on the points' device, memory-bounded by the chunk.
"""
from __future__ import annotations

import numpy as np
import torch

CD_UNIT = 1e-4


def _min_sqdist(a: torch.Tensor, b: torch.Tensor,
                chunk: int = 4096) -> torch.Tensor:
    """min_j ||a_i - b_j||^2 for each i; a (N, 3), b (M, 3).

    The |a|^2 - 2ab + |b|^2 sweep only selects the nearest neighbour (so
    its float32 cancellation does not matter); the distance returned is
    recomputed exactly against the neighbour selected."""
    b_sq = torch.sum(b * b, dim=1)
    out = []
    for a_chunk in torch.split(a, chunk):
        d = (torch.sum(a_chunk * a_chunk, 1)[:, None]
             - 2.0 * a_chunk @ b.T + b_sq[None, :])
        j = torch.argmin(d, dim=1)
        out.append(torch.sum((a_chunk - b[j]) ** 2, dim=1))
    return torch.cat(out) if out else a.new_zeros((0,))


def _mean_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.clamp(_min_sqdist(a, b), min=0.0)).mean()


def chamfer_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Symmetric chamfer (mean of the two directions' mean distances), in
    CD_UNIT (calc_chamfer_distance, geometric_metric.py:59-69)."""
    return (_mean_dist(a, b) + _mean_dist(b, a)) * 0.5 / CD_UNIT


def chamfer_directed(a: torch.Tensor, b: torch.Tensor):
    """One-directional means (d_ab, d_ba) in CD_UNIT (the reference reports
    both and their average, geometric_metric.py:59-70, :100)."""
    return _mean_dist(a, b) / CD_UNIT, _mean_dist(b, a) / CD_UNIT


def gl2cv_points(pts: np.ndarray) -> np.ndarray:
    """(x,y,z) OpenGL -> OpenCV world swap (geometric_metric.py:8-16)."""
    out = pts[:, [1, 0, 2]].copy()
    out[:, 2] *= -1
    return out


def evaluate_lidar_geometric(
    means: np.ndarray,              # (N, 3) active gaussian means
    lidar_points: np.ndarray,       # (M, 3) aggregated lidar, raw clip frame
    transform_matrix: np.ndarray,   # (3, 4) dataparser transform
    scale: float,
    applied_translation: np.ndarray | None = None,  # colmap-frame shift
    max_points: int = 200_000,
    device="cuda",
) -> dict:
    """Chamfer between the model's means and the clip's LiDAR in model
    space (evaluate_lidar_geometric, :72-100): the LiDAR gets the gl2cv'd
    -0.98*T0 COLMAP shift (:83-87), then the dataparser transform + scale
    (:88-92). Both clouds are subsampled to max_points with
    RandomState(0), as the JAX package does. Returns the reference's keys
    (lidar_chamfer_distance_{1,2,avg}, :100) in CD_UNIT."""
    rng = np.random.RandomState(0)
    if len(lidar_points) > max_points:
        lidar_points = lidar_points[rng.choice(len(lidar_points), max_points,
                                               replace=False)]
    if len(means) > max_points:
        means = means[rng.choice(len(means), max_points, replace=False)]
    pts = np.asarray(lidar_points, np.float64)
    if applied_translation is not None:
        pts = pts + np.asarray(applied_translation)[None, :]
    t44 = np.concatenate([transform_matrix, [[0, 0, 0, 1]]], axis=0)
    pts = np.concatenate([pts, np.ones((len(pts), 1))], 1)
    pts = (pts @ t44.T)[:, :3] * scale

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    d1, d2 = (float(d) for d in chamfer_directed(f32(means), f32(pts)))
    return {"lidar_chamfer_distance_1": d1,
            "lidar_chamfer_distance_2": d2,
            "lidar_chamfer_distance_avg": 0.5 * (d1 + d2)}
