"""Camera pose optimizer (counterpart of
street_gaussians_ns_tpu/models/camera_opt.py): learnable per-camera
SO(3)xR3 or SE(3) deltas applied to c2w, through the standard Lie-group
exponential maps. The reference ships it in mode "off"; when it is on, one
(6,) tangent per train camera is trained with gradient accumulation over
100 steps (engine.optimizers.DEFAULT_GROUPS["camera_opt"]).

The exp maps also serve the bbox optimizer's "SO3xR3" / "SE3" modes
(models.scene_graph.interpolate_boxes).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class CameraOptConfig:
    mode: str = "off"          # "off" | "SO3xR3" | "SE3"
    num_cameras: int = 0


def init_camera_opt(config: CameraOptConfig,
                    device="cuda") -> Optional[torch.Tensor]:
    """Zero tangents (num_cameras, 6) float32, or None when the optimizer
    is off."""
    if config.mode == "off" or config.num_cameras == 0:
        return None
    return torch.zeros((config.num_cameras, 6), dtype=torch.float32,
                       device=device)


def _skew(v: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) cross-product matrices."""
    z = torch.zeros_like(v[..., 0])
    return torch.stack([
        torch.stack([z, -v[..., 2], v[..., 1]], -1),
        torch.stack([v[..., 2], z, -v[..., 0]], -1),
        torch.stack([-v[..., 1], v[..., 0], z], -1),
    ], -2)


def _rotation(omega: torch.Tensor):
    """The shared head of both exp maps: (small (..., 1) bool, theta
    (..., 1, 1), K (..., 3, 3) the unit axis' skew matrix, R (..., 3, 3)).

    Double where around the norm: the small-angle branch never takes
    sqrt(0), whose infinite derivative would otherwise come back through
    the discarded branch as 0 * inf = NaN. Every step of a fresh run sits
    in that branch, since the tangents start at zero."""
    sq = torch.sum(omega * omega, dim=-1, keepdim=True)
    small = sq < 1e-12
    theta = torch.sqrt(torch.where(small, torch.ones_like(sq), sq))
    K = _skew(omega / theta)
    th = theta[..., None]
    eye = torch.eye(3, dtype=omega.dtype, device=omega.device)
    R = eye + torch.sin(th) * K + (1 - torch.cos(th)) * (K @ K)
    R = torch.where(small[..., None], eye + _skew(omega), R)
    return small, th, K, R


def exp_map_SO3xR3(tangent: torch.Tensor) -> torch.Tensor:
    """(..., 6) [t, omega] -> (..., 3, 4): R = exp(omega), T = t."""
    _, _, _, R = _rotation(tangent[..., 3:])
    return torch.cat([R, tangent[..., :3, None]], dim=-1)


def exp_map_SE3(tangent: torch.Tensor) -> torch.Tensor:
    """(..., 6) [rho, omega] -> (..., 3, 4), the full SE(3) exponential:
    R = exp(omega), T = V rho."""
    rho = tangent[..., :3]
    small, th, K, R = _rotation(tangent[..., 3:])
    eye = torch.eye(3, dtype=tangent.dtype, device=tangent.device)
    V = (eye + (1 - torch.cos(th)) / th * K
         + (th - torch.sin(th)) / th * (K @ K))
    V = torch.where(small[..., None], eye, V)
    return torch.cat([R, V @ rho[..., None]], dim=-1)


def apply_camera_opt(config: CameraOptConfig,
                     adjustment: Optional[torch.Tensor], camera_idx,
                     c2w: torch.Tensor) -> torch.Tensor:
    """Compose the learned delta of camera `camera_idx` (an int or a 0-d
    integer tensor) with c2w (3, 4): R' = dR R, t' = dR t + dt."""
    if config.mode == "off" or adjustment is None:
        return c2w
    tangent = adjustment[camera_idx]
    delta = (exp_map_SO3xR3(tangent) if config.mode == "SO3xR3"
             else exp_map_SE3(tangent))
    R = delta[..., :3, :3] @ c2w[:3, :3]
    t = delta[..., :3, :3] @ c2w[:3, 3:4] + delta[..., :3, 3:4]
    return torch.cat([R, t], dim=-1)
