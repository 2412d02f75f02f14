"""Splatfacto pieces the scene graph renders with (counterpart of
street_gaussians_ns_tpu/models/splatfacto.py: `SplatfactoConfig`,
`sh_colors`, `init_env_map`, `sky_color`, `loss_dict`)."""
from __future__ import annotations

import dataclasses

import torch

from ..core.cameras import Camera, pixel_directions
from ..core.sh import eval_sh
from ..ops.cubemap import sample_cubemap
from ..ops.ssim import ssim


@dataclasses.dataclass(frozen=True)
class SplatfactoConfig:
    """Same fields and defaults as the JAX package's SplatfactoConfig, so
    a JAX run's model config maps across field by field. Rendering reads
    sh_degree, sh_degree_interval, fourier_features_scale, env_map_res,
    use_sky_sphere and capacity; the rest configure training."""

    warmup_length: int = 500
    refine_every: int = 100
    resolution_schedule: int = 250
    num_downscales: int = 0
    cull_alpha_thresh: float = 0.1
    cull_scale_thresh: float = 0.5
    continue_cull_post_densification: bool = True
    reset_alpha_every: int = 30
    use_sky_sphere: bool = True
    sky_acc_loss_mult: float = 0.5
    densify_grad_thresh: float = 0.0002
    densify_size_thresh: float = 0.01
    n_split_samples: int = 2
    sh_degree_interval: int = 1000
    cull_screen_size: float = 0.15
    split_screen_size: float = 0.05
    stop_screen_size_at: int = 4000
    random_init: bool = False
    num_random: int = 50000
    random_scale: float = 10.0
    ssim_lambda: float = 0.2
    stop_split_at: int = 15000
    sh_degree: int = 3
    use_scale_regularization: bool = True
    max_gauss_ratio: float = 10.0
    rasterize_mode: str = "classic"
    fourier_features_dim: int = 1
    fourier_features_scale: float = 1.0
    env_map_res: int = 1024
    block_width: int = 16
    capacity: int = 2 ** 20
    refine_parent_cap_div: int = 16


def sh_colors(means: torch.Tensor, features_dc_t: torch.Tensor,
              features_rest: torch.Tensor, camera: Camera, step: int,
              config: SplatfactoConfig, training: bool = True) -> torch.Tensor:
    """Per-splat RGB by SH: view directions from the camera center (means
    and camera detached: no gradient flows through the directions), the
    active degree stepping up every sh_degree_interval steps in training
    and the full degree at eval, then +0.5 and the clamp at 0."""
    viewdirs = means.detach() - camera.c2w[:3, 3].detach()
    viewdirs = viewdirs / torch.clamp(
        torch.linalg.vector_norm(viewdirs, dim=-1, keepdim=True), min=1e-12)
    n = (min(int(step) // config.sh_degree_interval, config.sh_degree)
         if training else config.sh_degree)
    coeffs = torch.cat([features_dc_t[:, None, :], features_rest], dim=1)
    return torch.clamp(eval_sh(n, viewdirs, coeffs) + 0.5, min=0.0)


def init_env_map(config: SplatfactoConfig, device="cuda") -> torch.Tensor:
    """Sky cubemap (6, R, R, 3) initialised to 0.5."""
    r = config.env_map_res
    return torch.full((6, r, r, 3), 0.5, dtype=torch.float32, device=device)


def sky_color(env_map: torch.Tensor, camera: Camera,
              jitter: torch.Tensor | None = None,
              dirs_grad: bool = False) -> torch.Tensor:
    """Per-pixel sky RGB (H, W, 3): world rays (jittered when `jitter` is
    given, see core.cameras.pixel_directions) mapped to the cubemap frame
    (x, z, -y) and sampled. dirs_grad: see ops.cubemap.sample_cubemap."""
    dirs = pixel_directions(camera, jitter)
    to_opengl = torch.tensor([[1.0, 0.0, 0.0], [0.0, 0.0, 1.0],
                              [0.0, -1.0, 0.0]], device=dirs.device)
    return sample_cubemap(env_map, dirs @ to_opengl.T, dirs_grad=dirs_grad)


SKY_SEMANTIC = 2  # the semantic class of sky pixels


def loss_dict(outputs: dict, batch: dict, config: SplatfactoConfig) -> dict:
    """L1 + SSIM + sky accumulation losses. batch: {"image" (H, W, 3) in
    [0, 1], optional "mask" (H, W, 1) bool, optional "semantic" (H, W, 1)
    int}."""
    gt = batch["image"].to(torch.float32)
    rgb = outputs["rgb"]
    if batch.get("mask") is not None:
        m = batch["mask"].to(torch.float32)
        gt = gt * m
        rgb = rgb * m
    l1 = torch.mean(torch.abs(gt - rgb))
    simloss = 1.0 - ssim(gt, rgb)
    losses = {
        "Ll1": (1.0 - config.ssim_lambda) * l1,
        "simloss": config.ssim_lambda * simloss,
    }
    if batch.get("semantic") is not None and config.sky_acc_loss_mult > 0:
        sky_mask = (batch["semantic"] == SKY_SEMANTIC).to(torch.float32)
        losses["sky_accumulation"] = config.sky_acc_loss_mult * torch.mean(
            sky_mask * outputs["accumulation"])
    return losses
