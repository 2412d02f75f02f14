"""Splatfacto: one Gaussian cloud + sky cubemap (counterpart of
street_gaussians_ns_tpu/models/splatfacto.py: `SplatfactoConfig`,
`sh_colors`, `init_env_map`, `sky_color`, `forward`, `loss_dict`).

`forward` renders the single-model pipeline (engine.train_step); the
scene graph renders with the same pieces (models.scene_graph)."""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..core.cameras import Camera, pixel_directions
from ..core.sh import eval_sh
from ..ops.cubemap import sample_cubemap
from ..ops.render import RenderConfig, render
from ..ops.ssim import ssim
from ..utils.profiling import spanned
from .fourier import fourier_dc
from .gaussians import GaussianParams, activated_opacities


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


@spanned("scene.sh")
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


@spanned("scene.sky")
def sky_color(env_map: torch.Tensor, camera: Camera,
              jitter: torch.Tensor | None = None,
              dirs_grad: bool = False, row0: int = 0,
              rows: int | None = None) -> torch.Tensor:
    """Per-pixel sky RGB (rows, W, 3): world rays (jittered when `jitter`
    is given, see core.cameras.pixel_directions) mapped to the cubemap
    frame (x, z, -y) and sampled. dirs_grad: see
    ops.cubemap.sample_cubemap. row0 / rows select a band of pixel rows
    (the model-sharded sky, parallel.sharded)."""
    dirs = pixel_directions(camera, jitter, row0=row0, rows=rows)
    to_opengl = torch.tensor([[1.0, 0.0, 0.0], [0.0, 0.0, 1.0],
                              [0.0, -1.0, 0.0]]).to(dirs.device,
                                                    non_blocking=True)
    return sample_cubemap(env_map, dirs @ to_opengl.T, dirs_grad=dirs_grad)


def forward(params: GaussianParams, active: torch.Tensor, camera: Camera,
            step: int, config: SplatfactoConfig,
            render_config: RenderConfig,
            env_map: Optional[torch.Tensor] = None,
            jitter: Optional[torch.Tensor] = None, training: bool = True,
            time=None, xys_offset: Optional[torch.Tensor] = None):
    """One-camera render of one Gaussian cloud. Returns (outputs dict,
    RenderOutputs).

    The Fourier DC is taken at `time * fourier_features_scale` (time 0
    when None); the sky is sampled when `env_map` is given, its rays
    jittered by `jitter` ((2, H, W), core.cameras.draw_pixel_jitter) in
    training and through the pixel centers otherwise. `xys_offset` is the
    screen-space gradient hook of ops.render.render."""
    dev = params.means.device
    # A host number is filled in on the device, not copied there (a copy
    # from the host waits for the card).
    t = (torch.as_tensor(time, dtype=torch.float32, device=dev)
         if isinstance(time, torch.Tensor) else
         torch.full((), 0.0 if time is None else float(time),
                    dtype=torch.float32, device=dev))
    dc_t = fourier_dc(params.features_dc, t * config.fourier_features_scale)
    rgbs = sh_colors(params.means, dc_t, params.features_rest, camera, step,
                     config, training)
    opac = activated_opacities(params, active)
    scales = torch.exp(params.scales)
    sky = None
    if env_map is not None:
        sky = sky_color(env_map, camera, jitter if training else None)
    out = render(params.means, scales, params.quats, opac, rgbs, camera,
                 render_config, sky_rgb=sky, training=training,
                 active=active, xys_offset=xys_offset)
    outputs = {"rgb": out.rgb, "accumulation": out.accumulation,
               "depth": out.depth}
    if sky is not None:
        outputs["sky"] = sky
    return outputs, out


SKY_SEMANTIC = 2  # the semantic class of sky pixels


def loss_dict(outputs: dict, batch: dict, config: SplatfactoConfig,
              ssim_fn=None) -> dict:
    """L1 + SSIM + sky accumulation losses. batch: {"image" (H, W, 3) in
    [0, 1], optional "mask" (H, W, 1) bool, optional "semantic" (H, W, 1)
    int}. ssim_fn replaces ops.ssim.ssim (same contract): the
    model-sharded step passes a band-sharded one (parallel.sharded)."""
    gt = batch["image"].to(torch.float32)
    rgb = outputs["rgb"]
    if batch.get("mask") is not None:
        m = batch["mask"].to(torch.float32)
        gt = gt * m
        rgb = rgb * m
    l1 = torch.mean(torch.abs(gt - rgb))
    simloss = 1.0 - (ssim_fn or ssim)(gt, rgb)
    losses = {
        "Ll1": (1.0 - config.ssim_lambda) * l1,
        "simloss": config.ssim_lambda * simloss,
    }
    if batch.get("semantic") is not None and config.sky_acc_loss_mult > 0:
        sky_mask = (batch["semantic"] == SKY_SEMANTIC).to(torch.float32)
        losses["sky_accumulation"] = config.sky_acc_loss_mult * torch.mean(
            sky_mask * outputs["accumulation"])
    return losses
