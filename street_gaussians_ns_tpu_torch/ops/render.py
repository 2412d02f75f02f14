"""The public render op: project -> bin -> composite (counterpart of
street_gaussians_ns_tpu/ops/render.py).

`render` maps activated Gaussian attributes + a camera to
{rgb, accumulation, depth}: EWA projection, the fused rasterizer with rgb
and depth as one 4-channel colour, the sky composited as
rgb*alpha + sky*(1-alpha), and the alpha-normalised depth with far fill.

`rasterize` runs the JAX package's fused kernel route (impl="pallas"
without shared bins): bin, pack and composite as one autograd node. The
JAX package's other routes (depth slices, shared bins, the portable
compositors) are references that tests hold this one against.
`precision="bf16"` rounds the feature columns to bf16 before binning
(ops.tiles._depth_sort_cols), the JAX package's production TPU mode.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Optional

import torch

from ..core.cameras import Camera, viewmat_from_c2w
from ..core.projection import Projected, project
from ..utils.profiling import count, span
from .composite import rasterize_tiles_fused
from .tiles import PRECISIONS, TileBins


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Render-path configuration."""

    tile_size: int = 16
    max_pairs: int = 2 ** 18           # sorted (gaussian, tile) capacity
    max_rowruns: Optional[int] = None  # (gaussian, tile-row) run capacity;
    #                                    default max_pairs // 2
    depth_far_fill: float = 10.0
    precision: str = "f32"             # "f32" | "bf16"

    def __post_init__(self):
        if self.precision not in PRECISIONS:
            raise ValueError(f"precision={self.precision!r}: expected one "
                             f"of {PRECISIONS}")

    @property
    def rowrun_capacity(self) -> int:
        return (self.max_rowruns if self.max_rowruns is not None
                else self.max_pairs // 2)


@dataclasses.dataclass(frozen=True)
class RenderOutputs:
    rgb: torch.Tensor           # (H, W, 3)
    accumulation: torch.Tensor  # (H, W, 1)
    depth: torch.Tensor         # (H, W, 1)
    projected: Projected
    bins: TileBins


def rasterize(proj: Projected, colors: torch.Tensor, opacities: torch.Tensor,
              camera: Camera, background: torch.Tensor, config: RenderConfig,
              last_color_is_depth: bool = False):
    """Bin + pack + composite in one node (ops.composite.
    rasterize_tiles_fused). Returns (img (H, W, C), alpha (H, W), bins).

    Warns (RuntimeWarning) when the scene needs more pairs or runs than
    the configured capacities, since the overflow pairs are dropped from
    this render. Reading the counts waits for the device."""
    img, alpha, bins = rasterize_tiles_fused(
        proj, colors, opacities, camera.width, camera.height,
        config.tile_size, background, config.max_pairs, config.max_rowruns,
        last_color_is_depth=last_color_is_depth, precision=config.precision)
    with span("render.read_counts", sync=True):
        num_pairs, num_rowruns, _ = (int(v) for v in torch.stack(
            [bins.num_pairs, bins.num_rowruns,
             bins.max_tile_count.to(torch.int64)]).tolist())
    count("render.pairs", num_pairs)
    if (num_pairs > config.max_pairs
            or num_rowruns > config.rowrun_capacity):
        warnings.warn(
            f"render capacity overflow: {num_pairs} pairs for max_pairs="
            f"{config.max_pairs}, {num_rowruns} row runs for max_rowruns="
            f"{config.rowrun_capacity}; the overflow pairs are dropped",
            RuntimeWarning, stacklevel=3)
    return img, alpha, bins


def render(
    means: torch.Tensor,       # (N, 3) world-space
    scales: torch.Tensor,      # (N, 3) linear (exp-activated)
    quats: torch.Tensor,       # (N, 4) wxyz
    opacities: torch.Tensor,   # (N,) in [0, 1]
    rgbs: torch.Tensor,        # (N, 3) per-splat RGB
    camera: Camera,
    config: RenderConfig,
    sky_rgb: Optional[torch.Tensor] = None,  # (H, W, 3)
    training: bool = True,
    active: Optional[torch.Tensor] = None,   # (N,) bool live gaussians
    xys_offset: Optional[torch.Tensor] = None,   # (N, 2), see below
) -> RenderOutputs:
    """Forward render of one camera: rasterization background zeros, rgb
    clamped to <= 1, the sky composited behind, alpha-normalised depth
    with far fill, and rgb clamped to [0, 1] when not training.

    The tile boxes are topology, not differentiated: `project` gets the
    opacities detached. `xys_offset`, when given, is added to the
    projected screen centers; it is a zero-valued hook whose gradient is
    the screen-space positional gradient that drives densification."""
    with span("render.project"):
        vm = viewmat_from_c2w(camera.c2w)
        proj = project(means, scales, quats, vm, camera.fx, camera.fy,
                       camera.cx, camera.cy, camera.width, camera.height,
                       tile_size=config.tile_size,
                       opacities=opacities.detach(), active=active,
                       xys_offset=xys_offset)
    with span("render.rasterize"):
        colors4 = torch.cat([rgbs, proj.depths[:, None]], dim=-1)
        background = torch.zeros((4,), dtype=torch.float32,
                                 device=means.device)
        img, alpha, bins = rasterize(proj, colors4, opacities, camera,
                                     background, config,
                                     last_color_is_depth=True)

    rgb = torch.clamp(img[..., :3], max=1.0)
    alpha1 = alpha[..., None]
    if sky_rgb is not None:
        rgb = rgb * alpha1 + sky_rgb * (1.0 - alpha1)
    if not training:
        rgb = torch.clamp(rgb, 0.0, 1.0)
    depth = torch.where(alpha1 > 1e-3,
                        img[..., 3:4] / torch.clamp(alpha1, min=1e-3),
                        torch.full_like(alpha1, config.depth_far_fill))
    return RenderOutputs(rgb=rgb, accumulation=alpha1, depth=depth,
                         projected=proj, bins=bins)
