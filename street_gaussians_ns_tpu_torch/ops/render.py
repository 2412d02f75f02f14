"""The public render op: project -> bin -> composite (counterpart of
street_gaussians_ns_tpu/ops/render.py).

`render` maps activated Gaussian attributes + a camera to
{rgb, accumulation, depth}: EWA projection, the fused rasterizer with rgb
and depth as one 4-channel colour, the sky composited as
rgb*alpha + sky*(1-alpha), and the alpha-normalised depth with far fill.

`rasterize` takes the routes of the JAX package's: the fused kernel path
(impl="fused", or its JAX name "pallas", with no bins passed), whole or
in `depth_slices` depth-rank windows; the kernel compositor over shared
bins (impl="fused"/"pallas" with `bins`); and the two portable
compositors in plain PyTorch (impl="chunked", "scan") over
`ops.tiles.bin_gaussians`' bins, which render at most `max_per_tile`
pairs of a tile. `precision="bf16"` rounds the fused routes' feature
columns to bf16 before binning (ops.tiles._depth_sort_cols), the JAX
package's production TPU mode; the other routes ignore it, as there.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Optional

import torch

from ..core.cameras import Camera, viewmat_from_c2w
from ..core.projection import Projected, project
from .composite import rasterize_tiles_fused, rasterize_tiles_pallas
from .composite_chunked import rasterize_tiles_chunked
from .composite_scan import rasterize_tiles_scan
from .tiles import PRECISIONS, TileBins, bin_gaussians

IMPLS = ("fused", "pallas", "chunked", "scan")


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Render-path configuration."""

    tile_size: int = 16
    max_pairs: int = 2 ** 18           # sorted (gaussian, tile) capacity
    max_rowruns: Optional[int] = None  # (gaussian, tile-row) run capacity;
    #                                    default max_pairs // 2
    max_per_tile: int = 1024           # a tile's pair budget in the
    #                                    portable compositors
    chunk: int = 32                    # splats per chunk of impl="chunked"
    impl: str = "fused"                # "fused" (= "pallas") | "chunked" |
    #                                    "scan"
    depth_far_fill: float = 10.0
    precision: str = "f32"             # "f32" | "bf16" (fused routes)
    depth_slices: int = 1              # > 1: the fused path composites that
    #                                    many depth-rank windows one after
    #                                    another; max_pairs / max_rowruns
    #                                    stay the totals

    def __post_init__(self):
        if self.impl not in IMPLS:
            raise ValueError(f"impl={self.impl!r}: expected one of {IMPLS}")
        if self.precision not in PRECISIONS:
            raise ValueError(f"precision={self.precision!r}: expected one "
                             f"of {PRECISIONS}")
        if self.depth_slices < 1:
            raise ValueError(f"depth_slices must be >= 1, got "
                             f"{self.depth_slices}")
        if self.max_per_tile < 1 or self.chunk < 1:
            raise ValueError("max_per_tile and chunk must be >= 1")

    @property
    def kernel_impl(self) -> bool:
        return self.impl in ("fused", "pallas")

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
              bins: Optional[TileBins] = None,
              last_color_is_depth: bool = False):
    """Bin + composite. Returns (img (H, W, C), alpha (H, W), bins).

    With a kernel impl and no `bins`, the fused rasterizer bins, packs and
    composites in one node (depth-sliced when config.depth_slices > 1).
    Otherwise the scene is binned by ops.tiles.bin_gaussians (unless the
    caller shares `bins`) and composited by the kernel compositor over
    shared bins or by a portable one.

    Warns (RuntimeWarning) when the scene needs more pairs or runs than
    the configured capacities (for a sliced render: than k times its
    fullest window needs), since the overflow pairs are dropped from this
    render, and when a portable compositor's `max_per_tile` is below the
    densest tile, since it drops the pairs past it. Reading the counts
    waits for the device."""
    width, height = camera.width, camera.height
    if config.kernel_impl and bins is None:
        img, alpha, bins = rasterize_tiles_fused(
            proj, colors, opacities, width, height, config.tile_size,
            background, config.max_pairs, config.max_rowruns,
            last_color_is_depth=last_color_is_depth,
            precision=config.precision, depth_slices=config.depth_slices)
    else:
        if bins is None:
            bins = bin_gaussians(proj, width, height, config.tile_size,
                                 config.max_pairs, config.max_rowruns,
                                 opacities=opacities.detach())
        args = (proj.xys, proj.conics, colors, opacities, bins, width,
                height, config.tile_size, background)
        if config.impl == "scan":
            img, alpha = rasterize_tiles_scan(*args, config.max_per_tile)
        elif config.impl == "chunked":
            img, alpha = rasterize_tiles_chunked(*args, config.max_per_tile,
                                                 config.chunk)
        else:
            img, alpha = rasterize_tiles_pallas(*args)
    num_pairs, num_rowruns, densest = (int(v) for v in torch.stack(
        [bins.num_pairs, bins.num_rowruns,
         bins.max_tile_count.to(torch.int64)]).tolist())
    if (num_pairs > config.max_pairs
            or num_rowruns > config.rowrun_capacity):
        warnings.warn(
            f"render capacity overflow: {num_pairs} pairs for max_pairs="
            f"{config.max_pairs}, {num_rowruns} row runs for max_rowruns="
            f"{config.rowrun_capacity}; the overflow pairs are dropped",
            RuntimeWarning, stacklevel=3)
    if not config.kernel_impl and densest > config.max_per_tile:
        warnings.warn(
            f"render truncation: the densest tile holds {densest} pairs, "
            f"impl={config.impl!r} renders max_per_tile="
            f"{config.max_per_tile} of them and drops the rest",
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
    vm = viewmat_from_c2w(camera.c2w)
    proj = project(means, scales, quats, vm, camera.fx, camera.fy,
                   camera.cx, camera.cy, camera.width, camera.height,
                   tile_size=config.tile_size, opacities=opacities.detach())
    if active is not None:
        proj = dataclasses.replace(
            proj,
            radii=torch.where(active, proj.radii, 0),
            num_tiles_hit=torch.where(active, proj.num_tiles_hit, 0),
        )
    if xys_offset is not None:
        proj = dataclasses.replace(proj, xys=proj.xys + xys_offset)
    colors4 = torch.cat([rgbs, proj.depths[:, None]], dim=-1)
    background = torch.zeros((4,), dtype=torch.float32, device=means.device)
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
