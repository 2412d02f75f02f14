"""What the EWA projection returns (`Projected`) and its two constants,
shared by the plain version (core.projection) and kernel L (ops.project)
without either importing the other's module."""
from __future__ import annotations

import dataclasses

import torch

CLIP_THRESH = 0.01  # near clip for projection validity
BLUR_2D = 0.3       # screen-space blur added to the 2D covariance diagonal


@dataclasses.dataclass(frozen=True)
class Projected:
    """Screen-space Gaussian attributes, all (N, ...)."""

    xys: torch.Tensor            # (N, 2) pixel-space centers
    depths: torch.Tensor         # (N,) view-space z
    radii: torch.Tensor          # (N,) int32 3-sigma radius; 0 = invisible
    conics: torch.Tensor         # (N, 3) inverse 2D covariance (a, b, c)
    comp: torch.Tensor           # (N,) blur compensation in [0, 1]
    num_tiles_hit: torch.Tensor  # (N,) int32 tiles in the tile box
    tile_box: torch.Tensor       # (N, 4) int32 [x0, x1, y0, y1)
