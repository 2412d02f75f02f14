"""Camera container + pose conventions (counterpart of
street_gaussians_ns_tpu/core/cameras.py).

Camera-to-world poses are in the OpenGL/nerfstudio convention (x right,
y up, looking along -z); the rasterizer's view matrix flips y/z
(`viewmat_from_c2w`), exactly as the JAX package does, so the same poses
render the same images.
"""
from __future__ import annotations

import dataclasses

import torch

# Camera model identifiers (the JAX package's PERSPECTIVE / FISHEYE /
# FISHEYE624). FISHEYE624 frames are undistorted to pinhole by the data
# layer, so the render path only sees PERSPECTIVE.
PERSPECTIVE = 0
FISHEYE = 1
FISHEYE624 = 2


@dataclasses.dataclass(frozen=True)
class Camera:
    """A single pinhole camera with a timestamp.

    fx, fy, cx, cy and time are 0-d float32 tensors (kept as tensors so
    every derived quantity is computed in float32, as in the JAX package);
    c2w is (3, 4) OpenGL camera-to-world; width/height are python ints.
    """

    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    c2w: torch.Tensor
    time: torch.Tensor
    width: int
    height: int
    model: int = PERSPECTIVE

    @staticmethod
    def make(fx, fy, cx, cy, c2w, width: int, height: int, time=0.0,
             device="cuda", model: int = PERSPECTIVE) -> "Camera":
        def f32(v):
            # From host memory the copy is staged at once and does not
            # wait for the card's queue to drain.
            return torch.as_tensor(v, dtype=torch.float32).to(
                device, non_blocking=True)

        return Camera(fx=f32(fx), fy=f32(fy), cx=f32(cx), cy=f32(cy),
                      c2w=f32(c2w)[:3, :4], time=f32(time),
                      width=int(width), height=int(height), model=model)

    @property
    def device(self) -> torch.device:
        return self.c2w.device


def viewmat_from_c2w(c2w: torch.Tensor) -> torch.Tensor:
    """OpenGL c2w (3, 4) -> world-to-camera (4, 4) in rasterizer
    convention: R @ diag(1, -1, -1), then the analytic rigid inverse."""
    R = torch.cat([c2w[:3, :1], -c2w[:3, 1:3]], dim=1)
    T = c2w[:3, 3:4]
    R_inv = R.T
    T_inv = -R_inv @ T
    viewmat = torch.eye(4, dtype=c2w.dtype, device=c2w.device)
    viewmat[:3, :3] = R_inv
    viewmat[:3, 3:4] = T_inv
    return viewmat


def draw_pixel_jitter(camera: Camera,
                      generator: torch.Generator) -> torch.Tensor:
    """The training-time anti-alias jitter: (2, H, W) offsets (du, dv)
    uniform in [0, 1), drawn from `generator` on the camera's device."""
    return torch.rand((2, camera.height, camera.width), dtype=torch.float32,
                      device=camera.device, generator=generator)


def pixel_directions(camera: Camera,
                     jitter: torch.Tensor | None = None, row0: int = 0,
                     rows: int | None = None) -> torch.Tensor:
    """Per-pixel world ray directions (rows, W, 3), normalized. `jitter`
    ((2, H, W), see draw_pixel_jitter) offsets every pixel's ray at train
    time; without it the rays go through the pixel centers (eval).

    row0 / rows select the band of pixel rows [row0, row0 + rows) (all H
    rows by default): a device of a model group computes its band of the
    sky. The jitter stays the full frame's, so the bands compose to the
    full frame exactly; rows past H (the last band's padding) get zero
    jitter and are cropped by the caller.

    Camera-frame rays ((u - cx + du)/fx, (v - cy + dv)/fy, 1) are rotated
    by the raw OpenGL c2w rotation, as the JAX package does."""
    if camera.model != PERSPECTIVE:
        raise NotImplementedError(
            "pixel rays are pinhole rays, in this package and the JAX one: "
            "the data layer undistorts FISHEYE and FISHEYE624 frames to "
            "pinhole at load time (data/dataset.py), so a camera reaches "
            "the renderer as PERSPECTIVE")
    H, W = camera.height, camera.width
    if rows is None:
        rows = H
    dev = camera.device
    u = torch.arange(W, dtype=torch.float32, device=dev)[None, :].expand(
        rows, W)
    v = (torch.arange(rows, dtype=torch.float32, device=dev)
         + float(row0))[:, None].expand(rows, W)
    if jitter is not None:
        if tuple(jitter.shape) != (2, H, W):
            raise ValueError(f"jitter must be (2, {H}, {W}), got "
                             f"{tuple(jitter.shape)}")
        if rows != H or row0 != 0:
            jitter = torch.nn.functional.pad(jitter, (0, 0, 0, rows))[
                :, row0:row0 + rows]
        u = u + jitter[0]
        v = v + jitter[1]
    else:
        u = u + 0.5
        v = v + 0.5
    d = torch.stack([(u - camera.cx) / camera.fx, (v - camera.cy) / camera.fy,
                     torch.ones_like(u)], dim=-1)
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    return torch.einsum("ij,hwj->hwi", camera.c2w[:3, :3], d)
