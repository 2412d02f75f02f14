"""Periodic Vibration Gaussians (PVG; Chen, Gu, Jiang, Zhu, Zhang,
"Periodic Vibration Gaussian: Dynamic Urban Scene Reconstruction and
Real-time Rendering", arXiv:2311.18561): one temporal cloud and the sky
cubemap, static and moving content alike, with no tracked boxes.

Each gaussian of a temporal store (models.gaussians, `tau`, `s_beta`,
`velocity`) has a life peak tau, a lifespan beta = exp(s_beta) and a
vibration direction v; one cycle length l is shared. At camera time t,
with a = 2 pi / l:

    mu(t) = mu + v sin(a (t - tau)) / a
    o(t)  = sigmoid(o~) exp(-(t - tau)^2 / (2 beta^2))

Scales, rotations and SH colours are static. `temporal` is the transform
as one autograd Function whose backward is written out in closed form
(span `pvg.temporal_bwd`); `forward` is Splatfacto's forward
(models.splatfacto) with mu(t) and o(t) in place of mu and sigmoid(o~);
the loss is Splatfacto's (models.splatfacto.loss_dict, which
engine.train_step applies to either model). While tracing records,
`forward` counts the active slots faded at the camera's time (o(t) <
1/255, which give no pixel an alpha above the compositor's threshold)
into the counter `pvg.faded`. The position-aware densification
(`densify_scale`) scales each gaussian's densify gradient by gamma(mu) =
|mu - c| / r beyond 2 r of the training cameras' centre c, 1 within
(`scene_extent`).

Left out, until the official configuration is in the repository: the
LiDAR depth term, the sky-opacity BCE, the velocity regulariser and the
temporal smoothing by intrinsic motion (a training augmentation).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from ..core.cameras import Camera, viewmat_from_c2w
from ..core.projection import project
from ..ops.render import RenderConfig, render
from ..ops.tiles import count_pairs
from ..utils import profiling
from ..utils.profiling import span
from .fourier import fourier_dc
from .gaussians import GaussianParams, GaussianStore
from .splatfacto import SplatfactoConfig, sh_colors, sky_color

TEMPORAL_GROUPS = ("tau", "s_beta", "velocity")
FADED = 1.0 / 255.0     # the compositor's alpha threshold


@dataclasses.dataclass(frozen=True)
class PVGConfig:
    """The temporal model's own number (the rest is the scene graph's:
    `base` renders, `background` refines)."""

    cycle: float = 1.0              # l, in the clip's seconds


def _terms(tau, s_beta, t, a: float):
    """t - tau, the phase a (t - tau) and the time weight exp(-(t - tau)^2
    / (2 beta^2)), in the reference's order of operations."""
    dt = t - tau
    ph = a * dt
    beta = torch.exp(s_beta)
    w = torch.exp(-0.5 * (dt * dt) / (beta * beta))
    return dt, ph, beta, w


class _Temporal(torch.autograd.Function):
    """(mu, o~, tau, s_beta, v) at time t -> (mu(t) (N, 3), o(t) (N,))."""

    @staticmethod
    def forward(ctx, means, logits, tau, s_beta, velocity, t, a):
        _, ph, _, w = _terms(tau, s_beta, t, a)
        means_t = means + velocity * (torch.sin(ph) / a)
        op_t = torch.sigmoid(logits[:, 0]) * w[:, 0]
        ctx.save_for_backward(logits, tau, s_beta, velocity, t)
        ctx.a = a
        return means_t, op_t

    @staticmethod
    def backward(ctx, g_means, g_op):
        logits, tau, s_beta, velocity, t = ctx.saved_tensors
        a = ctx.a
        with span("pvg.temporal_bwd"):
            dt, ph, beta, w = _terms(tau, s_beta, t, a)
            sig = torch.sigmoid(logits)
            g_o = g_op[:, None]
            # d o(t) / d tau = o(t) (t - tau) / beta^2,
            # d o(t) / d s_beta = o(t) (t - tau)^2 / beta^2.
            go_o = g_o * (sig * w) * dt / (beta * beta)
            g_tau = (go_o - torch.sum(g_means * velocity, -1, keepdim=True)
                     * torch.cos(ph))
            g_s_beta = go_o * dt
            g_v = g_means * (torch.sin(ph) / a)
            g_logits = g_o * w * (sig * (1.0 - sig))
        return g_means, g_logits, g_tau, g_s_beta, g_v, None, None


def temporal(params: GaussianParams, t: torch.Tensor, cycle: float):
    """mu(t) (N, 3) and o(t) (N,) of a temporal store's parameters at time
    t (a 0-d tensor on their device); the span `pvg.temporal`."""
    t = torch.as_tensor(t, dtype=torch.float32, device=params.means.device)
    with span("pvg.temporal"):
        return _Temporal.apply(params.means, params.opacities, params.tau,
                               params.s_beta, params.velocity, t,
                               2.0 * math.pi / cycle)


def _count_faded(op_t: torch.Tensor, active: torch.Tensor) -> None:
    """The counter `pvg.faded`, only while tracing records: the reduction
    and its read (a host wait) are not paid otherwise."""
    if not profiling.recording():
        return
    with span("pvg.faded_read", sync=True):
        profiling.count("pvg.faded", int(((op_t < FADED) & active).sum()))


def forward(params: GaussianParams, active: torch.Tensor, camera: Camera,
            step: int, config: SplatfactoConfig, pvg: PVGConfig,
            render_config: RenderConfig,
            env_map: Optional[torch.Tensor] = None,
            jitter: Optional[torch.Tensor] = None, training: bool = True,
            xys_offset: Optional[torch.Tensor] = None):
    """One-camera render of a temporal cloud at the camera's time: as
    models.splatfacto.forward, with mu(t) and o(t) (inactive slots 0).
    Returns (outputs dict, RenderOutputs)."""
    means_t, op_t = temporal(params, camera.time, pvg.cycle)
    _count_faded(op_t, active)
    opac = torch.where(active, op_t, torch.zeros_like(op_t))
    dc = fourier_dc(params.features_dc,
                    torch.zeros((), device=params.means.device))
    rgbs = sh_colors(means_t, dc, params.features_rest, camera, step, config,
                     training)
    sky = None
    if env_map is not None:
        sky = sky_color(env_map, camera, jitter if training else None)
    out = render(means_t, torch.exp(params.scales), params.quats, opac, rgbs,
                 camera, render_config, sky_rgb=sky, training=training,
                 active=active, xys_offset=xys_offset)
    outputs = {"rgb": out.rgb, "accumulation": out.accumulation,
               "depth": out.depth}
    if sky is not None:
        outputs["sky"] = sky
    return outputs, out


@torch.no_grad()
def pair_counts(store: GaussianStore, camera: Camera, pvg: PVGConfig,
                tile_size: int = 16):
    """Exact, capacity-free (num_pairs, num_rowruns) of one view at the
    camera's time (the trainer's pair presize; models.scene_graph's
    counterpart is engine.trainer.scene_pair_counts)."""
    means_t, op_t = temporal(store.params, camera.time, pvg.cycle)
    opac = torch.where(store.active, op_t, torch.zeros_like(op_t))
    proj = project(means_t, torch.exp(store.params.scales),
                   store.params.quats, viewmat_from_c2w(camera.c2w),
                   camera.fx, camera.fy, camera.cx, camera.cy, camera.width,
                   camera.height, tile_size=tile_size, opacities=opac)
    proj = dataclasses.replace(
        proj, radii=torch.where(store.active, proj.radii, 0),
        num_tiles_hit=torch.where(store.active, proj.num_tiles_hit, 0))
    return count_pairs(proj, camera.width, camera.height, tile_size,
                       opacities=opac)


def scene_extent(camera_centres: np.ndarray):
    """(centre c (3,), radius r) of the training cameras' positions: their
    mean, and 1.1 times the largest distance from it (3D Gaussian
    Splatting's getNerfppNorm, which PVG keeps)."""
    pts = np.asarray(camera_centres, np.float64).reshape(-1, 3)
    c = pts.mean(axis=0)
    r = 1.1 * float(np.linalg.norm(pts - c, axis=1).max(initial=0.0))
    return c.astype(np.float32), max(r, 1e-6)


def densify_scale(means: torch.Tensor, centre, radius: float):
    """gamma(mu) (N,): 1 within 2 r of the centre, |mu - c| / r beyond
    (`centre` on the means' device, or copied there)."""
    c = torch.as_tensor(centre, dtype=torch.float32, device=means.device)
    d = torch.linalg.vector_norm(means - c, dim=-1)
    return torch.where(d < 2.0 * radius, torch.ones_like(d), d / radius)
