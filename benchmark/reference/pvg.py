"""Plain PyTorch reference of Periodic Vibration Gaussians (PVG; Chen et
al., arXiv:2311.18561, sec. 3): one cloud whose gaussians move and fade
in time, and the sky cubemap, no boxes. At camera time t, with
a = 2 pi / l for the shared cycle l:

    mu(t) = mu + v sin(a (t - tau)) / a
    o(t)  = sigmoid(o~) exp(-(t - tau)^2 / (2 beta^2)),  beta = exp(s_beta)

written as plain operations whose gradients come from autograd, fed into
`gs`' pipeline (SH from mu(t), the sky, the losses, Adam) through
`gs_posed`' blocked compositor, so that three steps of a 4.2 M-slot
cloud fit on the card after the program is freed. TF32 is off
(gs.no_tf32). `position_scale` is PVG's position-aware densification
factor, which the cell's three steps do not reach (no refine among them)
and the CPU tests hold the program's to. Imports nothing of the measured
package.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import gs, gs_posed

TEMPORAL = ("tau", "s_beta", "velocity")
LEAF_GROUPS = gs_posed.LEAF_GROUPS + TEMPORAL


def temporal(means, logits, tau, s_beta, velocity, t, cycle: float):
    """(mu(t) (N, 3), o(t) (N,)) at time t (a float32 0-d tensor)."""
    a = 2.0 * math.pi / cycle
    dt = t - tau
    ph = a * dt
    beta = torch.exp(s_beta)
    w = torch.exp(-0.5 * (dt * dt) / (beta * beta))
    means_t = means + velocity * (torch.sin(ph) / a)
    return means_t, torch.sigmoid(logits[:, 0]) * w[:, 0]


def forward(p: dict, cam: dict, degree: int, cycle: float, training: bool,
            jitter=None):
    """The cloud's render of one camera at its time; p holds "bg/<leaf>",
    "bg/active" and "env_map"."""
    t = torch.tensor(cam["time"], dtype=torch.float32,
                     device=p["bg/means"].device)
    means, op = temporal(p["bg/means"], p["bg/opacities"], p["bg/tau"],
                         p["bg/s_beta"], p["bg/velocity"], t, cycle)
    active = p["bg/active"]
    op = torch.where(active, op, torch.zeros_like(op))
    dc = gs.fourier_dc(p["bg/features_dc"], torch.zeros(()))
    rgbs = gs.sh_rgb(means, dc, p["bg/features_rest"], cam["c2w"][:3, 3],
                     degree)
    sky = gs.sky_rgb(p["env_map"], cam, jitter if training else None)
    return gs_posed.render(means, torch.exp(p["bg/scales"]), p["bg/quats"],
                           op, rgbs, cam, sky, training, active)


def position_scale(means, camera_centres):
    """PVG's position-aware densification factor gamma(mu): 1 within 2 r
    of the cameras' centre c, |mu - c| / r beyond, with c their mean and
    r 1.1 times their largest distance from it."""
    c = camera_centres.mean(0)
    r = 1.1 * torch.linalg.vector_norm(camera_centres - c, dim=-1).max()
    d = torch.linalg.vector_norm(means - c, dim=-1)
    return torch.where(d < 2.0 * r, torch.ones_like(d), d / r)


def leaf_names(sc: dict) -> list:
    """The trained leaves: the cloud's nine groups and the sky."""
    return [f"bg/{g}" for g in LEAF_GROUPS] + ["env_map"]


def lr_at(group: str, step: int, temporal_lr: dict) -> float:
    """gs.lr_at, the temporal groups' (lr, final or None) from
    `temporal_lr` (the configuration's), in the same float32 schedule."""
    if group not in temporal_lr:
        return gs.lr_at(group, step)
    lr, final = temporal_lr[group]
    if final is None:
        return float(np.float32(lr))
    t = np.clip(np.float32(step) / np.float32(gs.MAX_STEPS), 0, 1)
    return float(np.float32(lr) * np.power(np.float32(final / lr), t,
                                           dtype=np.float32))


def reference_steps(sc: dict, steps: list, degree: int, cycle: float,
                    temporal_lr: dict) -> dict:
    """The first steps from the cloud's leaves `sc`: steps [(step, camera,
    target (H, W, 3), semantic (H, W, 1), jitter (2, H, W))], every leaf
    of LEAF_GROUPS and the sky stepped by Adam, inactive rows' gradients
    zeroed. Returns {"losses", "first_grad", "change"} as host floats."""
    gs.no_tf32()
    names = leaf_names(sc)
    fixed = {k: sc[k] for k in sc if k not in names}
    p = {k: sc[k].detach().clone() for k in names}
    p0 = {k: v.clone() for k, v in p.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    act = fixed["bg/active"]
    losses, first = [], {}
    for i, (step, cam, img, sem, jitter) in enumerate(steps):
        leaves = {k: p[k].requires_grad_(True) for k in names}
        out = forward({**leaves, **fixed}, cam, degree, cycle, training=True,
                      jitter=jitter)
        loss = gs.loss(out, img, sem)
        grads = torch.autograd.grad(loss, [leaves[k] for k in names])
        losses.append(float(loss.detach()))
        with torch.no_grad():
            for k, g in zip(names, grads):
                if k != "env_map":
                    a = act.reshape(act.shape + (1,) * (g.dim() - 1))
                    g = torch.where(a, g, torch.zeros_like(g))
                if i == 0:
                    first[k] = float(torch.linalg.vector_norm(g))
                p[k], m[k], v2[k] = gs.adam(
                    p[k].detach(), g, m[k], v2[k], i + 1,
                    lr_at(k.split("/")[-1], step, temporal_lr))
        del out, loss, grads, leaves
    change = {k: float(torch.linalg.vector_norm(p[k] - p0[k])) for k in names}
    return {"losses": losses, "first_grad": first, "change": change}
