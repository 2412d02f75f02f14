"""The inputs of the 4DGS configuration (configs/deform4d_waymo3.json),
made from `--seed`: one canonical cloud on waymo3's street, the sky, the
HexPlane deformation field as it stands at the checkpoint, and the
three-camera clip of waymo3 with no tracked vehicle (pvg3.clip_config).

The cloud is waymo3's background (the same draws: scene._cloud with
waymo3's street), one slot in cfg["inactive_every"] inactive and zero.
The field's draws follow it: the spatial planes uniform over
`spatial_plane_init` (K-Planes' initialisation), the time planes 1 plus
a normal of deviation `time_plane_sd` (so that the time axis has a
gradient), the decoder's weights Xavier-uniform and its biases uniform
over +-1 / sqrt(fan_in) (4DGS's and nn.Linear's initialisations). Its box
is the live cloud's bounds, its time span the clip's. Frozen with the
benchmark.
"""
from __future__ import annotations

import math

import torch

from . import pvg3, scene, waymo3
from .reference import deform4d as ref


def make_scene(seed: int, cfg: dict, device) -> dict:
    """{"bg/<leaf>" for the six gaussian leaves, "bg/active", "env_map",
    "field/planes", "field/decoder", "field/aabb", "field/time_span"}."""
    g = scene.generator(seed, device)
    n = cfg["background_capacity"]
    span = waymo3.drive_length(cfg) + cfg["view_ahead_m"]
    bg = scene._cloud(g, n, (), cfg["background_fourier"], cfg["sh_degree"],
                      -3.3, None, waymo3._street(span), device)
    out = {f"bg/{k}": v for k, v in bg.items()}
    active = torch.ones((n,), dtype=torch.bool, device=device)
    active[cfg["inactive_every"] - 1::cfg["inactive_every"]] = False
    out["bg/active"] = active
    for k in scene.PARAMS:
        x = out[f"bg/{k}"]
        m = active.reshape(active.shape + (1,) * (x.dim() - 1))
        out[f"bg/{k}"] = torch.where(m, x, torch.zeros_like(x))
    r = cfg["env_map_res"]
    out["env_map"] = torch.rand((6, r, r, 3), generator=g, device=device)
    lo, hi = cfg["spatial_plane_init"]
    planes = []
    for s, shape in enumerate(ref.plane_shapes(cfg)):
        k = math.prod(shape)
        if s % 6 < 3:
            planes.append(lo + (hi - lo) * torch.rand(k, generator=g,
                                                      device=device))
        else:
            planes.append(1.0 + cfg["time_plane_sd"] * torch.randn(
                k, generator=g, device=device))
    out["field/planes"] = torch.cat(planes)
    dec = []
    for name, shape in ref.decoder_shapes(cfg):
        u = 2.0 * torch.rand(math.prod(shape), generator=g,
                             device=device) - 1.0
        if len(shape) == 2:
            dec.append(u * math.sqrt(6.0 / (shape[0] + shape[1])))
        else:
            fan_in = (len(cfg["plane_scales"]) * cfg["plane_channels"]
                      if name == "b0" else cfg["net_width"])
            dec.append(u / math.sqrt(fan_in))
    out["field/decoder"] = torch.cat(dec)
    live = out["bg/means"][active]
    out["field/aabb"] = torch.stack([live.amin(0), live.amax(0)])
    out["field/time_span"] = torch.tensor([0.0, pvg3.duration(cfg)],
                                          dtype=torch.float32, device=device)
    return out
