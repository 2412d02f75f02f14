"""The inputs of the PVG configuration (configs/pvg_waymo3.json), made
from `--seed`: one temporal cloud on waymo3's street, the sky, and the
three-camera clip of waymo3 with no tracked vehicle.

The cloud is waymo3's background (the same draws: scene._cloud with
waymo3's street) and its temporal leaves after it: life peaks tau
uniform over the clip's time span; a share `static_share` of the slots
"static" (lifespan beta log-uniform over `static_lifespan_s`, speed
uniform up to `static_speed_mps` in a direction uniform on the sphere),
the rest "dynamic" (beta log-uniform over `dynamic_lifespan_s`, speed
uniform up to `dynamic_speed_mps` in a horizontal direction). Frozen with
the benchmark.
"""
from __future__ import annotations

import math

import torch

from . import scene, waymo3

TEMPORAL = ("tau", "s_beta", "velocity")


def clip_config(cfg: dict) -> dict:
    """cfg as waymo3's clip writer reads it: no vehicle."""
    return {**cfg, "objects": 0, "vehicle_stretches": [], "lanes_m": [0.0],
            "lidar_points_per_object": 0}


def duration(cfg: dict) -> float:
    """The clip's time span in seconds (its frames 0.1 s apart)."""
    return (waymo3.frames(cfg) - 1) * scene.CLIP_DT_US * 1e-6


def make_scene(seed: int, cfg: dict, device) -> dict:
    """{"bg/<leaf>" for the six gaussian leaves and TEMPORAL, "bg/active",
    "env_map"}: one slot in cfg["inactive_every"] inactive, all zeros."""
    g = scene.generator(seed, device)
    n = cfg["background_capacity"]
    span = waymo3.drive_length(cfg) + cfg["view_ahead_m"]
    bg = scene._cloud(g, n, (), cfg["background_fourier"], cfg["sh_degree"],
                      -3.3, None, waymo3._street(span), device)
    out = {f"bg/{k}": v for k, v in bg.items()}
    u = torch.rand((n, 6), generator=g, device=device)
    out["bg/tau"] = u[:, 0:1] * duration(cfg)
    dynamic = u[:, 1:2] >= cfg["static_share"]

    def log_uniform(lo_hi_static, lo_hi_dynamic, x):
        lo = torch.where(dynamic, math.log(lo_hi_dynamic[0]),
                         math.log(lo_hi_static[0]))
        hi = torch.where(dynamic, math.log(lo_hi_dynamic[1]),
                         math.log(lo_hi_static[1]))
        return lo + x * (hi - lo)
    out["bg/s_beta"] = log_uniform(cfg["static_lifespan_s"],
                                   cfg["dynamic_lifespan_s"], u[:, 2:3])
    speed = u[:, 3:4] * torch.where(dynamic, cfg["dynamic_speed_mps"],
                                    cfg["static_speed_mps"])
    phi = 2.0 * math.pi * u[:, 4:5]
    up = torch.where(dynamic, torch.zeros_like(phi), 2.0 * u[:, 5:6] - 1.0)
    flat = torch.sqrt(1.0 - up * up)
    out["bg/velocity"] = speed * torch.cat(
        [flat * torch.cos(phi), up, flat * torch.sin(phi)], -1)
    active = torch.ones((n,), dtype=torch.bool, device=device)
    active[cfg["inactive_every"] - 1::cfg["inactive_every"]] = False
    out["bg/active"] = active
    for k in scene.PARAMS + TEMPORAL:
        x = out[f"bg/{k}"]
        out[f"bg/{k}"] = torch.where(active[:, None] if x.dim() == 2
                                     else active[:, None, None], x,
                                     torch.zeros_like(x))
    r = cfg["env_map_res"]
    out["env_map"] = torch.rand((6, r, r, 3), generator=g, device=device)
    return out
