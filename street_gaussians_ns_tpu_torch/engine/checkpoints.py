"""Carry the JAX package's checkpoints across (counterpart of
street_gaussians_ns_tpu/engine/checkpoints.py).

A JAX checkpoint is one `step-{:09d}.ckpt.npz` whose keys are the
tree-path strings of the saved state ("store/background/params/means",
"store/env_map", "opt/...", "step", ...). `store_from_numpy` builds the
port's SceneGraphStore from the store's arrays, keyed relative to the
store ("background/params/means", ...); `tracks_from_numpy` builds
ObjectTracks from a JAX ObjectTracks' arrays ("times", "centers", ...);
`load_checkpoint` reads an npz and selects the store under a prefix.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ..models.gaussians import GaussianParams, GaussianStore
from ..models.scene_graph import ObjectTracks, SceneGraphConfig, SceneGraphStore

_PARAMS = ("means", "scales", "quats", "features_dc", "features_rest",
           "opacities")
_STATS = ("xys_grad_norm", "vis_counts", "max_2dsize")


def _tensor(arrays, key, device, dtype=None):
    if key not in arrays:
        raise KeyError(f"missing array {key!r}")
    t = torch.from_numpy(np.ascontiguousarray(arrays[key]))
    return t.to(device=device, dtype=dtype or t.dtype)


def _gaussian_store(arrays, prefix: str, device) -> GaussianStore:
    f32 = torch.float32
    params = GaussianParams(**{
        name: _tensor(arrays, f"{prefix}/params/{name}", device, f32)
        for name in _PARAMS})
    active = _tensor(arrays, f"{prefix}/active", device, torch.bool)
    stats = {name: (_tensor(arrays, f"{prefix}/{name}", device, f32)
                    if f"{prefix}/{name}" in arrays
                    else torch.zeros(active.shape, dtype=f32, device=device))
             for name in _STATS}
    return GaussianStore(params=params, active=active, **stats)


def _check_width(store: GaussianStore, cfg, name: str) -> None:
    k = (cfg.sh_degree + 1) ** 2 - 1
    got_rest = store.params.features_rest.shape[-2]
    got_f = store.params.features_dc.shape[-2]
    if got_rest != k:
        raise ValueError(f"{name}: features_rest has {got_rest} bands, "
                         f"sh_degree {cfg.sh_degree} needs {k}")
    if got_f != cfg.fourier_features_dim:
        raise ValueError(f"{name}: features_dc has Fourier dim {got_f}, "
                         f"config says {cfg.fourier_features_dim}")


def store_from_numpy(arrays, config: SceneGraphConfig,
                     device="cuda") -> SceneGraphStore:
    """The JAX SceneGraphStore's arrays (keys relative to the store) ->
    the port's SceneGraphStore on `device`, checked against `config`'s
    SH degree and Fourier dims."""
    bg = _gaussian_store(arrays, "background", device)
    obj = _gaussian_store(arrays, "objects", device)
    _check_width(bg, config.background, "background")
    _check_width(obj, config.object_template, "objects")
    env = (_tensor(arrays, "env_map", device, torch.float32)
           if "env_map" in arrays else None)
    f32 = torch.float32
    return SceneGraphStore(
        background=bg, objects=obj, env_map=env,
        delta_center=_tensor(arrays, "delta_center", device, f32),
        delta_yaw=_tensor(arrays, "delta_yaw", device, f32),
        delta_rot=_tensor(arrays, "delta_rot", device, f32),
    )


def tracks_from_numpy(arrays, device="cuda") -> ObjectTracks:
    """A JAX ObjectTracks' arrays (keys = its field names) -> ObjectTracks."""
    f32 = torch.float32
    return ObjectTracks(
        times=_tensor(arrays, "times", device, f32),
        centers=_tensor(arrays, "centers", device, f32),
        quats=_tensor(arrays, "quats", device, f32),
        valid=_tensor(arrays, "valid", device, torch.bool),
        sizes=_tensor(arrays, "sizes", device, f32),
        obj_first=_tensor(arrays, "obj_first", device, f32),
        obj_last=_tensor(arrays, "obj_last", device, f32),
    )


def load_checkpoint(path: Path, prefix: str = "store/",
                    config: SceneGraphConfig = SceneGraphConfig(),
                    device="cuda") -> SceneGraphStore:
    """Read a JAX-written step-*.ckpt.npz and build the SceneGraphStore
    saved under `prefix` ("store/" for the JAX trainer's state)."""
    with np.load(path, allow_pickle=False) as data:
        arrays = {k[len(prefix):]: data[k] for k in data.files
                  if k.startswith(prefix)}
    if not arrays:
        raise KeyError(f"{path}: no arrays under prefix {prefix!r}")
    return store_from_numpy(arrays, config, device)
