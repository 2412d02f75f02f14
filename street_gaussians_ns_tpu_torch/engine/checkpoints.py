"""Carry the JAX package's checkpoints across (counterpart of
street_gaussians_ns_tpu/engine/checkpoints.py).

A JAX checkpoint is one `step-{:09d}.ckpt.npz` whose keys are the
tree-path strings of the saved state ("store/background/params/means",
"store/env_map", "opt/...", "step", ...). `store_from_numpy` builds the
port's SceneGraphStore from the store's arrays, keyed relative to the
store ("background/params/means", ...); `tracks_from_numpy` builds
ObjectTracks from a JAX ObjectTracks' arrays ("times", "centers", ...);
`load_checkpoint` reads an npz and selects the store under a prefix.

A whole train state crosses the same way: `train_state_from_numpy` /
`load_train_checkpoint` read the JAX trainer's keys ("store/...",
"opt/<group>/mu/bg", "opt/<group>/nu/obj", "opt/<group>/count",
"opt/sky_sphere/mu", "opt/bbox_opt/mu/delta_center", "step") into a
`SceneTrainState`, and `state_to_numpy` writes the same keys back. The JAX
"rng" key has no counterpart (the port draws from a `torch.Generator`,
seeded by the caller) and is ignored.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ..models.gaussians import GaussianParams, GaussianStore
from ..models.scene_graph import ObjectTracks, SceneGraphConfig, SceneGraphStore
from .optimizers import AdamState
from .scene_train_step import (BBOX_PARAMS, SceneTrainState,
                               init_scene_train_state)

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


def train_state_from_numpy(arrays, config: SceneGraphConfig, device="cuda",
                           seed: int = 0) -> SceneTrainState:
    """A JAX SceneTrainState's arrays (keyed by its checkpoint tree paths)
    -> the port's SceneTrainState on `device`. Adam groups missing from
    `arrays` start from zero moments; the generator is seeded with `seed`."""
    store = store_from_numpy(
        {k[len("store/"):]: v for k, v in arrays.items()
         if k.startswith("store/")}, config, device)
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)
    state = init_scene_train_state(store, generator)

    def moments(like, path: str):
        if isinstance(like, dict):
            return {k: moments(v, f"{path}/{k}") for k, v in like.items()}
        t = _tensor(arrays, path, device, torch.float32)
        if t.shape != like.shape:
            raise ValueError(f"{path}: shape {tuple(t.shape)}, the store "
                             f"needs {tuple(like.shape)}")
        return t

    opt = {}
    for name, zero in state.opt.items():
        if f"opt/{name}/count" not in arrays:
            opt[name] = zero
            continue
        opt[name] = AdamState(
            mu=moments(zero.mu, f"opt/{name}/mu"),
            nu=moments(zero.nu, f"opt/{name}/nu"),
            count=int(arrays[f"opt/{name}/count"]))
    step = int(arrays["step"]) if "step" in arrays else 0
    return SceneTrainState(store=store, opt=opt, step=step,
                           generator=generator)


def load_train_checkpoint(path: Path,
                          config: SceneGraphConfig = SceneGraphConfig(),
                          device="cuda", seed: int = 0) -> SceneTrainState:
    """Read a step-*.ckpt.npz written by the JAX trainer into a
    SceneTrainState."""
    with np.load(path, allow_pickle=False) as data:
        arrays = {k: data[k] for k in data.files}
    return train_state_from_numpy(arrays, config, device, seed)


def state_to_numpy(state: SceneTrainState) -> dict:
    """The state's arrays under the JAX trainer's checkpoint keys (the way
    back of train_state_from_numpy; no "rng")."""
    out = {}

    def put(path: str, tree):
        if isinstance(tree, dict):
            for k, v in tree.items():
                put(f"{path}/{k}", v)
        elif tree is not None:
            out[path] = tree.detach().cpu().numpy()

    store = state.store
    for prefix, part in (("background", store.background),
                         ("objects", store.objects)):
        put(f"store/{prefix}/params", part.params.as_dict())
        put(f"store/{prefix}/active", part.active)
        for name in _STATS:
            put(f"store/{prefix}/{name}", getattr(part, name))
    put("store/env_map", store.env_map)
    for name in BBOX_PARAMS:
        put(f"store/{name}", getattr(store, name))
    for name, s in state.opt.items():
        put(f"opt/{name}/mu", s.mu)
        put(f"opt/{name}/nu", s.nu)
        out[f"opt/{name}/count"] = np.asarray(s.count, np.int32)
    out["step"] = np.asarray(state.step, np.int32)
    return out
