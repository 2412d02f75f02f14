"""Checkpoints of the port, in the JAX package's layout (counterpart of
street_gaussians_ns_tpu/engine/checkpoints.py).

A checkpoint is one `step-{:09d}.ckpt.npz` whose keys are the tree-path
strings of the saved state ("store/background/params/means",
"store/env_map", "opt/<group>/mu/bg", "opt/<group>/count", "step", ...),
so either package reads the other's:

- `save_checkpoint` writes the state under those keys, plus an "rng" leaf
  of a JAX PRNG key's shape and dtype (the JAX `restore_checkpoint` needs
  every leaf of its target; the port draws from a `torch.Generator`, so it
  holds the JAX key of the generator's seed) and, under keys the JAX
  package never reads, the generator's state ("torch/generator_state")
  and whatever the caller adds (the trainer's sampler, "dm/...");
- `restore_checkpoint` reads one into the structure of a target state,
  every leaf required and its shape checked, as the JAX function does;
  the generator continues from the saved state where there is one;
  a target with the camera optimizer also reads "camera_opt" and its
  Adam group's accumulator ("opt/camera_opt/acc", "opt/camera_opt/calls");
- `latest_checkpoint` finds the newest in a directory.

The single-cloud state (engine.train_step.TrainState, the PVG model's)
saves its cloud as the background ("store/background/params/...", a
temporal cloud's tau, s_beta and velocity among them), its sky as
"store/env_map" and each Adam group under "opt/<group>/{mu,nu,count}";
a 4DGS state's deformation field (models.deform4d) is saved under
"store/field/{planes,decoder,aabb,time_span}" and its two groups as
"opt/field_planes", "opt/field_decoder". `restore_checkpoint` reads it
back into a target of that type.

The JAX package's arrays also cross on their own: `store_from_numpy` /
`tracks_from_numpy` build a SceneGraphStore / ObjectTracks from a JAX
store's or tracks' arrays, `train_state_from_numpy` /
`load_train_checkpoint` a SceneTrainState from a JAX train state's
(checked against a config's SH degree and Fourier dims, missing Adam
groups starting from zero), and `state_to_numpy` writes a state's arrays
back under the JAX keys (no "rng").
"""
from __future__ import annotations

import re
from pathlib import Path
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from ..models.gaussians import GaussianParams, GaussianStore
from ..models.pvg import TEMPORAL_GROUPS
from ..models.scene_graph import ObjectTracks, SceneGraphConfig, SceneGraphStore
from .optimizers import AdamState
from .scene_train_step import (BBOX_PARAMS, SceneTrainState,
                               init_scene_train_state)
from .train_step import TrainState

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
        for name in _PARAMS + TEMPORAL_GROUPS
        if name in _PARAMS or f"{prefix}/params/{name}" in arrays})
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


def _store(arrays, device) -> SceneGraphStore:
    f32 = torch.float32
    return SceneGraphStore(
        background=_gaussian_store(arrays, "background", device),
        objects=_gaussian_store(arrays, "objects", device),
        env_map=(_tensor(arrays, "env_map", device, f32)
                 if "env_map" in arrays else None),
        delta_center=_tensor(arrays, "delta_center", device, f32),
        delta_yaw=_tensor(arrays, "delta_yaw", device, f32),
        delta_rot=_tensor(arrays, "delta_rot", device, f32),
    )


def store_from_numpy(arrays, config: SceneGraphConfig,
                     device="cuda") -> SceneGraphStore:
    """The JAX SceneGraphStore's arrays (keys relative to the store) ->
    the port's SceneGraphStore on `device`, checked against `config`'s
    SH degree and Fourier dims."""
    store = _store(arrays, device)
    _check_width(store.background, config.background, "background")
    _check_width(store.objects, config.object_template, "objects")
    return store


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


def _sub(arrays, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in arrays.items()
            if k.startswith(prefix)}


def _train_state(arrays, store: SceneGraphStore,
                 generator: torch.Generator) -> SceneTrainState:
    """A SceneTrainState around `store` with the Adam groups of `arrays`
    (groups missing there start from zero moments), and the camera pose
    deltas where `arrays` holds "camera_opt"."""
    device = store.background.active.device
    camera_opt = (_tensor(arrays, "camera_opt", device, torch.float32)
                  if "camera_opt" in arrays else None)
    state = init_scene_train_state(store, generator, camera_opt=camera_opt)

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
        accum = zero.acc is not None and f"opt/{name}/calls" in arrays
        opt[name] = AdamState(
            mu=moments(zero.mu, f"opt/{name}/mu"),
            nu=moments(zero.nu, f"opt/{name}/nu"),
            count=int(arrays[f"opt/{name}/count"]),
            acc=(moments(zero.acc, f"opt/{name}/acc") if accum
                 else zero.acc),
            calls=int(arrays[f"opt/{name}/calls"]) if accum else zero.calls)
    step = int(arrays["step"]) if "step" in arrays else 0
    return SceneTrainState(store=store, opt=opt, step=step,
                           generator=generator, camera_opt=camera_opt)


def train_state_from_numpy(arrays, config: SceneGraphConfig, device="cuda",
                           seed: int = 0) -> SceneTrainState:
    """A JAX SceneTrainState's arrays (keyed by its checkpoint tree paths)
    -> the port's SceneTrainState on `device`. Adam groups missing from
    `arrays` start from zero moments; the generator is seeded with `seed`."""
    store = store_from_numpy(_sub(arrays, "store/"), config, device)
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)
    return _train_state(arrays, store, generator)


def load_train_checkpoint(path: Path,
                          config: SceneGraphConfig = SceneGraphConfig(),
                          device="cuda", seed: int = 0) -> SceneTrainState:
    """Read a step-*.ckpt.npz written by the JAX trainer into a
    SceneTrainState."""
    with np.load(path, allow_pickle=False) as data:
        arrays = {k: data[k] for k in data.files}
    return train_state_from_numpy(arrays, config, device, seed)


def _state_leaves(state) -> Iterator[Tuple[str, torch.Tensor]]:
    """(checkpoint key, tensor) of every array of a state (a
    SceneTrainState, or a TrainState whose cloud is saved as the
    background), in the JAX package's tree paths; the Adam counts, the
    accumulation calls and the step come as 0-d int32 tensors."""
    def walk(path: str, tree):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from walk(f"{path}/{k}", v)
        elif tree is not None:
            yield path, tree

    store = state.store
    single = isinstance(state, TrainState)
    parts = ((("background", store),) if single else
             (("background", store.background), ("objects", store.objects)))
    for prefix, part in parts:
        yield from walk(f"store/{prefix}/params", part.params.as_dict())
        yield f"store/{prefix}/active", part.active
        for name in _STATS:
            yield f"store/{prefix}/{name}", getattr(part, name)
    yield from walk("store/env_map",
                    state.env_map if single else store.env_map)
    if single:
        yield from walk("store/field", state.field)
    for name in () if single else BBOX_PARAMS:
        yield f"store/{name}", getattr(store, name)
    for name, s in state.opt.items():
        yield from walk(f"opt/{name}/mu", s.mu)
        yield from walk(f"opt/{name}/nu", s.nu)
        yield f"opt/{name}/count", torch.tensor(s.count, dtype=torch.int32)
        yield from walk(f"opt/{name}/acc", s.acc)
        if s.calls is not None:
            yield f"opt/{name}/calls", torch.tensor(s.calls,
                                                    dtype=torch.int32)
    yield "step", torch.tensor(state.step, dtype=torch.int32)
    if getattr(state, "camera_opt", None) is not None:
        yield "camera_opt", state.camera_opt


def state_to_numpy(state: SceneTrainState) -> dict:
    """The state's arrays under the JAX trainer's checkpoint keys (the way
    back of train_state_from_numpy; no "rng")."""
    return {k: t.detach().cpu().numpy() for k, t in _state_leaves(state)}


GENERATOR_KEY = "torch/generator_state"


def _jax_key(generator: torch.Generator) -> np.ndarray:
    """The legacy JAX PRNG key (2,) uint32 of the generator's seed, as
    jax.random.PRNGKey(seed) lays it out: [high word, low word]."""
    seed = generator.initial_seed()
    return np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF],
                    np.uint32)


def save_checkpoint(ckpt_dir: Path, step: int, state: SceneTrainState,
                    extra: Optional[Dict[str, np.ndarray]] = None) -> Path:
    """Write <ckpt_dir>/step-{step:09d}.ckpt.npz: the state under the JAX
    keys, "rng", the generator's state, and `extra` (keys the JAX package
    never reads). The file appears whole or not at all."""
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    arrays = state_to_numpy(state)
    arrays["rng"] = _jax_key(state.generator)
    arrays[GENERATOR_KEY] = state.generator.get_state().numpy()
    for k in extra or {}:
        if k in arrays:
            raise KeyError(f"extra array {k!r} would replace a state leaf")
    arrays.update(extra or {})
    out = ckpt_dir / f"step-{step:09d}.ckpt.npz"
    tmp = ckpt_dir / f".step-{step:09d}.partial.npz"
    np.savez(tmp, **arrays)
    tmp.replace(out)
    return out


def restore_checkpoint(path: Path, target):
    """Read a checkpoint of either package into the structure of
    `target` (a SceneTrainState, or a TrainState): every leaf of the
    target must be there with its shape. The generator continues from the
    saved state where the port wrote one, else from the target's."""
    with np.load(path, allow_pickle=False) as data:
        arrays = {}
        for key, leaf in _state_leaves(target):
            if key not in data.files:
                raise KeyError(f"checkpoint {path} missing leaf {key}")
            arr = data[key]
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"shape mismatch for {key}: ckpt "
                                 f"{arr.shape} vs target {tuple(leaf.shape)}")
            arrays[key] = arr
        saved_gen = (data[GENERATOR_KEY] if GENERATOR_KEY in data.files
                     else None)
    single = isinstance(target, TrainState)
    device = (target.store if single else target.store.background
              ).active.device
    generator = torch.Generator(device=device)
    generator.set_state(torch.from_numpy(saved_gen) if saved_gen is not None
                        else target.generator.get_state())
    if single:
        return _single_train_state(arrays, target, generator, device)
    return _train_state(arrays, _store(_sub(arrays, "store/"), device),
                        generator)


def _single_train_state(arrays, target: TrainState,
                        generator: torch.Generator, device) -> TrainState:
    """A TrainState of target's groups from a checkpoint's arrays."""
    f32 = torch.float32
    opt = {name: AdamState(
        mu=_tensor(arrays, f"opt/{name}/mu", device, f32),
        nu=_tensor(arrays, f"opt/{name}/nu", device, f32),
        count=int(arrays[f"opt/{name}/count"])) for name in target.opt}
    field = None
    if target.field is not None:
        field = {k: _tensor(arrays, f"store/field/{k}", device, f32)
                 for k in target.field}
    return TrainState(
        store=_gaussian_store(_sub(arrays, "store/"), "background", device),
        env_map=(_tensor(arrays, "store/env_map", device, f32)
                 if target.env_map is not None else None),
        opt=opt, step=int(arrays["step"]), generator=generator, field=field)


def checkpoint_extra(path: Path, prefix: str) -> Dict[str, np.ndarray]:
    """The arrays of a checkpoint under `prefix` (prefix stripped); empty
    when it has none, as a JAX-written one."""
    with np.load(path, allow_pickle=False) as data:
        return {k[len(prefix):]: data[k] for k in data.files
                if k.startswith(prefix)}


def latest_checkpoint(ckpt_dir: Path) -> Optional[Path]:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    best, best_step = None, -1
    for p in ckpt_dir.glob("step-*.ckpt.npz"):
        m = re.fullmatch(r"step-(\d+)\.ckpt\.npz", p.name)
        if m and int(m.group(1)) > best_step:
            best, best_step = p, int(m.group(1))
    return best
