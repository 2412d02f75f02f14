"""Run-directory config serialization + eval_setup (counterpart of
street_gaussians_ns_tpu/engine/setup.py).

config.json in the run directory holds the data, model, trainer and
datamanager configs in the JAX package's schema (the device is not part
of it), and each package reads only the fields of its own dataclasses, so
either package loads the other's run directory. A run of the PVG model
(models.pvg) adds a "pvg" section, which only the port reads
(`load_pvg_config`), and a run of 4D Gaussian Splatting (models.deform4d)
a "deform4d" section (`load_deform4d_config`). `eval_setup(run_dir)`
rebuilds the trainer from it and restores the latest (or a given)
checkpoint.
"""
from __future__ import annotations

import dataclasses
import json
import typing
from pathlib import Path
from typing import Optional


def _to_jsonable(obj):
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: _to_jsonable(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, Path):
        return str(obj)
    if isinstance(obj, (list, tuple)):
        return [_to_jsonable(o) for o in obj]
    return obj


def _from_jsonable(cls, data):
    hints = typing.get_type_hints(cls)
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in data:
            continue   # field added after this config.json was written
        v = data[f.name]
        t = hints[f.name]
        if typing.get_origin(t) is typing.Union:
            args = [a for a in typing.get_args(t) if a is not type(None)]
            if v is None:
                kwargs[f.name] = None
                continue
            t = args[0]
        if dataclasses.is_dataclass(t):
            kwargs[f.name] = _from_jsonable(t, v)
        elif t is Path:
            kwargs[f.name] = Path(v)
        else:
            kwargs[f.name] = v
    return cls(**kwargs)


def save_run_config(run_dir: Path, data_config, scene_config, trainer_config,
                    dm_config, pvg=None, deform4d=None) -> Path:
    run_dir = Path(run_dir)
    run_dir.mkdir(parents=True, exist_ok=True)
    out = run_dir / "config.json"
    cfg = {
        "data": _to_jsonable(data_config),
        "model": _to_jsonable(scene_config),
        "trainer": _to_jsonable(trainer_config),
        "dm": _to_jsonable(dm_config),
    }
    if pvg is not None:
        cfg["pvg"] = _to_jsonable(pvg)
    if deform4d is not None:
        cfg["deform4d"] = _to_jsonable(deform4d)
    with open(out, "w") as f:
        json.dump(cfg, f, indent=2)
    return out


def load_run_config(run_dir: Path):
    from ..data.datamanager import DataManagerConfig
    from ..data.dataparser import DataParserConfig
    from ..models.scene_graph import SceneGraphConfig
    from .trainer import TrainerConfig

    with open(Path(run_dir) / "config.json") as f:
        cfg = json.load(f)
    return (_from_jsonable(DataParserConfig, cfg["data"]),
            _from_jsonable(SceneGraphConfig, cfg["model"]),
            _from_jsonable(TrainerConfig, cfg["trainer"]),
            _from_jsonable(DataManagerConfig, cfg["dm"]))


def _section(run_dir: Path, name: str, cls):
    with open(Path(run_dir) / "config.json") as f:
        cfg = json.load(f)
    return _from_jsonable(cls, cfg[name]) if name in cfg else None


def load_pvg_config(run_dir: Path):
    """The run's models.pvg.PVGConfig, None for another model's run."""
    from ..models.pvg import PVGConfig

    return _section(run_dir, "pvg", PVGConfig)


def load_deform4d_config(run_dir: Path):
    """The run's models.deform4d.Deform4DConfig, None for another model's
    run."""
    from ..models.deform4d import Deform4DConfig

    return _section(run_dir, "deform4d", Deform4DConfig)


def eval_setup(run_dir: Path, checkpoint: Optional[Path] = None,
               device="cuda"):
    """Rebuild the pipeline from a run directory on `device`. Returns a
    Trainer whose state is restored from the latest (or given)
    checkpoint. (The JAX function's `split_all` argument is accepted
    there and read nowhere; the port has none.)"""
    from .checkpoints import latest_checkpoint, restore_checkpoint
    from .trainer import Trainer

    data_config, scene_config, trainer_config, dm_config = load_run_config(
        run_dir)
    # Resume is handled below; no live viewer for an evaluation.
    trainer_config = dataclasses.replace(trainer_config, resume=False,
                                         output_dir=Path(run_dir),
                                         viewer_port=None)
    trainer = Trainer(data_config, scene_config, trainer_config, dm_config,
                      device=device, pvg=load_pvg_config(run_dir),
                      deform4d=load_deform4d_config(run_dir))
    ckpt = checkpoint or latest_checkpoint(Path(run_dir) / "checkpoints")
    if ckpt is not None:
        trainer.state = restore_checkpoint(ckpt, trainer.state)
        trainer.writer.log(f"eval_setup: restored {ckpt}")
    return trainer
