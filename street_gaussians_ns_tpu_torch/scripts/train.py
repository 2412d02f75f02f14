"""Train a street-gaussians scene graph on a clip (counterpart of
street_gaussians_ns_tpu/scripts/train.py, `sgnt-train`).

Usage:
    python -m street_gaussians_ns_tpu_torch.scripts.train \
        --data /path/to/clip --trainer.output-dir outputs/run \
        [--trainer.max-num-iterations 30000] [--device cuda|cpu]

Every config field is a dotted flag (utils.cli): the data parser's at the
top level, then --trainer.*, --dm.*, --model.*. `--method pvg` trains
the Periodic Vibration Gaussian model (models.pvg; its own fields are
--pvg.*) on one device instead of the scene graph, `--method deform4d`
4D Gaussian Splatting (models.deform4d; its fields are --deform4d.*).
Any of --mesh-data,
--mesh-model or --coordinator trains with the multi-device trainer
(parallel.trainer.ShardedTrainer) instead: one process per rank, each
started with the same flags and its own --process-id, all pointing at one
--coordinator host:port (a world of one process needs none), e.g. two
model columns on the CPU:

    python -m street_gaussians_ns_tpu_torch.scripts.train ... --device cpu \
        --mesh-model 2 --num-processes 2 --process-id 0 \
        --coordinator 127.0.0.1:29500          (and --process-id 1)

The backend follows --device: NCCL on the card, gloo on the CPU. With
--trainer.viewer-port set on every process, the process with --process-id 0
serves the live viewer (parallel.trainer.ShardedTrainer) and logs its URL;
the others bind no port.
"""
from __future__ import annotations

import argparse

import torch

from ..data.datamanager import DataManagerConfig
from ..data.dataparser import DataParserConfig
from ..engine.trainer import Trainer, TrainerConfig
from ..models.deform4d import Deform4DConfig
from ..models.pvg import PVGConfig
from ..models.scene_graph import SceneGraphConfig
from ..utils.cli import add_dataclass_args, dataclass_from_args

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    add_dataclass_args(p, DataParserConfig)
    add_dataclass_args(p, TrainerConfig, prefix="trainer.")
    add_dataclass_args(p, DataManagerConfig, prefix="dm.")
    add_dataclass_args(p, SceneGraphConfig, prefix="model.")
    p.add_argument("--method", choices=("scene_graph", "pvg", "deform4d"),
                   default="scene_graph",
                   help="the model to train (default the scene graph; pvg: "
                        "Periodic Vibration Gaussians, models.pvg; "
                        "deform4d: 4D Gaussian Splatting, models.deform4d)")
    add_dataclass_args(p, PVGConfig, prefix="pvg.")
    add_dataclass_args(p, Deform4DConfig, prefix="deform4d.")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (default cuda; cpu runs "
                        "the kernels' plain versions)")
    p.add_argument("--mesh-data", type=int, default=None,
                   help="data rows of the mesh (cameras per step)")
    p.add_argument("--mesh-model", type=int, default=None,
                   help="model columns of the mesh (background shards)")
    p.add_argument("--coordinator", type=str, default=None,
                   help="host:port of the process group's rendezvous")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    configs = (dataclass_from_args(DataParserConfig, args),
               dataclass_from_args(SceneGraphConfig, args, "model."),
               dataclass_from_args(TrainerConfig, args, "trainer."),
               dataclass_from_args(DataManagerConfig, args, "dm."))
    sharded = (args.mesh_data is not None or args.mesh_model is not None
               or args.coordinator is not None)
    pvg = (dataclass_from_args(PVGConfig, args, "pvg.")
           if args.method == "pvg" else None)
    deform4d = (dataclass_from_args(Deform4DConfig, args, "deform4d.")
                if args.method == "deform4d" else None)
    if sharded and args.method != "scene_graph":
        raise SystemExit(f"--method {args.method} trains on one device: the "
                         f"multi-device trainer trains the scene graph")
    if sharded:
        from ..parallel.trainer import ShardedTrainer

        trainer = ShardedTrainer(
            *configs, mesh_data=args.mesh_data, mesh_model=args.mesh_model,
            coordinator=args.coordinator, num_processes=args.num_processes,
            process_id=args.process_id, device=args.device)
    else:
        trainer = Trainer(*configs, device=args.device, pvg=pvg,
                          deform4d=deform4d)
    trainer.train()
    if sharded:
        torch.distributed.destroy_process_group()
    return trainer


if __name__ == "__main__":
    main()
