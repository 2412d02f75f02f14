"""Train a street-gaussians scene graph on a clip (counterpart of
street_gaussians_ns_tpu/scripts/train.py, `sgnt-train`).

Usage:
    python -m street_gaussians_ns_tpu_torch.scripts.train \
        --data /path/to/clip --trainer.output-dir outputs/run \
        [--trainer.max-num-iterations 30000] [--device cuda|cpu]

Every config field is a dotted flag (utils.cli): the data parser's at the
top level, then --trainer.*, --dm.*, --model.*. The multi-device flags of
the JAX CLI (--mesh-data, --mesh-model, --coordinator, --num-processes,
--process-id) are accepted and raise: the sharded trainer is not ported
yet (ROADMAP.md queue 1 item 9).
"""
from __future__ import annotations

import argparse

from ..data.datamanager import DataManagerConfig
from ..data.dataparser import DataParserConfig
from ..engine.trainer import Trainer, TrainerConfig
from ..models.scene_graph import SceneGraphConfig
from ..utils.cli import add_dataclass_args, dataclass_from_args

MESH_FLAGS = ("mesh_data", "mesh_model", "coordinator", "num_processes",
              "process_id")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    add_dataclass_args(p, DataParserConfig)
    add_dataclass_args(p, TrainerConfig, prefix="trainer.")
    add_dataclass_args(p, DataManagerConfig, prefix="dm.")
    add_dataclass_args(p, SceneGraphConfig, prefix="model.")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (default cuda; cpu runs "
                        "the kernels' plain versions)")
    p.add_argument("--mesh-data", type=int, default=None)
    p.add_argument("--mesh-model", type=int, default=None)
    p.add_argument("--coordinator", type=str, default=None)
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    given = [f"--{f.replace('_', '-')}" for f in MESH_FLAGS
             if getattr(args, f) is not None]
    if given:
        raise NotImplementedError(
            f"{', '.join(given)}: the multi-device trainer (parallel/) is not "
            f"ported yet (ROADMAP.md queue 1 item 9)")
    trainer = Trainer(dataclass_from_args(DataParserConfig, args),
                      dataclass_from_args(SceneGraphConfig, args, "model."),
                      dataclass_from_args(TrainerConfig, args, "trainer."),
                      dataclass_from_args(DataManagerConfig, args, "dm."),
                      device=args.device)
    trainer.train()
    return trainer


if __name__ == "__main__":
    main()
