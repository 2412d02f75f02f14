"""Write Inria-compatible 3DGS .ply files, one per submodel (counterpart of
street_gaussians_ns_tpu/scripts/export.py, `sgnt-export`).

Usage:
    python -m street_gaussians_ns_tpu_torch.scripts.export \
        --load-dir outputs/run --output-dir exports/ [--device cuda|cpu]

ExportGaussianSplat (exporter.py:44-135): point_cloud_background.ply and
point_cloud_object_<gid>.ply, the active gaussians in the Inria field
layout with NaN/Inf rows dropped (data.ply_io.write_gaussian_ply). A
4D Gaussian Splatting run (models.deform4d) writes its canonical cloud as
the background and its deformation field as deformation_field.npz: the
flat planes and decoder, the box and the time span, and the field's
config as JSON ("config").
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path

import numpy as np
import torch

from ..data.ply_io import write_gaussian_ply
from ..engine.setup import eval_setup
from ..models.fourier import fourier_dc


def export_store(path: Path, params, active, name: str) -> int:
    """Write one submodel's active gaussians; returns the rows written.
    The Fourier DC is collapsed at t = 0 for the static export."""
    def host(t):
        return t.detach().cpu().numpy()

    act = host(active)
    dc = host(fourier_dc(params.features_dc,
                         torch.zeros((), device=params.features_dc.device)))
    n = write_gaussian_ply(
        path,
        host(params.means)[act],
        dc[act],
        host(params.features_rest)[act],
        host(params.opacities)[act, 0],
        host(params.scales)[act],
        host(params.quats)[act],
    )
    print(f"wrote {n} gaussians -> {path}")
    return n


def export_field(path: Path, field: dict, config) -> int:
    """Write a deformation field's tensors and config; returns the trained
    floats written (planes and decoder)."""
    arrays = {k: v.detach().cpu().numpy() for k, v in field.items()}
    np.savez(path, config=np.asarray(json.dumps(dataclasses.asdict(config))),
             **arrays)
    n = int(arrays["planes"].size + arrays["decoder"].size)
    print(f"wrote a deformation field of {n} floats -> {path}")
    return n


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--load-dir", type=Path, required=True)
    p.add_argument("--load-checkpoint", type=Path, default=None)
    p.add_argument("--output-dir", type=Path, required=True)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda)")
    args = p.parse_args(argv)

    trainer = eval_setup(args.load_dir, args.load_checkpoint,
                         device=args.device)
    args.output_dir.mkdir(parents=True, exist_ok=True)
    store = trainer.state.store
    bg = getattr(store, "background", store)     # PVG: the one cloud
    counts = {"background": export_store(
        args.output_dir / "point_cloud_background.ply", bg.params, bg.active,
        "background")}
    db = trainer.scene.annotations
    if trainer.deform4d is not None:
        counts["field"] = export_field(
            args.output_dir / "deformation_field.npz", trainer.state.field,
            trainer.deform4d)
    if db is not None and not trainer.single_cloud:
        for i, gid in enumerate(db.track_ids):
            params_i = type(store.objects.params)(**{
                k: v[i] for k, v in store.objects.params.as_dict().items()})
            counts[f"object_{gid}"] = export_store(
                args.output_dir / f"point_cloud_object_{gid}.ply",
                params_i, store.objects.active[i], f"object_{gid}")
    return counts


if __name__ == "__main__":
    main()
