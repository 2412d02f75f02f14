"""Average eval metrics over the eval split (counterpart of
street_gaussians_ns_tpu/scripts/eval.py, `sgnt-eval`).

Usage:
    python -m street_gaussians_ns_tpu_torch.scripts.eval \
        --load-dir outputs/run [--output-path outputs/run/eval_output.json] \
        [--device cuda|cpu]

Renders every eval image (`Trainer.render_view`: forward_scene with
training=False, or the PVG model's forward at the image's time), averages PSNR,
SSIM and LPIPS (a seeded random-feature VGG unless --lpips-weights names
an .npz), adds num_rays_per_sec / fps, and writes mean and std to
eval_output.json in the reference's format (eval.py:56-64, :116-128). A
frame is timed up to the host copy of its rgb, which waits for the card,
so fps is the card's frame time plus that copy, as in the JAX package.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from ..engine.setup import eval_setup
from ..ops.ssim import psnr, ssim


@torch.no_grad()
def evaluate(trainer, lpips_weights=None, compute_lpips=True):
    lpips_fn = None
    if lpips_weights is not None:
        from ..ops.lpips import load_lpips
        lpips_fn = load_lpips(lpips_weights, device=trainer.device)
    elif compute_lpips:
        from ..ops.lpips import random_lpips
        lpips_fn = random_lpips(device=trainer.device)

    rows = []
    for camera, batch in trainer.dm.fixed_indices_eval():
        t0 = time.time()
        outputs = trainer.render_view(camera, trainer.state)
        outputs["rgb"].cpu()
        dt = time.time() - t0
        gt = torch.as_tensor(batch["image"]).to(trainer.device)
        n_rays = camera.height * camera.width
        row = {
            "psnr": float(psnr(outputs["rgb"], gt)),
            "ssim": float(ssim(gt, outputs["rgb"])),
            "num_rays_per_sec": n_rays / dt,
            "fps": 1.0 / dt,
        }
        if lpips_fn is not None:
            row["lpips"] = float(lpips_fn(outputs["rgb"], gt))
        rows.append(row)

    results = {}
    for k in rows[0]:
        vals = np.array([r[k] for r in rows])
        results[k] = float(vals.mean())
        results[f"{k}_std"] = float(vals.std())
    return results


def _chamfer(trainer, lidar_path=None):
    """LiDAR-vs-background-means chamfer in model space (the reference's
    geometric eval, geometric_metric.py:72-100)."""
    from ..ops.chamfer import evaluate_lidar_geometric

    scene = trainer.scene
    path = lidar_path or (Path(trainer.data_config.data)
                          / "aggregate_lidar" / "output.ply")
    if not Path(path).exists():
        print(f"chamfer: no aggregate lidar at {path}, skipping")
        return {}
    if str(path).endswith(".pcd"):
        from ..data.pcd_io import read_pcd
        pts, _ = read_pcd(Path(path))
    else:
        from ..data.ply_io import read_ply_points
        pts, _ = read_ply_points(Path(path))
    store = trainer.state.store
    store = getattr(store, "background", store)     # PVG: the one cloud
    act = store.active.cpu().numpy()
    means = store.params.means.detach().cpu().numpy()[act]
    return evaluate_lidar_geometric(
        means, pts, scene.transform_matrix, scene.dataparser_scale,
        applied_translation=scene.applied_translation_in_colmap,
        device=trainer.device)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--load-dir", type=Path, required=True,
                   help="run directory containing config.json + checkpoints")
    p.add_argument("--load-checkpoint", type=Path, default=None)
    p.add_argument("--output-path", type=Path, default=None)
    p.add_argument("--lpips-weights", type=Path, default=None,
                   help=".npz of VGG16/LPIPS weights (see ops/lpips.py); "
                        "without it a seeded random-feature VGG is used")
    p.add_argument("--no-lpips", action="store_true",
                   help="skip lpips entirely")
    p.add_argument("--compute-chamfer", action="store_true",
                   help="LiDAR-vs-means chamfer distance "
                        "(geometric_metric.py:72-100)")
    p.add_argument("--aggregate-lidar", type=Path, default=None,
                   help="aggregate LiDAR ply/pcd (default "
                        "<data>/aggregate_lidar/output.ply)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the kernels' "
                        "plain versions)")
    args = p.parse_args(argv)

    trainer = eval_setup(args.load_dir, args.load_checkpoint,
                         device=args.device)
    results = evaluate(trainer, args.lpips_weights,
                       compute_lpips=not args.no_lpips)
    if args.compute_chamfer:
        results.update(_chamfer(trainer, args.aggregate_lidar))
    out = {
        "experiment_name": str(args.load_dir),
        "method_name": "street-gaussians-ns-tpu",
        "checkpoint": str(args.load_checkpoint or "latest"),
        "lpips_net": ("none" if args.no_lpips else
                      "vgg16-pretrained" if args.lpips_weights
                      else "vgg16-random-features-seed0"),
        "results": results,
    }
    out_path = args.output_path or (Path(args.load_dir) / "eval_output.json")
    with open(out_path, "w") as f:
        json.dump(out, f, indent=2)
    print(json.dumps(out["results"], indent=2))
    return out


if __name__ == "__main__":
    main()
