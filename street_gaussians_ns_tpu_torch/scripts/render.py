"""Render a dataset split to image directories or videos (counterpart of
street_gaussians_ns_tpu/scripts/render.py, `sgnt-render`).

Usage:
    python -m street_gaussians_ns_tpu_torch.scripts.render \
        --load-dir outputs/run --output-path renders/ \
        --rendered-output-names rgb depth accumulation background_rgb \
            object_rgb sky gt-rgb \
        [--vehicle-config nvs.json] [--output-format video|images] \
        [--device cuda|cpu]

One output head per name (DatasetRender, render.py:87-284): depth heads
through the turbo colormap with near 0, far 3 (:74-77), gt-* heads from
the batch, per-frame PNGs (Pillow) or mp4 (OpenCV). --vehicle-config
applies a per-camera-regex SE(3) delta to c2w, its translation scaled by
the dataparser scale (_transform_cameras_to_new_vehicle, :286-309).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import re
from pathlib import Path

import numpy as np

from ..engine.setup import eval_setup
from ..utils.optional import opencv, pillow_image

DEPTH_NEAR, DEPTH_FAR = 0.0, 3.0


def apply_colormap(x: np.ndarray, near=DEPTH_NEAR, far=DEPTH_FAR):
    """Turbo colormap (OpenCV) of a depth / accumulation map, in [0, 1]."""
    cv2 = opencv()
    x = np.clip((x - near) / max(far - near, 1e-9), 0, 1)
    x8 = (x * 255).astype(np.uint8)
    return cv2.applyColorMap(x8, cv2.COLORMAP_TURBO)[..., ::-1] / 255.0


def transform_cameras_to_new_vehicle(trainer, vehicle_config: Path):
    """Per-camera-regex SE(3) retarget of c2w (render.py:286-309): the
    delta translation is scaled by the dataparser scale."""
    with open(vehicle_config) as f:
        cfg = json.load(f)
    scene = trainer.scene
    scale = scene.dataparser_scale
    c2w = scene.c2w.copy()
    for i, path in enumerate(scene.image_paths):
        for pattern, mat in cfg.items():
            if re.search(pattern, str(path)):
                delta = np.asarray(mat, np.float32)
                delta44 = np.eye(4, dtype=np.float32)
                delta44[:3, :4] = delta[:3, :4]
                delta44[:3, 3] *= scale
                base = np.concatenate([c2w[i],
                                       [[0, 0, 0, 1]]], 0).astype(np.float32)
                c2w[i] = (base @ delta44)[:3, :4]
    trainer.scene = dataclasses.replace(scene, c2w=c2w)
    # The cached frames carry their own poses.
    for idx, frame in trainer.dm._cache.items():
        frame.c2w = np.asarray(c2w[idx])
    return trainer


def head_image(name: str, outputs: dict, batch: dict) -> np.ndarray:
    """One head of a frame as (H, W, 3) uint8."""
    if name.startswith("gt-"):
        img = np.asarray(batch[name[3:].replace("rgb", "image")])
    else:
        img = outputs[name].detach().cpu().numpy()
    if name == "depth" or name.endswith("_depth"):
        img = apply_colormap(img[..., 0])
    elif img.shape[-1] == 1:
        img = np.repeat(img, 3, axis=-1)
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--load-dir", type=Path, required=True)
    p.add_argument("--load-checkpoint", type=Path, default=None)
    p.add_argument("--output-path", type=Path, required=True)
    p.add_argument("--split", choices=["train", "test", "all"],
                   default="test")
    p.add_argument("--rendered-output-names", nargs="*",
                   default=["rgb", "depth", "accumulation"])
    p.add_argument("--output-format", choices=["video", "images"],
                   default="images")
    p.add_argument("--fps", type=int, default=10)
    p.add_argument("--vehicle-config", type=Path, default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the kernels' "
                        "plain versions)")
    args = p.parse_args(argv)

    trainer = eval_setup(args.load_dir, args.load_checkpoint,
                         device=args.device)
    if args.vehicle_config is not None:
        trainer = transform_cameras_to_new_vehicle(trainer,
                                                   args.vehicle_config)

    loader = (trainer.dm.fixed_indices_train() if args.split == "train"
              else trainer.dm.fixed_indices_eval())
    frames = {name: [] for name in args.rendered_output_names}
    args.output_path.mkdir(parents=True, exist_ok=True)

    for fi, (camera, batch) in enumerate(loader):
        outputs = trainer.render_view(camera, trainer.state,
                                      eval_extras=True)
        for name in args.rendered_output_names:
            img8 = head_image(name, outputs, batch)
            if args.output_format == "images":
                d = args.output_path / name
                d.mkdir(parents=True, exist_ok=True)
                pillow_image().fromarray(img8).save(d / f"{fi:05d}.png")
            else:
                frames[name].append(img8)
        print(f"rendered frame {fi}", flush=True)

    if args.output_format == "video":
        cv2 = opencv()
        for name, imgs in frames.items():
            if not imgs:
                continue
            h, w = imgs[0].shape[:2]
            vw = cv2.VideoWriter(
                str(args.output_path / f"{name}.mp4"),
                cv2.VideoWriter_fourcc(*"mp4v"), args.fps, (w, h))
            for img in imgs:
                vw.write(img[..., ::-1])
            vw.release()
            print(f"wrote {args.output_path / (name + '.mp4')}")
    return trainer


if __name__ == "__main__":
    main()
