"""LiDAR sweeps -> colored COLMAP points3D.txt seed points (counterpart of
street_gaussians_ns_tpu/preprocess/pcd2colmap_points3d.py; the per-point
work on the caller's device).

Native equivalent of scripts/pythons/pcd2colmap_points3D.py: per frame,
transform the lidar sweep to world, drop points inside moving-object
boxes (:174-182), randomly downsample to --points-per-frame (default
10000, :164-168), color each point by projecting into the frame's images
(first camera that sees it), and emit COLMAP points3D.txt rows
(id x y z r g b error) with error 0.

The sweep, the box test, the projection and the colour lookup run in
float64 on `--device`; the draw of the subsample stays numpy's
(`subsample_index`), so both packages keep the same points. Poses,
inverses and the formatting of the rows are host numpy, as in the JAX
package. extract_object_pts reuses the device functions.

Usage:
    python -m street_gaussians_ns_tpu_torch.preprocess.pcd2colmap_points3d \
        --data /clip --output /clip/colmap/sparse/0/points3D_lidar.txt \
        [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from ..data.annotations import quat_to_rotmat_np
from ..data.pcd_io import read_pcd
from ..engine.trainer import resolve_device
from ..utils.optional import pillow_image


def _cv_pose(c2w_gl) -> np.ndarray:
    c2w = np.asarray(c2w_gl, np.float64).copy()
    c2w = c2w[np.array([1, 0, 2, 3]), :]
    c2w[2, :] *= -1
    c2w[0:3, 1:3] *= -1
    return c2w


def load_rgb(path: Path, device) -> torch.Tensor:
    """(H, W, 3) uint8 on `device`, decoded by Pillow."""
    img = np.asarray(pillow_image().open(path).convert("RGB"))
    return torch.from_numpy(img.copy()).to(device)


def sweep_to_world(pcd_path: Path, transform_matrix, device) -> torch.Tensor:
    """The sweep's float32 points in float64 world coordinates, (P, 3) on
    `device`."""
    xyz, _ = read_pcd(pcd_path)
    pose = torch.as_tensor(np.asarray(transform_matrix, np.float64),
                           device=device)
    pts = torch.from_numpy(xyz).to(device, torch.float64)
    return pts @ pose[:3, :3].T + pose[:3, 3]


def points_in_boxes(pts: torch.Tensor, boxes: List[dict],
                    inflate: float = 1.0) -> torch.Tensor:
    """(O, P) bool: point p lies in box o, each box scaled by `inflate`
    about its centre. One batched test of the JAX package's
    points_in_box(pts, translation, lwh, rotation_wxyz, inflate)."""
    if not boxes:
        return torch.zeros((0, len(pts)), dtype=torch.bool,
                           device=pts.device)
    f64 = dict(dtype=torch.float64, device=pts.device)
    R = torch.as_tensor(np.stack([
        quat_to_rotmat_np(np.asarray(b["rotation"], np.float64))
        for b in boxes]), **f64)
    t = torch.as_tensor(np.stack([np.asarray(b["translation"], np.float64)
                                  for b in boxes]), **f64)
    half = torch.as_tensor(np.stack([np.asarray(b["size"]) * 0.5 * inflate
                                     for b in boxes]), **f64)
    local = torch.bmm(pts[None] - t[:, None], R)
    return (local.abs() <= half[:, None]).all(-1)


def subsample_index(rng: np.random.RandomState, n: int, k: int,
                    device) -> Optional[torch.Tensor]:
    """The JAX package's draw, `rng.choice(n, k, replace=False)` on the
    host, as an index on `device`; None when n <= k (every point kept).
    A torch generator would keep other points."""
    if n <= k:
        return None
    return torch.from_numpy(rng.choice(n, k, replace=False)).to(device)


def project_colors(pts: torch.Tensor, frames: List[dict],
                   images: List[torch.Tensor]) -> torch.Tensor:
    """(P, 3) uint8 colours of world points: the pixel of the first frame
    whose camera sees the point (z > 0.1, inside the image), else 128.
    u and v truncate toward zero as numpy's astype(int) does; the
    arithmetic keeps the JAX package's order, (x / z) * f + c."""
    colors = torch.full((len(pts), 3), 128, dtype=torch.uint8,
                        device=pts.device)
    seen = torch.zeros(len(pts), dtype=torch.bool, device=pts.device)
    for fr, img in zip(frames, images):
        h, w = img.shape[:2]
        w2c = torch.as_tensor(np.linalg.inv(_cv_pose(fr["transform_matrix"])),
                              device=pts.device)
        cam = pts @ w2c[:3, :3].T + w2c[:3, 3]
        z = torch.clamp_min(cam[:, 2], 1e-6)
        u = (cam[:, 0] / z * float(fr["fl_x"]) + float(fr["cx"])).long()
        v = (cam[:, 1] / z * float(fr["fl_y"]) + float(fr["cy"])).long()
        vis = ((cam[:, 2] > 0.1) & (u >= 0) & (u < w) & (v >= 0) & (v < h)
               & ~seen)
        px = img[v.clamp(0, h - 1), u.clamp(0, w - 1), :3]
        colors = torch.where(vis[:, None], px, colors)
        seen |= vis
    return colors


def frame_images(data: Path, frames: List[dict], device):
    """The frames whose image exists, and their images on `device`."""
    kept = [fr for fr in frames if (data / fr["file_path"]).exists()]
    return kept, [load_rgb(data / fr["file_path"], device) for fr in kept]


def cameras_by_timestamp(meta: dict) -> dict:
    by_ts = {}
    for f in meta["frames"]:
        if "fl_x" in f:
            by_ts.setdefault(round(float(f["timestamp"]), 6), []).append(f)
    return by_ts


def convert(data: Path, output: Path, points_per_frame: int = 10000,
            seed: int = 0, device="cuda") -> int:
    device = resolve_device(device)
    meta = json.load(open(data / "transform.json"))
    annos = json.load(open(data / "annotation.json"))["frames"] \
        if (data / "annotation.json").exists() else []
    anno_by_ts = {round(float(a["timestamp"]), 6): a["objects"]
                  for a in annos}

    lidar_frames = meta.get("lidar_frames", []) or [
        f for f in meta["frames"] if f.get("type") == "lidar"
        or str(f.get("file_path", "")).startswith("lidars/")]
    by_ts = cameras_by_timestamp(meta)

    rng = np.random.RandomState(seed)
    rows = []
    pid = 1
    for lf in lidar_frames:
        pcd_path = data / lf["file_path"]
        if not pcd_path.exists():
            continue
        world = sweep_to_world(pcd_path, lf["transform_matrix"], device)
        ts = round(float(lf["timestamp"]), 6)
        moving = [o for o in anno_by_ts.get(ts, []) if o.get("is_moving")]
        # Removing the union of the boxes keeps the points, and their
        # order, that removing one box after another keeps.
        world = world[~points_in_boxes(world, moving).any(0)]
        keep = subsample_index(rng, len(world), points_per_frame, device)
        if keep is not None:
            world = world[keep]
        colors = project_colors(world,
                                *frame_images(data, by_ts.get(ts, []),
                                              device))
        for p, c in zip(world.cpu().tolist(), colors.cpu().tolist()):
            rows.append(f"{pid} {p[0]} {p[1]} {p[2]} {c[0]} {c[1]} {c[2]} 0")
            pid += 1

    output.parent.mkdir(parents=True, exist_ok=True)
    output.write_text("\n".join(rows) + ("\n" if rows else ""))
    return pid - 1


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data", type=Path, required=True)
    p.add_argument("--output", type=Path, required=True)
    p.add_argument("--points-per-frame", type=int, default=10000)
    p.add_argument("--device", default="cuda",
                   help="torch device of the per-point work (default cuda; "
                        "cpu runs it on the host)")
    args = p.parse_args(argv)
    n = convert(args.data, args.output, args.points_per_frame,
                device=args.device)
    print(f"wrote {n} points -> {args.output}")
    return n


if __name__ == "__main__":
    main()
