"""Per-object aggregated LiDAR seeds: aggregate_lidar/dynamic_objects/<gid>.ply
(counterpart of street_gaussians_ns_tpu/preprocess/extract_object_pts.py;
the per-point work on the caller's device).

Native equivalent of scripts/pythons/extract_object_pts.py: for each
moving car, per frame crop the LiDAR sweep inside its 1.1x-inflated box,
color the crop by image projection, transform to the OBJECT frame (w2o,
:237-260), accumulate across frames, write one ply per track (:264-273) —
the seed clouds the scene graph's object models are initialized from
(dynamic_annotation.py:348-365).

One (O, P) box test a frame (pcd2colmap_points3d.points_in_boxes), one
projection a frame over every object's crop at once (a point's colour
depends on that point alone), on `--device` in float64; the frames and
objects keep the JAX package's order, so each ply holds its rows in its
order.

Usage:
    python -m street_gaussians_ns_tpu_torch.preprocess.extract_object_pts \
        --data /clip [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from ..data.annotations import quat_to_rotmat_np
from ..data.ply_io import write_ply
from ..engine.trainer import resolve_device
from .pcd2colmap_points3d import (cameras_by_timestamp, frame_images,
                                  points_in_boxes, project_colors,
                                  sweep_to_world)

INFLATE = 1.1


def extract(data: Path, filter_label=("car",), device="cuda") -> int:
    device = resolve_device(device)
    meta = json.load(open(data / "transform.json"))
    annos = json.load(open(data / "annotation.json"))["frames"]
    out_dir = data / "aggregate_lidar" / "dynamic_objects"
    out_dir.mkdir(parents=True, exist_ok=True)

    cam_by_ts = cameras_by_timestamp(meta)
    lidar_frames = meta.get("lidar_frames", []) or [
        f for f in meta["frames"]
        if str(f.get("file_path", "")).startswith("lidars/")]
    lidar_by_ts = {round(float(f["timestamp"]), 6): f for f in lidar_frames}

    per_object = {}
    for frame in annos:
        ts = round(float(frame["timestamp"]), 6)
        lf = lidar_by_ts.get(ts)
        if lf is None:
            continue
        pcd_path = data / lf["file_path"]
        if not pcd_path.exists():
            continue
        world = sweep_to_world(pcd_path, lf["transform_matrix"], device)
        objs = [o for o in frame["objects"]
                if (o.get("type", "") in filter_label
                    or o.get("type", "").endswith("Car"))
                and o.get("is_moving")]
        inside = points_in_boxes(world, objs, inflate=INFLATE)
        counts = inside.sum(1).tolist()
        if not any(counts):
            continue
        # Every object's crop, object after object, each in sweep order.
        obj_idx, pt_idx = inside.nonzero(as_tuple=True)
        crops = world[pt_idx]
        colors = project_colors(crops,
                                *frame_images(data, cam_by_ts.get(ts, []),
                                              device))
        for obj, crop, col in zip(objs, crops.split(counts),
                                  colors.split(counts)):
            if not len(crop):
                continue
            # world -> object frame (w2o).
            R = torch.as_tensor(
                quat_to_rotmat_np(np.asarray(obj["rotation"], np.float64)),
                device=device)
            t = torch.as_tensor(np.asarray(obj["translation"], np.float64),
                                device=device)
            acc = per_object.setdefault(str(obj["gid"]), ([], []))
            acc[0].append(((crop - t) @ R).to(torch.float32))
            acc[1].append(col)

    for gid, (pts_list, col_list) in per_object.items():
        pts = torch.cat(pts_list).cpu().numpy()
        cols = torch.cat(col_list).cpu().numpy()
        write_ply(out_dir / f"{gid}.ply", {
            "x": pts[:, 0], "y": pts[:, 1], "z": pts[:, 2],
            "red": cols[:, 0], "green": cols[:, 1], "blue": cols[:, 2]})
        print(f"object {gid}: {len(pts)} pts")
    return len(per_object)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data", type=Path, required=True)
    p.add_argument("--device", default="cuda",
                   help="torch device of the per-point work (default cuda; "
                        "cpu runs it on the host)")
    args = p.parse_args(argv)
    n = extract(args.data, device=args.device)
    print(f"wrote {n} object point clouds")
    return n


if __name__ == "__main__":
    main()
