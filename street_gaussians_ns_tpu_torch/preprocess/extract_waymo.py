"""Waymo Open Dataset TFRecord -> clip directory extraction (counterpart
of street_gaussians_ns_tpu/preprocess/extract_waymo.py, a copy).

Native equivalent of scripts/pythons/extract_waymo.py (C15): per segment,
writes images/<CAMERA>/<lidar_ts>.jpg, lidars/lidar_<NAME>/<ts>.pcd (both
returns merged), transform.json (camera frames with intrinsics/distortion
+ nerfstudio/blender poses, lidar frames with ego pose), and
annotation.json (laser-label boxes in world frame, wxyz quats,
is_moving = speed > 0.2 m/s), multiprocessing over segments.

Pose math replicated exactly: camera extrinsic rotated by the
waymo->opencv swap [[0,0,1],[-1,0,0],[0,-1,0]] (:150-151), c2w = ego_pose
@ extrinsic then OpenCV->blender (y/z flip + axis permute + z negate,
:194-198).

Requires waymo_open_dataset + tensorflow, which the package does not
depend on: they are imported at use, and _require_waymo raises a clear
error without them; the downstream layout contract is
what the rest of the pipeline (and the synthetic test fixtures) build on.
"""
from __future__ import annotations

import argparse
import json
import multiprocessing
from pathlib import Path

import numpy as np

from ..data.pcd_io import write_pcd

MIN_MOVING_SPEED = 0.2
OPENCV2WAYMO = np.array([[0, 0, 1], [-1, 0, 0], [0, -1, 0]], np.float64)
BOX_TYPES = {0: "unknown", 1: "car", 2: "pedestrian", 3: "sign",
             4: "cyclist"}


def _require_waymo():
    try:
        import tensorflow as tf  # noqa: F401
        from waymo_open_dataset import dataset_pb2  # noqa: F401
        from waymo_open_dataset.utils import frame_utils  # noqa: F401
    except ImportError as e:
        raise RuntimeError(
            "extract_waymo needs tensorflow + waymo_open_dataset (offline "
            "data-prep dependencies not bundled with the training "
            "stack); run this step in a Waymo tooling environment"
        ) from e
    return tf, dataset_pb2, frame_utils


def blender_pose(ego_pose: np.ndarray, extrinsic_cv: np.ndarray
                 ) -> np.ndarray:
    """OpenCV c2w -> nerfstudio/blender convention (extract_waymo:194-198)."""
    c2w = ego_pose @ extrinsic_cv
    c2w[0:3, 1:3] *= -1
    c2w = c2w[np.array([1, 0, 2, 3]), :]
    c2w[2, :] *= -1
    return c2w


def extract_segment(tfrecord: Path, out_root: Path) -> Path:
    tf, dataset_pb2, frame_utils = _require_waymo()
    from scipy.spatial.transform import Rotation as R

    seg_dir = out_root / tfrecord.stem.replace(".tfrecord", "")
    seg_dir.mkdir(parents=True, exist_ok=True)

    frames_meta = []
    lidar_meta = []
    anno_frames = []
    dataset = tf.data.TFRecordDataset(str(tfrecord), compression_type="")
    sensor_params = None
    for raw in dataset:
        frame = dataset_pb2.Frame()
        frame.ParseFromString(bytearray(raw.numpy()))
        ts = frame.timestamp_micros

        if sensor_params is None:
            sensor_params = {}
            for calib in frame.context.camera_calibrations:
                name = dataset_pb2.CameraName.Name.Name(calib.name)
                ext = np.array(calib.extrinsic.transform).reshape(4, 4)
                ext[:3, :3] = ext[:3, :3] @ OPENCV2WAYMO
                sensor_params[name] = dict(
                    intrinsic=list(calib.intrinsic), extrinsic=ext,
                    width=calib.width, height=calib.height)

        for image_data in frame.images:
            name = dataset_pb2.CameraName.Name.Name(image_data.name)
            path = seg_dir / "images" / name / f"{ts}.jpg"
            path.parent.mkdir(parents=True, exist_ok=True)
            path.write_bytes(image_data.image)
            p = sensor_params[name]
            fx, fy, cx, cy = p["intrinsic"][:4]
            d = p["intrinsic"][4:]
            ego = np.array(image_data.pose.transform).reshape(4, 4)
            frames_meta.append({
                "file_path": path.relative_to(seg_dir).as_posix(),
                "fl_x": fx, "fl_y": fy, "cx": cx, "cy": cy,
                "w": p["width"], "h": p["height"],
                "camera_model": "OPENCV", "camera": name,
                "timestamp": ts / 1e6,
                "k1": d[0], "k2": d[1], "k3": d[4], "k4": 0.0,
                "p1": d[2], "p2": d[3],
                "transform_matrix": blender_pose(ego, p["extrinsic"]
                                                 ).tolist(),
            })

        pose = np.array(frame.pose.transform).reshape(4, 4)
        ri, cp, _, ri_pose = frame_utils.parse_range_image_and_camera_projection(frame)
        pts0, _ = frame_utils.convert_range_image_to_point_cloud(
            frame, ri, cp, ri_pose)
        pts1, _ = frame_utils.convert_range_image_to_point_cloud(
            frame, ri, cp, ri_pose, ri_index=1)
        merged = [np.concatenate([a, b]) for a, b in zip(pts0, pts1)]
        lidar_ids = sorted(c.name for c in frame.context.laser_calibrations)
        for lid, pts in zip(lidar_ids, merged):
            name = "lidar_" + dataset_pb2.LaserName.Name.Name(lid)
            path = seg_dir / "lidars" / name / f"{ts}.pcd"
            path.parent.mkdir(parents=True, exist_ok=True)
            write_pcd(path, pts.astype(np.float32))
            lidar_meta.append({
                "file_path": path.relative_to(seg_dir).as_posix(),
                "lidar": name, "timestamp": ts / 1e6,
                "transform_matrix": pose.tolist(),
            })

        objects = []
        for label in frame.laser_labels:
            center = pose @ np.array([label.box.center_x, label.box.center_y,
                                      label.box.center_z, 1.0])
            rot = pose[:3, :3] @ R.from_euler(
                "xyz", [0, 0, label.box.heading]).as_matrix()
            q = R.from_matrix(rot).as_quat()  # xyzw
            speed = float(np.hypot(np.hypot(label.metadata.speed_x,
                                            label.metadata.speed_y),
                                   label.metadata.speed_z))
            objects.append({
                "type": BOX_TYPES.get(label.type, "unknown"),
                "gid": label.id,
                "translation": center[:3].tolist(),
                "size": [label.box.length, label.box.width,
                         label.box.height],
                "rotation": [q[3], q[0], q[1], q[2]],
                "is_moving": bool(speed > MIN_MOVING_SPEED),
            })
        anno_frames.append({"timestamp": ts / 1e6, "objects": objects})

    json.dump({"frames": frames_meta, "lidar_frames": lidar_meta},
              open(seg_dir / "transform.json", "w"))
    json.dump({"frames": anno_frames},
              open(seg_dir / "annotation.json", "w"))
    return seg_dir


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--tfrecords", type=Path, nargs="+", required=True)
    p.add_argument("--out", type=Path, required=True)
    p.add_argument("--workers", type=int, default=4)
    args = p.parse_args(argv)
    _require_waymo()
    with multiprocessing.get_context("spawn").Pool(args.workers) as pool:
        done = pool.starmap(extract_segment,
                            [(t, args.out) for t in args.tfrecords])
    for d in done:
        print("extracted", d)


if __name__ == "__main__":
    main()
