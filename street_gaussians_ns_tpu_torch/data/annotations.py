"""annotation.json -> tracked-box database + ObjectTracks tensors
(counterpart of street_gaussians_ns_tpu/data/annotations.py; the tracks
are the port's models.scene_graph.ObjectTracks, on the caller's device).

Host-side (numpy) port of InterpolatedAnnotation
(the reference's data/utils/dynamic_annotation.py:213-388):
  * keeps boxes labeled 'car' (or *Car) that are moving (:19, :314),
  * requires the per-object aggregated LiDAR ply with >= 10k points (:356),
  * inflates box sizes by EXP_RATE = [1.3, 1.3, 1.1] (:22, :329),
  * world-transforms + scales boxes into model space (:332-334) using the
    dataparser transform composed with the COLMAP translation compensation
    (sgn_dataparser.py:445-457),
  * canonical size/meta = first appearance; per-track frame list feeds the
    Fourier time normalization (:337-344).

The interpolation (SLERP/lerp between bracketing frames) lives in
models.scene_graph.interpolate_boxes; this module only builds its inputs.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models.scene_graph import ObjectTracks, empty_tracks
from .ply_io import read_ply_points

FILTER_LABEL = ("car",)
EXP_RATE = np.array([1.3, 1.3, 1.1])
MIN_SEED_POINTS = 10000


def parse_timestamp(timestamp, digits: int = 16) -> int:
    """Normalize to a 16-digit integer key (dynamic_annotation.py:90-96)."""
    if isinstance(timestamp, str):
        timestamp = float(timestamp)
    s = str(int(timestamp))
    return int(timestamp * 10 ** (digits - len(s)))


def quat_to_rotmat_np(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def rotmat_to_quat_np(m: np.ndarray) -> np.ndarray:
    tr = np.trace(m)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        q = [0.25 * s, (m[2, 1] - m[1, 2]) / s, (m[0, 2] - m[2, 0]) / s,
             (m[1, 0] - m[0, 1]) / s]
    elif m[0, 0] > m[1, 1] and m[0, 0] > m[2, 2]:
        s = np.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2]) * 2
        q = [(m[2, 1] - m[1, 2]) / s, 0.25 * s, (m[0, 1] + m[1, 0]) / s,
             (m[0, 2] + m[2, 0]) / s]
    elif m[1, 1] > m[2, 2]:
        s = np.sqrt(1.0 + m[1, 1] - m[0, 0] - m[2, 2]) * 2
        q = [(m[0, 2] - m[2, 0]) / s, (m[0, 1] + m[1, 0]) / s, 0.25 * s,
             (m[1, 2] + m[2, 1]) / s]
    else:
        s = np.sqrt(1.0 + m[2, 2] - m[0, 0] - m[1, 1]) * 2
        q = [(m[1, 0] - m[0, 1]) / s, (m[0, 2] + m[2, 0]) / s,
             (m[1, 2] + m[2, 1]) / s, 0.25 * s]
    q = np.asarray(q)
    return q / np.linalg.norm(q)


@dataclasses.dataclass
class AnnotationDB:
    """Parsed, transformed annotation database (host side)."""

    track_ids: List[str]                       # O object gids, stable order
    timestamps: np.ndarray                     # (F,) int64 16-digit keys
    centers: np.ndarray                        # (F, O, 3)
    quats: np.ndarray                          # (F, O, 4) wxyz
    valid: np.ndarray                          # (F, O) bool
    sizes: np.ndarray                          # (O, 3) canonical, inflated
    frames_per_track: Dict[str, List[int]]     # gid -> frame indices present
    seed_points: Dict[str, Tuple[np.ndarray, np.ndarray]]  # gid -> (xyz, rgb)

    @property
    def num_objects(self) -> int:
        return len(self.track_ids)


def load_annotations(
    anno_json_path: Optional[Path],
    lidar_path: Optional[Path] = None,
    transform_matrix: Optional[np.ndarray] = None,
    scale_factor: float = 1.0,
    time_offset: Optional[int] = None,
    time_scale: float = 1e-6,
    device="cuda",
) -> Tuple[AnnotationDB, ObjectTracks]:
    """Parse annotation.json into an AnnotationDB + ObjectTracks on
    `device`.

    Camera/track times are expressed as (timestamp16 - time_offset) *
    time_scale (microsecond resolution fits f32 for clip-length windows);
    the data parser uses the same mapping for Camera.time so lookups align.
    """
    tm = np.eye(4) if transform_matrix is None else np.asarray(transform_matrix)
    if anno_json_path is None or not Path(anno_json_path).exists():
        return (AnnotationDB([], np.zeros(0, np.int64),
                             np.zeros((0, 0, 3)), np.zeros((0, 0, 4)),
                             np.zeros((0, 0), bool), np.zeros((0, 3)), {}, {}),
                empty_tracks(device=device))

    frames = json.load(open(anno_json_path))["frames"]
    frames = sorted(frames, key=lambda x: parse_timestamp(x["timestamp"]))

    # First pass: find qualifying tracks (label, moving, seed points).
    seed_points: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}

    def qualify(obj) -> bool:
        typ = obj.get("type", "")
        if typ not in FILTER_LABEL and not typ.endswith("Car"):
            return False
        if not obj.get("is_moving", False):
            return False
        gid = str(obj["gid"])
        if gid in seed_points:
            return True
        if lidar_path is None:
            return False
        ply = Path(lidar_path) / f"{gid}.ply"
        if not ply.exists():
            return False
        xyz, rgb = read_ply_points(ply)
        if xyz.shape[0] < MIN_SEED_POINTS:
            return False
        if rgb is None:
            rgb = np.random.RandomState(0).rand(xyz.shape[0], 3) * 255.0
        seed_points[gid] = (xyz * scale_factor, rgb)
        return True

    track_ids: List[str] = []
    sizes: Dict[str, np.ndarray] = {}
    frames_per_track: Dict[str, List[int]] = {}
    per_frame: List[Dict[str, tuple]] = []
    timestamps = []

    for f_idx, item in enumerate(frames):
        ts = parse_timestamp(item["timestamp"])
        timestamps.append(ts)
        boxes_here: Dict[str, tuple] = {}
        for obj in item.get("objects", []):
            if not qualify(obj):
                continue
            gid = str(obj["gid"])
            center = np.asarray(obj["translation"], np.float64)
            q = np.asarray(obj["rotation"], np.float64)  # wxyz
            rot = quat_to_rotmat_np(q)
            size = EXP_RATE * np.asarray(obj["size"], np.float64)
            # world transform + scale (Box.transform/scale, :189-196)
            center = tm[:3, :3] @ center + tm[:3, 3]
            rot = tm[:3, :3] @ rot
            center = center * scale_factor
            size = size * scale_factor
            boxes_here[gid] = (center, rotmat_to_quat_np(rot), size)
            if gid not in sizes:
                track_ids.append(gid)
                sizes[gid] = size        # first box = canonical meta (:337)
                frames_per_track[gid] = []
            frames_per_track[gid].append(f_idx)
        per_frame.append(boxes_here)

    F, O = len(frames), len(track_ids)
    centers = np.zeros((F, O, 3), np.float32)
    quats = np.tile(np.array([1.0, 0, 0, 0], np.float32), (F, O, 1))
    valid = np.zeros((F, O), bool)
    for f_idx, boxes_here in enumerate(per_frame):
        for o_idx, gid in enumerate(track_ids):
            if gid in boxes_here:
                c, q, _ = boxes_here[gid]
                centers[f_idx, o_idx] = c
                quats[f_idx, o_idx] = q
                valid[f_idx, o_idx] = True

    timestamps = np.asarray(timestamps, np.int64)
    if time_offset is None:
        time_offset = int(timestamps[0]) if F else 0

    db = AnnotationDB(
        track_ids=track_ids, timestamps=timestamps, centers=centers,
        quats=quats, valid=valid,
        sizes=np.stack([sizes[g] for g in track_ids]).astype(np.float32)
        if O else np.zeros((0, 3), np.float32),
        frames_per_track=frames_per_track, seed_points=seed_points)

    f32 = dict(dtype=torch.float32, device=device)

    def frame_of(which):
        return torch.tensor([frames_per_track[g][which] for g in track_ids],
                            **f32).reshape(O)

    tracks = ObjectTracks(
        times=torch.as_tensor(((timestamps - time_offset).astype(np.float64)
                               * time_scale).astype(np.float32),
                              device=device),
        centers=torch.as_tensor(centers, device=device),
        quats=torch.as_tensor(quats, device=device),
        valid=torch.as_tensor(valid, device=device),
        sizes=torch.as_tensor(db.sizes, device=device),
        obj_first=frame_of(0),
        obj_last=frame_of(-1),
    )
    return db, tracks
