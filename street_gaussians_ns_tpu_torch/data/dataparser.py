"""COLMAP scene parser: poses, times, splits, seed points, annotations
(counterpart of street_gaussians_ns_tpu/data/dataparser.py; numpy on the
host, the object tracks on the caller's device).

Native equivalent of the reference's ColmapDataParser
(the reference's data/sgn_dataparser.py:109-753) plus
the nerfstudio camera_utils it leans on, with the same numerics:
  * COLMAP w2c -> c2w, OpenCV->OpenGL axis flip (:179-189),
  * per-frame timestamps joined from transform.json by file path (:151-160),
  * frames sorted by (camera_id, time, file_path) (:213),
  * auto orient ("up") + center ("poses") + scale to the unit box, or reuse
    of a cached dataparser_transforms.json (:357-381),
  * train/eval split: optional frame_select window per camera, camera-id
    filter, then the 0.9 linspace split (:229-292; the declared-but-dead
    eval_mode="interval" branch is NOT implemented here either — quirk kept),
  * 3D seed points from points3D(.bin|.txt), transformed + scaled (:476-506),
  * dynamic annotations with the COLMAP translation compensation
    `-first_frame_pose*0.98` mapped through gl2cv (:222-225, :445-457).

Times are rebased to seconds-from-first-annotation so they fit f32 on
device (the reference carries raw 16-digit stamps in f64).
"""
from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from . import colmap_io
from .annotations import AnnotationDB, load_annotations, parse_timestamp
from ..models.scene_graph import ObjectTracks


# ---------------------------------------------------------------------------
# nerfstudio camera_utils equivalents (public algorithms, reimplemented).
# ---------------------------------------------------------------------------

def rotation_matrix_between(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Rotation taking unit vector a to unit vector b (Rodrigues)."""
    a = a / np.linalg.norm(a)
    b = b / np.linalg.norm(b)
    v = np.cross(a, b)
    c = float(a @ b)
    s = np.linalg.norm(v)
    if s < 1e-8:
        if c > 0:
            return np.eye(3)
        # 180 degrees: rotate about any axis orthogonal to a.
        axis = np.cross(a, np.array([1.0, 0, 0]))
        if np.linalg.norm(axis) < 1e-6:
            axis = np.cross(a, np.array([0, 1.0, 0]))
        axis /= np.linalg.norm(axis)
        K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                      [-axis[1], axis[0], 0]])
        return np.eye(3) + 2.0 * K @ K
    K = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
    return np.eye(3) + K + K @ K * ((1 - c) / (s ** 2))


def auto_orient_and_center_poses(
    poses: np.ndarray,                   # (N, 4, 4) c2w OpenGL
    method: str = "up",
    center_method: str = "poses",
) -> Tuple[np.ndarray, np.ndarray]:
    """nerfstudio's auto_orient_and_center_poses for the configurations the
    reference uses (orientation "up", center "poses"; "none" supported)."""
    origins = poses[:, :3, 3]
    mean_origin = origins.mean(axis=0)
    if center_method == "poses":
        translation = mean_origin
    elif center_method == "none":
        translation = np.zeros(3)
    else:
        raise ValueError(f"unsupported center_method {center_method}")

    if method == "up":
        up = poses[:, :3, 1].mean(axis=0)
        up = up / np.linalg.norm(up)
        rotation = rotation_matrix_between(up, np.array([0.0, 0, 1.0]))
        transform = np.concatenate(
            [rotation, (rotation @ -translation)[:, None]], axis=1)  # (3,4)
    elif method == "none":
        transform = np.eye(4)[:3]
        transform[:3, 3] = -translation
    else:
        raise ValueError(f"unsupported orientation method {method}")

    t44 = np.concatenate([transform, [[0, 0, 0, 1]]], axis=0)
    oriented = np.einsum("ij,njk->nik", t44, poses)
    return oriented, transform


def gl2cv(v4: np.ndarray) -> np.ndarray:
    """(x,y,z,1) OpenGL -> OpenCV swap used for the annotation translation
    compensation (geometric_metric.py:8-16)."""
    m = np.eye(4)[[1, 0, 2, 3], :]
    m[2, :] *= -1
    return m @ v4


# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DataParserConfig:
    data: Path = Path(".")
    colmap_path: Path = Path("colmap/sparse/0")
    images_path: Path = Path("images")
    masks_path: Optional[Path] = None
    segments_path: Optional[Path] = Path("segs")
    init_points_filename: str = "points3D.bin"
    meta_file: Path = Path("transform.json")
    orientation_method: str = "up"
    center_method: str = "poses"
    auto_scale_poses: bool = True
    scale_factor: float = 1.0
    train_split_fraction: float = 0.9
    filter_camera_id: Optional[List[int]] = None
    frame_select: Optional[List[int]] = None   # [start, end) per camera
    load_3D_points: bool = True
    load_dynamic_annotations: bool = True
    max_seed_points: Optional[int] = None
    time_scale: float = 1e-6                   # 16-digit stamps -> seconds
    # FISHEYE624 only: radius (px) of the valid fisheye circle, the
    # reference's camera.metadata["fisheye_crop_radius"]
    # (sgn_datamanager.py:401-404). None -> largest centered circle.
    fisheye_crop_radius: Optional[float] = None


@dataclasses.dataclass
class ParsedScene:
    """Host-side parsed scene; arrays over N frames."""

    image_paths: List[Path]
    mask_paths: Optional[List[Path]]
    segment_paths: Optional[List[Path]]
    c2w: np.ndarray            # (N, 3, 4) OpenGL, oriented+scaled
    fx: np.ndarray             # (N,)
    fy: np.ndarray
    cx: np.ndarray
    cy: np.ndarray
    width: np.ndarray          # (N,) int
    height: np.ndarray
    camera_ids: np.ndarray     # (N,)
    times: np.ndarray          # (N,) float seconds (rebased) or zeros
    # (N, 12) [k1 k2 k3 k4 p1 p2 k5 k6 s1 s2 s3 s4]: first six slots keep
    # the PERSPECTIVE/FISHEYE layout; the tail is only populated for
    # FISHEYE624 (extra radial + thin-prism terms).
    distortion: np.ndarray
    camera_model: np.ndarray   # (N,) int — core.cameras.{PERSPECTIVE,...}
    train_indices: np.ndarray
    eval_indices: np.ndarray
    points_xyz: Optional[np.ndarray]
    points_rgb: Optional[np.ndarray]
    transform_matrix: np.ndarray   # (3, 4) world transform applied
    dataparser_scale: float
    time_offset: int               # 16-digit stamp subtracted before scaling
    annotations: Optional[AnnotationDB] = None
    tracks: Optional[ObjectTracks] = None
    fisheye_crop_radius: Optional[float] = None   # FISHEYE624 frames only
    # -0.98 * first-frame translation, gl2cv'd — the shift transform2colmap
    # baked into the COLMAP frame (sgn_dataparser.py:222-225); consumers
    # (LiDAR chamfer eval, geometric_metric.py:83-92) must re-apply it to
    # raw clip-frame points before the world transform + scale.
    applied_translation_in_colmap: Optional[np.ndarray] = None

    @property
    def num_frames(self) -> int:
        return len(self.image_paths)


def parse_scene(config: DataParserConfig, split_all: bool = False,
                device="cuda") -> ParsedScene:
    """Parse the clip at config.data; the object tracks are built on
    `device`."""
    data = Path(config.data)
    recon = data / config.colmap_path
    cams = colmap_io.read_cameras(recon)
    images = colmap_io.read_images(recon)

    # file path -> raw timestamp from transform.json
    file2time: Dict[str, float] = {}
    meta_path = data / config.meta_file
    meta = None
    if meta_path.exists():
        meta = json.load(open(meta_path))
        file2time = {fr["file_path"]: float(fr["timestamp"])
                     for fr in meta["frames"]}

    frames = []
    for im_id in sorted(images.keys()):
        im = images[im_id]
        R = colmap_io.qvec2rotmat(im.qvec)
        w2c = np.eye(4)
        w2c[:3, :3] = R
        w2c[:3, 3] = im.tvec
        c2w = np.linalg.inv(w2c)
        c2w[0:3, 1:3] *= -1          # OpenCV -> OpenGL (:189)
        fx, fy, cx, cy, dist, cam_model = colmap_io.camera_intrinsics(
            cams[im.camera_id])
        rel = (config.images_path / im.name).as_posix()
        frames.append(dict(
            path=data / config.images_path / im.name,
            name=im.name, c2w=c2w, camera_id=im.camera_id,
            fx=fx, fy=fy, cx=cx, cy=cy,
            w=cams[im.camera_id].width, h=cams[im.camera_id].height,
            dist=[dist["k1"], dist["k2"], dist["k3"], dist["k4"],
                  dist["p1"], dist["p2"], dist["k5"], dist["k6"],
                  dist["s1"], dist["s2"], dist["s3"], dist["s4"]],
            cam_model=cam_model,
            time=file2time.get(rel, 0.0),
        ))
    frames.sort(key=lambda f: (f["camera_id"], f["time"],
                               f["path"].as_posix()))

    poses = np.stack([f["c2w"] for f in frames])        # (N,4,4)

    cached = data / "dataparser_transforms.json"
    if cached.exists():
        dp = json.load(open(cached))
        transform = np.asarray(dp["transform"], np.float64)
        t44 = np.concatenate([transform, [[0, 0, 0, 1]]], axis=0)
        poses = np.einsum("ij,njk->nik", t44, poses)
        scale = float(dp["scale"])
    else:
        poses, transform = auto_orient_and_center_poses(
            poses, config.orientation_method, config.center_method)
        scale = 1.0
        if config.auto_scale_poses:
            scale /= float(np.max(np.abs(poses[:, :3, 3])))
    scale *= config.scale_factor
    poses[:, :3, 3] *= scale

    # Split (sgn_dataparser.py:229-292).
    camera_ids = np.array([f["camera_id"] for f in frames])
    if config.frame_select is not None:
        assert config.filter_camera_id, \
            "frame_select requires filter_camera_id (reference behavior)"
        _, counts = np.unique(camera_ids, return_counts=True)
        frame_len = counts[0]
        all_idx = []
        for i in range(len(config.filter_camera_id)):
            all_idx.extend(range(config.frame_select[0] + i * frame_len,
                                 config.frame_select[1] + i * frame_len))
        all_idx = np.array(all_idx, np.int32)
    else:
        all_idx = np.arange(len(frames), dtype=np.int32)
    if config.filter_camera_id:
        all_idx = np.array([i for i in all_idx
                            if camera_ids[i] in config.filter_camera_id],
                           np.int32)
    num_images = len(all_idx)
    num_train = math.ceil(num_images * config.train_split_fraction)
    i_train = np.linspace(0, num_images - 1, num_train, dtype=int)
    i_eval = np.setdiff1d(np.arange(num_images), i_train)
    train_indices = all_idx[i_train]
    eval_indices = all_idx if split_all else all_idx[i_eval]

    # 3D seed points.
    pts_xyz = pts_rgb = None
    if config.load_3D_points:
        pts_path = recon / config.init_points_filename
        xyz, rgb, _, _ = colmap_io.read_points3d(pts_path)
        t44 = np.concatenate([transform, [[0, 0, 0, 1]]], axis=0)
        xyz = (np.concatenate([xyz, np.ones((len(xyz), 1))], 1)
               @ t44.T)[:, :3] * scale
        if config.max_seed_points and len(xyz) > config.max_seed_points:
            keep = np.random.RandomState(0).choice(
                len(xyz), config.max_seed_points, replace=False)
            xyz, rgb = xyz[keep], rgb[keep]
        pts_xyz, pts_rgb = xyz.astype(np.float32), rgb

    # Time rebasing: subtract the first frame stamp, scale to seconds.
    raw_times = np.array([f["time"] for f in frames], np.float64)
    stamps = np.array([parse_timestamp(t) if t else 0 for t in raw_times],
                      np.int64)
    time_offset = int(stamps.min()) if stamps.any() else 0
    times = (stamps - time_offset).astype(np.float64) * config.time_scale

    # Dynamic annotations, in the fully transformed+scaled model space.
    annotations = tracks = None
    applied = None
    if meta is not None and meta.get("frames"):
        first_pose_t = np.asarray(meta["frames"][0]["transform_matrix"],
                                  np.float64)[:3, 3]
        applied = -first_pose_t * 0.98                   # (:222-225)
        applied = gl2cv(np.append(applied, 1.0))[:3]
    if config.load_dynamic_annotations and meta is not None:
        tm_colmap = np.eye(4)
        tm_colmap[:3, 3] = applied
        t44 = np.concatenate([transform, [[0, 0, 0, 1]]], axis=0)
        tm_anno = t44 @ tm_colmap
        annotations, tracks = load_annotations(
            data / "annotation.json",
            lidar_path=data / "aggregate_lidar" / "dynamic_objects",
            transform_matrix=tm_anno, scale_factor=scale,
            time_offset=time_offset, time_scale=config.time_scale,
            device=device)

    def _optional_paths(base: Optional[Path]):
        if base is None:
            return None
        return [(data / base / f["name"]).with_suffix(".png") for f in frames]

    return ParsedScene(
        image_paths=[f["path"] for f in frames],
        mask_paths=_optional_paths(config.masks_path),
        segment_paths=_optional_paths(config.segments_path),
        c2w=poses[:, :3, :4].astype(np.float32),
        fx=np.array([f["fx"] for f in frames], np.float32),
        fy=np.array([f["fy"] for f in frames], np.float32),
        cx=np.array([f["cx"] for f in frames], np.float32),
        cy=np.array([f["cy"] for f in frames], np.float32),
        width=np.array([f["w"] for f in frames], np.int32),
        height=np.array([f["h"] for f in frames], np.int32),
        camera_ids=camera_ids,
        times=times.astype(np.float32),
        distortion=np.array([f["dist"] for f in frames], np.float32),
        camera_model=np.array([f["cam_model"] for f in frames], np.int32),
        train_indices=train_indices,
        eval_indices=eval_indices,
        points_xyz=pts_xyz,
        points_rgb=pts_rgb,
        transform_matrix=transform.astype(np.float32),
        dataparser_scale=scale,
        time_offset=time_offset,
        annotations=annotations,
        tracks=tracks,
        fisheye_crop_radius=config.fisheye_crop_radius,
        applied_translation_in_colmap=applied,
    )
