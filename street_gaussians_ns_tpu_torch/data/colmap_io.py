"""COLMAP model readers: cameras / images / points3D, binary and text
(counterpart of street_gaussians_ns_tpu/data/colmap_io.py, a copy apart
from the reader count below and read_images_text's pairing of lines).

points3D.bin is parsed by the native reader (`native/`) when it builds and
loads, else by the Python loop; `POINTS3D_READERS` counts which one parsed
each file ("native" / "python"), so a caller can check which ran.

Format reference: https://colmap.github.io/format.html (public spec).
"""
from __future__ import annotations

import collections
import dataclasses
import struct
from pathlib import Path
from typing import Dict

import numpy as np

# model_id -> (name, num_params)
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}
CAMERA_MODEL_IDS = {name: mid for mid, (name, _) in CAMERA_MODELS.items()}

# Files parsed by each points3D.bin reader in this process.
POINTS3D_READERS: collections.Counter = collections.Counter()


@dataclasses.dataclass
class ColmapCamera:
    camera_id: int
    model: str
    width: int
    height: int
    params: np.ndarray


@dataclasses.dataclass
class ColmapImage:
    image_id: int
    qvec: np.ndarray   # (4,) wxyz
    tvec: np.ndarray   # (3,)
    camera_id: int
    name: str
    xys: np.ndarray            # (P, 2)
    point3d_ids: np.ndarray    # (P,)


@dataclasses.dataclass
class ColmapPoint3D:
    id: int
    xyz: np.ndarray
    rgb: np.ndarray
    error: float


def qvec2rotmat(qvec: np.ndarray) -> np.ndarray:
    """COLMAP scalar-first quaternion -> rotation matrix."""
    w, x, y, z = qvec
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def rotmat2qvec(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> COLMAP wxyz quaternion (Shepperd)."""
    K = np.array([
        [R[0, 0] - R[1, 1] - R[2, 2], 0, 0, 0],
        [R[0, 1] + R[1, 0], R[1, 1] - R[0, 0] - R[2, 2], 0, 0],
        [R[0, 2] + R[2, 0], R[1, 2] + R[2, 1], R[2, 2] - R[0, 0] - R[1, 1], 0],
        [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1],
         R[0, 0] + R[1, 1] + R[2, 2]],
    ]) / 3.0
    vals, vecs = np.linalg.eigh(K)
    q = vecs[[3, 0, 1, 2], np.argmax(vals)]
    return -q if q[0] < 0 else q


def _read(f, fmt):
    size = struct.calcsize(fmt)
    return struct.unpack(fmt, f.read(size))


def read_cameras_binary(path: Path) -> Dict[int, ColmapCamera]:
    out = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            cam_id, model_id, w, h = _read(f, "<iiQQ")
            name, np_ = CAMERA_MODELS[model_id]
            params = np.array(_read(f, f"<{np_}d"))
            out[cam_id] = ColmapCamera(cam_id, name, int(w), int(h), params)
    return out


def read_cameras_text(path: Path) -> Dict[int, ColmapCamera]:
    out = {}
    for line in Path(path).read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        cam_id, model = int(parts[0]), parts[1]
        out[cam_id] = ColmapCamera(cam_id, model, int(parts[2]), int(parts[3]),
                                   np.array([float(p) for p in parts[4:]]))
    return out


def read_images_binary(path: Path) -> Dict[int, ColmapImage]:
    out = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            vals = _read(f, "<idddddddi")
            image_id = vals[0]
            qvec = np.array(vals[1:5])
            tvec = np.array(vals[5:8])
            camera_id = vals[8]
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (npts,) = _read(f, "<Q")
            # rows of (x f64, y f64, point3D_id i64)
            data = np.frombuffer(f.read(24 * npts), dtype=np.float64)
            data = data.reshape(npts, 3)
            xys = data[:, :2].copy()
            p3d = (np.frombuffer(np.ascontiguousarray(data[:, 2]).tobytes(),
                                 dtype=np.int64)
                   if npts else np.zeros(0, np.int64))
            out[image_id] = ColmapImage(image_id, qvec, tvec, camera_id,
                                        name.decode("utf-8"), xys, p3d)
    return out


def read_images_text(path: Path) -> Dict[int, ColmapImage]:
    """Two lines an image, paired by position: the image line, then its
    POINTS2D line, which is empty for an image without observations
    (COLMAP and preprocess.transform2colmap both write it so). Only `#`
    lines are dropped; a blank line where an image line is due (trailing
    whitespace) is skipped, and a missing last POINTS2D line reads as
    empty. The JAX package's reader drops every blank line and so
    mis-pairs such a file."""
    out = {}
    lines = [ln.strip() for ln in Path(path).read_text().splitlines()
             if not ln.strip().startswith("#")]
    i = 0
    while i < len(lines):
        if not lines[i]:
            i += 1
            continue
        parts = lines[i].split()
        image_id = int(parts[0])
        qvec = np.array([float(p) for p in parts[1:5]])
        tvec = np.array([float(p) for p in parts[5:8]])
        camera_id = int(parts[8])
        name = parts[9]
        pts = lines[i + 1].split() if i + 1 < len(lines) else []
        xys = np.array([float(v) for v in pts], dtype=np.float64)
        if xys.size:
            xys = xys.reshape(-1, 3)
            p3d = xys[:, 2].astype(np.int64)
            xys = xys[:, :2]
        else:
            xys = np.zeros((0, 2))
            p3d = np.zeros(0, np.int64)
        out[image_id] = ColmapImage(image_id, qvec, tvec, camera_id, name,
                                    xys, p3d)
        i += 2
    return out


def read_points3d_binary(path: Path):
    """Returns (xyz (N,3) f64, rgb (N,3) u8, error (N,), ids (N,)).

    Tries the native C++ parser first (a single buffered pass; the
    per-record Python loop below costs minutes at LiDAR scale) and falls
    back to the loop; POINTS3D_READERS counts which one ran."""
    from ..native import read_points3d_binary as native_read

    out = native_read(path)
    if out is not None:
        POINTS3D_READERS["native"] += 1
        return out
    POINTS3D_READERS["python"] += 1
    xyzs, rgbs, errs, ids = [], [], [], []
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            vals = _read(f, "<QdddBBBd")
            ids.append(vals[0])
            xyzs.append(vals[1:4])
            rgbs.append(vals[4:7])
            errs.append(vals[7])
            (track_len,) = _read(f, "<Q")
            f.seek(8 * track_len, 1)
    return (np.array(xyzs, np.float64).reshape(-1, 3),
            np.array(rgbs, np.uint8).reshape(-1, 3),
            np.array(errs), np.array(ids, np.int64))


def read_points3d_text(path: Path):
    xyzs, rgbs, errs, ids = [], [], [], []
    for line in Path(path).read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        ids.append(int(parts[0]))
        xyzs.append([float(p) for p in parts[1:4]])
        rgbs.append([int(p) for p in parts[4:7]])
        errs.append(float(parts[7]))
    return (np.array(xyzs, np.float64).reshape(-1, 3),
            np.array(rgbs, np.uint8).reshape(-1, 3),
            np.array(errs), np.array(ids, np.int64))


def read_cameras(recon_dir: Path) -> Dict[int, ColmapCamera]:
    if (recon_dir / "cameras.txt").exists():
        return read_cameras_text(recon_dir / "cameras.txt")
    return read_cameras_binary(recon_dir / "cameras.bin")


def read_images(recon_dir: Path) -> Dict[int, ColmapImage]:
    if (recon_dir / "images.txt").exists():
        return read_images_text(recon_dir / "images.txt")
    return read_images_binary(recon_dir / "images.bin")


def read_points3d(path: Path):
    if path.suffix == ".txt":
        return read_points3d_text(path)
    return read_points3d_binary(path)


def camera_intrinsics(cam: ColmapCamera):
    """(fx, fy, cx, cy, distortion dict, camera model int) from COLMAP
    params — covers the models the plugin's undistortion paths consume
    (PERSPECTIVE / FISHEYE / FISHEYE624, sgn_datamanager.py:326-497).
    The dict carries the FISHEYE624 superset of coefficients (k1..k6
    radial, p1 p2 tangential, s1..s4 thin prism), zero where the model
    has none; model ints match core.cameras.{PERSPECTIVE,FISHEYE,
    FISHEYE624}."""
    p = cam.params
    d = dict(k1=0.0, k2=0.0, k3=0.0, k4=0.0, p1=0.0, p2=0.0,
             k5=0.0, k6=0.0, s1=0.0, s2=0.0, s3=0.0, s4=0.0)
    m = cam.model
    if m == "SIMPLE_PINHOLE":
        fx = fy = p[0]; cx, cy = p[1], p[2]
    elif m == "PINHOLE":
        fx, fy, cx, cy = p[:4]
    elif m == "SIMPLE_RADIAL":
        fx = fy = p[0]; cx, cy = p[1], p[2]; d["k1"] = p[3]
    elif m == "RADIAL":
        fx = fy = p[0]; cx, cy = p[1], p[2]; d["k1"], d["k2"] = p[3], p[4]
    elif m == "OPENCV":
        fx, fy, cx, cy = p[:4]
        d["k1"], d["k2"], d["p1"], d["p2"] = p[4:8]
    elif m == "OPENCV_FISHEYE":
        fx, fy, cx, cy = p[:4]
        d["k1"], d["k2"], d["k3"], d["k4"] = p[4:8]
    elif m == "THIN_PRISM_FISHEYE":
        # fx fy cx cy k1 k2 p1 p2 k3 k4 sx1 sy1 — same
        # equidistant + theta-radial + tangential + thin-prism family as
        # FISHEYE624 with k5=k6=0 and only the r^2 prism terms.
        fx, fy, cx, cy = p[:4]
        d["k1"], d["k2"], d["p1"], d["p2"] = p[4:8]
        d["k3"], d["k4"] = p[8:10]
        d["s1"], d["s3"] = p[10:12]
    else:
        raise ValueError(f"unsupported COLMAP camera model {m}")
    if m == "OPENCV_FISHEYE":
        model = 1        # core.cameras.FISHEYE
    elif m == "THIN_PRISM_FISHEYE":
        model = 2        # core.cameras.FISHEYE624
    else:
        model = 0        # core.cameras.PERSPECTIVE
    return float(fx), float(fy), float(cx), float(cy), d, model
