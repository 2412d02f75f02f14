"""PLY reading/writing in pure numpy (counterpart of
street_gaussians_ns_tpu/data/ply_io.py, a copy: the port imports nothing
of the JAX package; export layout per exporter.py:60-135).

Supports ascii and binary_little_endian vertex elements — the formats the
pipeline produces/consumes (per-object LiDAR seeds, Inria-compatible 3DGS
exports readable by standard web viewers).
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

_PLY_TYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


def read_ply(path: Path) -> Dict[str, np.ndarray]:
    """Read the vertex element into {property_name: (N,) array}."""
    with open(path, "rb") as f:
        line = f.readline().strip()
        assert line == b"ply", f"not a PLY file: {path}"
        fmt = None
        props = []
        counts = {}
        cur_elem = None
        while True:
            line = f.readline().strip().decode("ascii")
            if line.startswith("format"):
                fmt = line.split()[1]
            elif line.startswith("element"):
                _, name, cnt = line.split()
                cur_elem = name
                counts[name] = int(cnt)
            elif line.startswith("property") and cur_elem == "vertex":
                parts = line.split()
                if parts[1] == "list":
                    raise ValueError("list properties unsupported on vertex")
                props.append((parts[2], _PLY_TYPES[parts[1]]))
            elif line == "end_header":
                break
        n = counts.get("vertex", 0)
        if fmt == "ascii":
            rows = []
            for _ in range(n):
                rows.append([float(v) for v in
                             f.readline().split()[:len(props)]])
            arr = np.array(rows)
            return {name: arr[:, i].astype(t)
                    for i, (name, t) in enumerate(props)}
        assert fmt == "binary_little_endian", f"unsupported format {fmt}"
        dtype = np.dtype([(name, "<" + t) for name, t in props])
        data = np.frombuffer(f.read(dtype.itemsize * n), dtype=dtype)
        return {name: np.ascontiguousarray(data[name]) for name, _ in props}


def read_ply_points(path: Path) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """(xyz (N,3) f32, rgb (N,3) f32 in [0,255] or None)."""
    v = read_ply(path)
    xyz = np.stack([v["x"], v["y"], v["z"]], axis=-1).astype(np.float32)
    rgb = None
    if "red" in v:
        rgb = np.stack([v["red"], v["green"], v["blue"]], -1).astype(np.float32)
        if v["red"].dtype != np.uint8 and rgb.max() <= 1.0:
            rgb = rgb * 255.0
    return xyz, rgb


def write_ply(path: Path, columns: Dict[str, np.ndarray],
              dtype: str = "f4") -> None:
    """Write a binary_little_endian vertex-only PLY; column order preserved."""
    names = list(columns.keys())
    n = len(next(iter(columns.values())))
    dt = np.dtype([(name, "<" + (
        "u1" if columns[name].dtype == np.uint8 else dtype)) for name in names])
    rec = np.zeros((n,), dtype=dt)
    for name in names:
        rec[name] = columns[name]
    type_names = {v: k for k, v in _PLY_TYPES.items()}
    with open(path, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\n")
        f.write(f"element vertex {n}\n".encode())
        for name in names:
            t = type_names[dt[name].str.lstrip("<|>")]
            f.write(f"property {t} {name}\n".encode())
        f.write(b"end_header\n")
        f.write(rec.tobytes())


def write_gaussian_ply(
    path: Path,
    means: np.ndarray,          # (N, 3)
    features_dc: np.ndarray,    # (N, 3) SH DC (time-collapsed)
    features_rest: np.ndarray,  # (N, K-1, 3)
    opacities: np.ndarray,      # (N,) logit
    scales: np.ndarray,         # (N, 3) log
    quats: np.ndarray,          # (N, 4) wxyz
) -> int:
    """Inria-compatible 3DGS .ply (ExportGaussianSplat.save_gs_model,
    exporter.py:60-135): x/y/z, nx/ny/nz=0, f_dc_*, f_rest_* in
    channel-major (transposed) order, opacity, scale_*, rot_*; rows with
    NaN/Inf dropped (:104-117). Returns the number of rows written."""
    finite = np.isfinite(means).all(1)
    for a in (features_dc, opacities[:, None], scales, quats):
        finite &= np.isfinite(a.reshape(len(a), -1)).all(1)
    finite &= np.isfinite(features_rest.reshape(len(features_rest), -1)).all(1)

    means = means[finite]
    features_dc = features_dc[finite]
    rest = features_rest[finite]
    opacities = opacities[finite]
    scales = scales[finite]
    quats = quats[finite]
    n = means.shape[0]

    cols: Dict[str, np.ndarray] = {}
    for i, ax in enumerate("xyz"):
        cols[ax] = means[:, i].astype(np.float32)
    for i, ax in enumerate("xyz"):
        cols[f"n{ax}"] = np.zeros((n,), np.float32)
    for i in range(3):
        cols[f"f_dc_{i}"] = features_dc[:, i].astype(np.float32)
    # channel-major: transpose (N, K-1, 3) -> (N, 3, K-1) (exporter.py:80)
    rest_t = rest.transpose(0, 2, 1).reshape(n, -1)
    for i in range(rest_t.shape[1]):
        cols[f"f_rest_{i}"] = rest_t[:, i].astype(np.float32)
    cols["opacity"] = opacities.astype(np.float32)
    for i in range(3):
        cols[f"scale_{i}"] = scales[:, i].astype(np.float32)
    for i in range(4):
        cols[f"rot_{i}"] = quats[:, i].astype(np.float32)
    write_ply(path, cols)
    return n
