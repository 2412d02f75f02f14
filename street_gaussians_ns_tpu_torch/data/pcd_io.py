"""Minimal PCD (Point Cloud Data) reader/writer (counterpart of
street_gaussians_ns_tpu/data/pcd_io.py, a copy) for the offline pipeline.
Supports the v0.7 ascii and binary formats open3d writes (x/y/z float32,
optional rgb)."""
from __future__ import annotations

from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_PCD_TYPES = {("F", 4): "f4", ("F", 8): "f8", ("U", 1): "u1", ("U", 4): "u4",
              ("I", 4): "i4"}


def read_pcd(path: Path) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Returns (xyz (N,3) f32, rgb (N,3) f32 in [0,255] or None)."""
    with open(path, "rb") as f:
        header = {}
        while True:
            line = f.readline().decode("ascii").strip()
            if not line or line.startswith("#"):
                continue
            key, _, val = line.partition(" ")
            header[key] = val
            if key == "DATA":
                break
        fields = header["FIELDS"].split()
        sizes = [int(s) for s in header["SIZE"].split()]
        types = header["TYPE"].split()
        counts = [int(c) for c in header.get(
            "COUNT", " ".join(["1"] * len(fields))).split()]
        n = int(header["POINTS"])
        dtype = np.dtype([
            (name, ("<" + _PCD_TYPES[(t, s)], (c,)) if c > 1
             else "<" + _PCD_TYPES[(t, s)])
            for name, t, s, c in zip(fields, types, sizes, counts)])
        if header["DATA"] == "ascii":
            rows = np.loadtxt(f, max_rows=n)
            rows = np.atleast_2d(rows)
            data = {}
            col = 0
            for name, c in zip(fields, counts):
                data[name] = rows[:, col:col + c].squeeze(-1) if c == 1 \
                    else rows[:, col:col + c]
                col += c
        elif header["DATA"] == "binary":
            rec = np.frombuffer(f.read(dtype.itemsize * n), dtype=dtype)
            data = {name: rec[name] for name in fields}
        else:
            raise ValueError(f"unsupported PCD data {header['DATA']}")
    xyz = np.stack([data["x"], data["y"], data["z"]], -1).astype(np.float32)
    rgb = None
    if "rgb" in data:
        packed = np.asarray(data["rgb"])
        raw = packed.astype(np.float32).view(np.uint32) \
            if packed.dtype.kind == "f" else packed.astype(np.uint32)
        rgb = np.stack([(raw >> 16) & 255, (raw >> 8) & 255, raw & 255],
                       -1).astype(np.float32)
    return xyz, rgb


def write_pcd(path: Path, xyz: np.ndarray,
              rgb: Optional[np.ndarray] = None) -> None:
    """Write binary PCD with x/y/z (+ packed rgb)."""
    n = len(xyz)
    fields, sizes, types, counts = ["x", "y", "z"], [4] * 3, ["F"] * 3, [1] * 3
    cols = [xyz[:, 0].astype("<f4"), xyz[:, 1].astype("<f4"),
            xyz[:, 2].astype("<f4")]
    if rgb is not None:
        rgb8 = np.clip(rgb, 0, 255).astype(np.uint32)
        packed = (rgb8[:, 0] << 16) | (rgb8[:, 1] << 8) | rgb8[:, 2]
        fields.append("rgb")
        sizes.append(4)
        types.append("U")
        counts.append(1)
        cols.append(packed.astype("<u4"))
    header = (
        "# .PCD v0.7 - Point Cloud Data file format\nVERSION 0.7\n"
        f"FIELDS {' '.join(fields)}\n"
        f"SIZE {' '.join(map(str, sizes))}\n"
        f"TYPE {' '.join(types)}\n"
        f"COUNT {' '.join(map(str, counts))}\n"
        f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\n"
        f"POINTS {n}\nDATA binary\n")
    rec = np.zeros((n,), dtype=np.dtype(
        [(name, c.dtype) for name, c in zip(fields, cols)]))
    for name, c in zip(fields, cols):
        rec[name] = c
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(rec.tobytes())
