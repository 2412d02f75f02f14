"""Merge COLMAP SfM points with LiDAR seed points (id-offset union;
counterpart of street_gaussians_ns_tpu/preprocess/colmap_pts_combine.py,
a copy).

Native equivalent of scripts/pythons/colmap_pts_combine.py (:28-33): read
the reconstruction's points3D and the LiDAR points3D.txt, offset the
LiDAR ids past the SfM ids, and write points3D_withlidar.txt — the file
train.sh points `init_points_filename` at.

Usage:
    python -m street_gaussians_ns_tpu_torch.preprocess.colmap_pts_combine \
        --colmap-dir /clip/colmap/sparse/0 --lidar-points points3D_lidar.txt
"""
from __future__ import annotations

import argparse
from pathlib import Path

from ..data.colmap_io import read_points3d


def combine(colmap_dir: Path, lidar_points: Path,
            output_name: str = "points3D_withlidar.txt") -> int:
    sfm_path = (colmap_dir / "points3D.bin")
    if not sfm_path.exists():
        sfm_path = colmap_dir / "points3D.txt"
    xyz_a, rgb_a, err_a, ids_a = read_points3d(sfm_path)
    xyz_b, rgb_b, err_b, ids_b = read_points3d(
        lidar_points if lidar_points.is_absolute()
        else colmap_dir / lidar_points)

    offset = (ids_a.max() + 1) if len(ids_a) else 0
    rows = []
    for ids, xyz, rgb, err, off in ((ids_a, xyz_a, rgb_a, err_a, 0),
                                    (ids_b, xyz_b, rgb_b, err_b, offset)):
        for i in range(len(ids)):
            p, c = xyz[i], rgb[i]
            rows.append(f"{int(ids[i]) + off} {p[0]} {p[1]} {p[2]} "
                        f"{int(c[0])} {int(c[1])} {int(c[2])} {err[i]}")
    out = colmap_dir / output_name
    out.write_text("\n".join(rows) + ("\n" if rows else ""))
    return len(rows)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--colmap-dir", type=Path, required=True)
    p.add_argument("--lidar-points", type=Path, required=True)
    p.add_argument("--output-name", default="points3D_withlidar.txt")
    args = p.parse_args(argv)
    n = combine(args.colmap_dir, args.lidar_points, args.output_name)
    print(f"combined {n} points")
    return n


if __name__ == "__main__":
    main()
