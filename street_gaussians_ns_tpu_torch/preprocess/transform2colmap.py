"""transform.json poses -> COLMAP "origin" seed model (cameras.txt +
images.txt + empty points3D.txt) for known-pose triangulation
(counterpart of street_gaussians_ns_tpu/preprocess/transform2colmap.py, a
copy; the three files are byte-equal to its).

Native equivalent of scripts/pythons/transform2colmap.py: OpenGL c2w ->
OpenCV -> w2c quaternions/translations, with the translation offset
T0 = 0.98 * first-frame translation subtracted from every pose (:103-113)
— the same constant the dataparser compensates for when loading dynamic
annotations (sgn_dataparser.py:222-225).

Usage:
    python -m street_gaussians_ns_tpu_torch.preprocess.transform2colmap \
        --data /clip --output-dir /clip/colmap/origin
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from ..data.colmap_io import rotmat2qvec


def convert(data: Path, output_dir: Path,
            transform_json: str = "transform.json") -> None:
    meta = json.load(open(data / transform_json))
    frames = meta["frames"]
    output_dir.mkdir(parents=True, exist_ok=True)

    t0 = np.asarray(frames[0]["transform_matrix"], np.float64)[:3, 3] * 0.98

    # one COLMAP camera per distinct (camera) name
    cam_ids = {}
    cameras_lines = []
    images_lines = []
    for i, fr in enumerate(frames):
        cam = fr.get("camera", "cam")
        if cam not in cam_ids:
            cam_ids[cam] = len(cam_ids) + 1
            cameras_lines.append(
                f"{cam_ids[cam]} OPENCV {fr['w']} {fr['h']} {fr['fl_x']} "
                f"{fr['fl_y']} {fr['cx']} {fr['cy']} "
                f"{fr.get('k1', 0.0)} {fr.get('k2', 0.0)} "
                f"{fr.get('p1', 0.0)} {fr.get('p2', 0.0)}")
        c2w = np.asarray(fr["transform_matrix"], np.float64)
        c2w[:3, 3] -= t0
        # nerfstudio/blender (OpenGL, z-up world) -> COLMAP (OpenCV):
        # undo the extractor's final permute/flip then the y/z axis flip.
        c2w = c2w[np.array([1, 0, 2, 3]), :]
        c2w[2, :] *= -1
        c2w[0:3, 1:3] *= -1
        w2c = np.linalg.inv(c2w)
        q = rotmat2qvec(w2c[:3, :3])
        t = w2c[:3, 3]
        name = Path(fr["file_path"]).relative_to("images").as_posix() \
            if fr["file_path"].startswith("images/") else fr["file_path"]
        images_lines.append(
            f"{i + 1} {q[0]} {q[1]} {q[2]} {q[3]} {t[0]} {t[1]} {t[2]} "
            f"{cam_ids[cam]} {name}")
        images_lines.append("")  # empty points2D line

    (output_dir / "cameras.txt").write_text("\n".join(cameras_lines) + "\n")
    (output_dir / "images.txt").write_text("\n".join(images_lines) + "\n")
    (output_dir / "points3D.txt").write_text("")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data", type=Path, required=True)
    p.add_argument("--output-dir", type=Path, required=True)
    args = p.parse_args(argv)
    convert(args.data, args.output_dir)


if __name__ == "__main__":
    main()
