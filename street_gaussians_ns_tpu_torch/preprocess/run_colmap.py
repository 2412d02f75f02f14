"""COLMAP SfM driver with the reference's forward-motion tuning
(counterpart of street_gaussians_ns_tpu/preprocess/run_colmap.py, a copy:
the same commands, the same error without a `colmap` on PATH).

Native equivalent of scripts/shells/run_colmap.sh + run_colmap.py: COLMAP
stays an external binary (data prep only, SURVEY.md C-N4); this runs
feature_extractor (with masks) -> exhaustive_matcher -> mapper (tuned
flags) -> model_aligner to the known-pose origin model ->
point_triangulator.

Usage:
    python -m street_gaussians_ns_tpu_torch.preprocess.run_colmap --data /clip
"""
from __future__ import annotations

import argparse
import shutil
import subprocess
from pathlib import Path


def run(cmd):
    print("+", " ".join(map(str, cmd)), flush=True)
    subprocess.run([str(c) for c in cmd], check=True)


def run_colmap(data: Path, colmap_bin: str = "colmap",
               use_masks: bool = True) -> None:
    if shutil.which(colmap_bin) is None:
        raise RuntimeError(
            f"COLMAP binary '{colmap_bin}' not found — COLMAP is an external "
            "offline dependency (see SURVEY.md C-N4)")
    db = data / "colmap" / "database.db"
    sparse = data / "colmap" / "sparse"
    origin = data / "colmap" / "origin"
    sparse.mkdir(parents=True, exist_ok=True)

    feat = [colmap_bin, "feature_extractor",
            "--database_path", db, "--image_path", data / "images",
            "--ImageReader.camera_model", "OPENCV",
            "--ImageReader.single_camera_per_folder", 1]
    if use_masks and (data / "masks").exists():
        feat += ["--ImageReader.mask_path", data / "masks"]
    run(feat)
    run([colmap_bin, "exhaustive_matcher", "--database_path", db])
    run([colmap_bin, "mapper",
         "--database_path", db, "--image_path", data / "images",
         "--output_path", sparse,
         "--Mapper.ba_refine_principal_point", 0,
         "--Mapper.abs_pose_min_inlier_ratio", 0.2,
         "--Mapper.filter_max_reproj_error", 3,
         "--Mapper.init_max_forward_motion", 1.0,
         "--Mapper.init_min_tri_angle", 0.5])
    if origin.exists():
        aligned = data / "colmap" / "aligned"
        aligned.mkdir(exist_ok=True)
        run([colmap_bin, "model_aligner",
             "--input_path", sparse / "0", "--output_path", aligned,
             "--ref_model_path", origin, "--alignment_type", "custom",
             "--alignment_max_error", 3.0])
        run([colmap_bin, "point_triangulator",
             "--database_path", db, "--image_path", data / "images",
             "--input_path", aligned, "--output_path", sparse / "0"])


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data", type=Path, required=True)
    p.add_argument("--colmap-bin", default="colmap")
    p.add_argument("--no-masks", action="store_true")
    args = p.parse_args(argv)
    run_colmap(args.data, args.colmap_bin, not args.no_masks)


if __name__ == "__main__":
    main()
