#!/usr/bin/env bash
# Offline data pipeline for one extracted Waymo clip on the port (the
# counterpart of scripts/data_process.sh):
#   segs -> masks -> known-pose colmap seed -> COLMAP SfM -> lidar points ->
#   combined seed points -> per-object point clouds.
# The per-pixel and per-point tools run on DEVICE (default cuda; cpu runs
# them on the host). Without a `colmap` on PATH run_colmap raises; copy
# colmap/origin to colmap/sparse/0 to go on from the known poses alone.
set -euo pipefail
DATA=${1:?usage: data_process.sh <clip_dir> [device]}
DEVICE=${2:-cuda}
PY="python -m street_gaussians_ns_tpu_torch.preprocess"

$PY.segs_generate --data "$DATA" --mode naive --device "$DEVICE"
$PY.masks_generate --data "$DATA" --dilate 25 --device "$DEVICE"
$PY.transform2colmap --data "$DATA" --output-dir "$DATA/colmap/origin"
$PY.run_colmap --data "$DATA"
$PY.pcd2colmap_points3d --data "$DATA" \
    --output "$DATA/colmap/sparse/0/points3D_lidar.txt" --device "$DEVICE"
$PY.colmap_pts_combine --colmap-dir "$DATA/colmap/sparse/0" \
    --lidar-points points3D_lidar.txt
$PY.extract_object_pts --data "$DATA" --device "$DEVICE"
echo "data_process: done -> $DATA"
