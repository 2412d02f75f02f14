#!/usr/bin/env bash
# Full training invocation on the port (the counterpart of scripts/train.sh:
# front camera only, lidar-combined seed points) on DEVICE (default cuda).
set -euo pipefail
DATA=${1:?usage: train.sh <clip_dir> [output_dir] [device]}
OUT=${2:-outputs/$(basename "$DATA")}
DEVICE=${3:-cuda}

python -m street_gaussians_ns_tpu_torch.scripts.train \
    --data "$DATA" \
    --filter-camera-id 1 \
    --init-points-filename points3D_withlidar.txt \
    --trainer.output-dir "$OUT" \
    --trainer.max-num-iterations 30000 \
    --device "$DEVICE"
