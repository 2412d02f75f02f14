#!/usr/bin/env bash
# Render wrapper on the port (the counterpart of scripts/render.sh).
set -euo pipefail
RUN=${1:?usage: render.sh <run_dir> [out_dir] [device]}
OUT=${2:-"$RUN/renders"}
DEVICE=${3:-cuda}
python -m street_gaussians_ns_tpu_torch.scripts.render --load-dir "$RUN" \
    --output-path "$OUT" --output-format video \
    --rendered-output-names rgb depth accumulation background_rgb object_rgb sky \
    --device "$DEVICE"
