#!/usr/bin/env bash
# Export wrapper on the port (the counterpart of scripts/export.sh).
set -euo pipefail
RUN=${1:?usage: export.sh <run_dir> [out_dir] [device]}
OUT=${2:-"$RUN/exports"}
DEVICE=${3:-cuda}
python -m street_gaussians_ns_tpu_torch.scripts.export --load-dir "$RUN" \
    --output-dir "$OUT" --device "$DEVICE"
