#!/usr/bin/env bash
# Eval wrapper on the port (the counterpart of scripts/eval.sh).
set -euo pipefail
RUN=${1:?usage: eval.sh <run_dir> [device]}
DEVICE=${2:-cuda}
python -m street_gaussians_ns_tpu_torch.scripts.eval --load-dir "$RUN" \
    --device "$DEVICE"
