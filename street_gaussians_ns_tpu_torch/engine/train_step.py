"""The optimizer groups of one Gaussian cloud (counterpart of
street_gaussians_ns_tpu/engine/train_step.py: `GAUSSIAN_GROUPS`; the
single-model `train_step` is not ported yet, ROADMAP.md)."""
from __future__ import annotations

GAUSSIAN_GROUPS = ("means", "scales", "quats", "features_dc",
                   "features_rest", "opacities")
