"""Data layer: COLMAP / PLY / PCD readers, the scene parser, frame loading
and the full-image datamanager (counterpart of
street_gaussians_ns_tpu/data/)."""
