"""The offline preprocess (counterpart of street_gaussians_ns_tpu/
preprocess/): a raw clip in extract_waymo's layout -> segs/, masks/, the
known-pose COLMAP model, LiDAR seed points and per-object point clouds.

The per-pixel and per-point tools (segs_generate, masks_generate,
pcd2colmap_points3d, extract_object_pts) run on `--device` (default
cuda; they raise without a card unless --device cpu); the rest is host
code. scripts/data_process.sh chains them.
"""
