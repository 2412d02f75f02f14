"""Render ops: binning, the four hand-written CUDA kernels (scan, expand,
pack, forward compositor), the sky cubemap, and the public render op."""
