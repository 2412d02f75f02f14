"""street_gaussians_ns_tpu_torch — the PyTorch/CUDA port of
street_gaussians_ns_tpu, written for an NVIDIA Hopper GPU (H100).

The sub-packages mirror the JAX package's layout (`core/`, `ops/`,
`models/`, `engine/`), so the counterpart of each module is found by path.
Plain tensor code is PyTorch; every TPU (Pallas) kernel on the ported path
is a CUDA kernel written by hand in `csrc/`, built with nvcc for sm_90a at
first use (`ops/_cuda.py`). On CPU tensors each kernel wrapper runs its
plain PyTorch version instead, which is what the tests on a machine
without a GPU exercise.

This slice ports the serving path: rendering a trained scene graph
(`models.scene_graph.forward_scene` with training=False) through the
fused rasterizer, plus loading the JAX package's checkpoints
(`engine.checkpoints`).
"""

__version__ = "0.1.0"
