"""street_gaussians_ns_tpu_torch — the PyTorch/CUDA port of
street_gaussians_ns_tpu, written for an NVIDIA Hopper GPU (H100).

The sub-packages mirror the JAX package's layout (`core/`, `ops/`,
`models/`, `engine/`, `data/`, `native/`, `parallel/`, `scripts/`,
`utils/`), so the counterpart of each module is found by path.
Plain tensor code is PyTorch; every TPU (Pallas) kernel on the ported path
is a CUDA kernel written by hand in `csrc/`, built with nvcc for sm_90a at
first use (`ops/_cuda.py`). On CPU tensors each kernel wrapper runs its
plain PyTorch version instead, which is what the tests on a machine
without a GPU exercise.

Ported so far: rendering a scene graph (`models.scene_graph.forward_scene`)
and training it (`engine.scene_train_step`, with the camera pose
optimizer `models.camera_opt` and every bbox mode) through the fused
rasterizer and every other route, in float32 or with bf16-rounded
features (`precision="bf16"`, `ops.packing`); the multi-device (data,
model) trainer on torch.distributed (`parallel/`); the single-model Splatfacto
pipeline (`models.splatfacto.forward`, `engine.train_step`); the data
layer that reads a clip from disk; the trainer with checkpoints either
package reads (`engine.trainer`, `engine.setup`, `engine.checkpoints`)
and its live viewer (`utils.viewer`); the spans and host-sync counts of
the loop, the step and the frame (`utils.profiling`); and the train /
eval / render / export / viewer entry points (`scripts/`), each with
`--device` (default cuda).
"""

__version__ = "0.1.0"
