// Shared by every kernel library of street_gaussians_ns_tpu_torch.
//
// Each .cu file is built on its own into a shared library with a plain C
// interface (ops/_cuda.py). Every C entry point launches on the stream it
// is given, allocates nothing, and returns cudaGetLastError() after its
// launches, which the Python wrapper turns into an exception.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define SG_EXPORT extern "C" __attribute__((visibility("default")))

// Human-readable text of a cudaError_t, for the wrapper's exception.
SG_EXPORT const char* sg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

static inline int sg_last_error() {
  return static_cast<int>(cudaGetLastError());
}

// Counting the device work of a call (ops/_cuda.py:captured_launches):
// between these two, whatever is enqueued on `stream` is recorded into a
// CUDA graph and not run; the end returns the number of nodes recorded
// (kernels, memsets, copies) and throws the graph away.
SG_EXPORT int sg_capture_begin(void* stream) {
  return static_cast<int>(cudaStreamBeginCapture(
      static_cast<cudaStream_t>(stream), cudaStreamCaptureModeRelaxed));
}

SG_EXPORT int sg_capture_end(void* stream, long long* num_nodes) {
  cudaGraph_t graph = nullptr;
  cudaError_t err =
      cudaStreamEndCapture(static_cast<cudaStream_t>(stream), &graph);
  if (err != cudaSuccess) return static_cast<int>(err);
  size_t n = 0;
  err = cudaGraphGetNodes(graph, nullptr, &n);
  *num_nodes = static_cast<long long>(n);
  cudaGraphDestroy(graph);
  return static_cast<int>(err);
}

// The compositor's per-(pixel, pair) evaluation, shared by the forward
// kernel and the backward replay so both form sigma, the falloff and alpha
// in the same order of float operations and take the same branch at every
// (pixel, pair) (ops/rasterize_ref.py states the rules):
//   sigma = 0.5 (a dx^2 + c dy^2) + b dx dy,  (dx, dy) = center - pixel
//   alpha = min(0.999, opacity * exp(-max(sigma, 0)))
// A pair is skipped where sigma < SG_SIGMA_MIN or alpha < SG_ALPHA_THRESH;
// the callers test sigma before they form alpha (most pairs fail there).
constexpr float SG_ALPHA_THRESH = 1.0f / 255.0f;
constexpr float SG_ALPHA_CLAMP = 0.999f;
constexpr float SG_T_EPS = 1e-4f;
constexpr float SG_SIGMA_MIN = -1e-3f;

__device__ __forceinline__ float sg_sigma(float x, float y, float ca, float cb,
                                          float cc, float px, float py,
                                          float& dx, float& dy) {
  dx = x - px;
  dy = y - py;
  return 0.5f * (ca * dx * dx + cc * dy * dy) + cb * dx * dy;
}

__device__ __forceinline__ float sg_alpha(float op, float sigma,
                                          float& falloff) {
  falloff = expf(-fmaxf(sigma, 0.0f));
  return fminf(SG_ALPHA_CLAMP, op * falloff);
}
