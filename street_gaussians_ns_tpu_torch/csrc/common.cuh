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
