// Kernel B: ragged expansion. out[r, slot] = src[r, i] for the unique run i
// with starts[i] <= slot < ends[i]; a slot covered by no run is 0.
//
// Replaces street_gaussians_ns_tpu/ops/expand_pallas.py:_expand_kernel,
// which turns the gather into one-hot MXU matmuls over a window of runs
// (with a bf16x3 split to stay exact). On the GPU a gather is cheap and
// exact: one thread per output slot finds its run by binary search of the
// non-decreasing `ends` (the JAX package's searchsorted fallback,
// expand_pallas.py:162-167) and copies the C rows. Threads of a warp hold
// neighbouring slots, so the stores are coalesced along the slot axis and
// the loads of src and of the search path mostly hit the same lines.
//
// Bound on the H100: memory. The function reads src (C x S), starts and
// ends (S each) and writes out (C x out_len), 4 bytes an element. The
// binary search re-reads `ends` log2(S) times per slot, mostly from L1/L2.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
    expand_kernel(const float* __restrict__ src,
                  const int* __restrict__ starts,
                  const int* __restrict__ ends, float* __restrict__ out,
                  int c, long long s, long long out_len) {
  const long long slot = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (slot >= out_len) return;
  // First run whose end exceeds the slot (searchsorted side="right").
  long long lo = 0, hi = s;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if ((long long)__ldg(ends + mid) <= slot)
      lo = mid + 1;
    else
      hi = mid;
  }
  const long long owner = lo < s ? lo : s - 1;
  const bool hit = (long long)__ldg(starts + owner) <= slot &&
                   slot < (long long)__ldg(ends + owner);
  for (int r = 0; r < c; ++r)
    out[(long long)r * out_len + slot] =
        hit ? __ldg(src + (long long)r * s + owner) : 0.0f;
}

}  // namespace

SG_EXPORT int sg_expand_ragged(const float* src, const int* starts,
                               const int* ends, float* out, int c,
                               long long s, long long out_len,
                               void* stream) {
  if (out_len <= 0 || c <= 0) return 0;
  if (s <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (out_len + THREADS - 1) / THREADS;
  expand_kernel<<<(unsigned)blocks, THREADS, 0,
                  static_cast<cudaStream_t>(stream)>>>(src, starts, ends, out,
                                                       c, s, out_len);
  return sg_last_error();
}
