// Kernel C: feature pack. Interleaves n_cols sorted-pair float32 columns
// (each rows_true * 128 long) into the (rows_pad, 16, 128) stream the
// forward compositor reads: out[r, f, k] = cols[f][r * 128 + k] for
// f < n_cols and r < rows_true, else 0 (the zero sentinel rows past the
// pair capacity and the unused feature rows).
//
// Replaces street_gaussians_ns_tpu/ops/composite_pallas.py:_pack_kernel
// (a Pallas interleave of (64, 128) column blocks). Here one thread owns
// one pair slot p = r * 128 + k and writes its 16 feature rows: for every
// feature the threads of a warp read 32 neighbouring floats of the column
// and write 32 neighbouring floats of the stream, so loads and stores are
// coalesced. The feature loop is unrolled, so the column pointers stay in
// registers (indexing them with a runtime feature number would copy the
// pointer table to local memory in every thread).
//
// Bound on the H100: memory. It reads n_cols * rows_true * 128 and writes
// rows_pad * 16 * 128 elements of 4 bytes. The 5 unused feature rows are
// written as zeros so the stream keeps the JAX layout bit for bit; a
// narrower stream is a later optimisation (ROADMAP.md).
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int NFEAT = 16;
constexpr int K = 128;

struct Cols {
  const float* p[NFEAT];
};

__global__ void __launch_bounds__(THREADS)
    pack_kernel(Cols cols, int n_cols, long long pairs, long long slots,
                float* __restrict__ out) {
  const long long p = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (p >= slots) return;
  float* o = out + (p / K) * (NFEAT * K) + (p % K);
  const bool live = p < pairs;
#pragma unroll
  for (int f = 0; f < NFEAT; ++f) {
    float v = 0.0f;
    if (live && f < n_cols) v = __ldg(cols.p[f] + p);
    o[f * K] = v;
  }
}

}  // namespace

SG_EXPORT int sg_pack_feat_cols(const void* const* col_ptrs, int n_cols,
                                long long rows_true, long long rows_pad,
                                float* out, void* stream) {
  if (n_cols < 0 || n_cols > NFEAT)
    return static_cast<int>(cudaErrorInvalidValue);
  Cols cols;
  for (int f = 0; f < NFEAT; ++f)
    cols.p[f] = f < n_cols ? static_cast<const float*>(col_ptrs[f]) : nullptr;
  const long long slots = rows_pad * K;
  if (slots <= 0) return 0;
  const long long blocks = (slots + THREADS - 1) / THREADS;
  pack_kernel<<<(unsigned)blocks, THREADS, 0,
                static_cast<cudaStream_t>(stream)>>>(cols, n_cols,
                                                     rows_true * K, slots,
                                                     out);
  return sg_last_error();
}
