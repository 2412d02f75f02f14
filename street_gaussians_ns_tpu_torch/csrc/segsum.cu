// Kernel G: segmented row sum. out[c, i] = sum of rows[c, p] over
// p in [starts[i], ends[i]), for contiguous, ascending, non-overlapping
// runs; empty runs (start == end) may stand anywhere and give 0.
//
// Replaces street_gaussians_ns_tpu/ops/segreduce_pallas.py:_segsum_kernel,
// which builds a one-hot from the run bounds per block of 2048 segments
// and contracts it with the pair chunk on the MXU (bf16 inputs), because
// the MXU is the TPU's only fast reducer. Here the bounds are given, so
// this is kernel F (ranksum.cu) without its binary search: one thread per
// segment sums its run in pair order, in float32, row by row. Lanes of a
// warp hold neighbouring segments, whose runs are neighbouring spans of
// every row, and the stores are coalesced along the segment axis. No
// atomics: the sums are the same from run to run.
//
// A run longer than LONG_RUN is not walked by its own lane: the warp takes
// such runs one at a time (ballot), all 32 lanes stride through the run
// together and a shuffle tree adds their partial sums.
//
// Bound on the H100: memory. The function reads the rows that lie in some
// run (C x covered pairs) and the two bounds, and writes out (C x S), 4
// bytes an element.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int LONG_RUN = 32;
constexpr int ROWS = 5;
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(THREADS)
    segsum_kernel(const float* __restrict__ rows,
                  const int* __restrict__ starts, const int* __restrict__ ends,
                  float* __restrict__ out, int nrows, long long p_len,
                  int num_seg) {
  const int lane = threadIdx.x & 31;
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  // Every lane of a warp stays in the loop below (shuffles need them), so
  // lanes past num_seg take an empty run.
  const bool live = i < num_seg;
  long long lo = 0, hi = 0;
  if (live) {
    lo = min(max((long long)starts[i], 0LL), p_len);
    hi = min(max((long long)ends[i], lo), p_len);
  }
  const bool is_long = hi - lo > LONG_RUN;

  // ROWS rows are summed together, so that many loads are in flight at
  // once instead of one.
  if (live && !is_long) {
    for (int c0 = 0; c0 < nrows; c0 += ROWS) {
      float s[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) s[r] = 0.0f;
      for (long long p = lo; p < hi; ++p) {
#pragma unroll
        for (int r = 0; r < ROWS; ++r)
          if (c0 + r < nrows)
            s[r] += __ldg(rows + (long long)(c0 + r) * p_len + p);
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
        if (c0 + r < nrows) out[(long long)(c0 + r) * num_seg + i] = s[r];
    }
  }

  unsigned pending = __ballot_sync(FULL, is_long);
  while (pending) {
    const int src = __ffs(pending) - 1;
    pending &= pending - 1;
    const long long lo_s = __shfl_sync(FULL, lo, src);
    const long long hi_s = __shfl_sync(FULL, hi, src);
    for (int c0 = 0; c0 < nrows; c0 += ROWS) {
      float s[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) s[r] = 0.0f;
      for (long long p = lo_s + lane; p < hi_s; p += 32) {
#pragma unroll
        for (int r = 0; r < ROWS; ++r)
          if (c0 + r < nrows)
            s[r] += __ldg(rows + (long long)(c0 + r) * p_len + p);
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          s[r] += __shfl_xor_sync(FULL, s[r], off);
        if (lane == src && c0 + r < nrows)
          out[(long long)(c0 + r) * num_seg + i] = s[r];
      }
    }
  }
}

}  // namespace

// rows (nrows, p_len) float32, starts and ends (num_seg,) int32 (clipped to
// [0, p_len] here), out (nrows, num_seg) float32, every element written.
SG_EXPORT int sg_segment_rowsum(const float* rows, const int* starts,
                                const int* ends, float* out, int nrows,
                                long long p_len, int num_seg, void* stream) {
  if (num_seg <= 0 || nrows <= 0) return 0;
  if (p_len < 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = ((long long)num_seg + THREADS - 1) / THREADS;
  segsum_kernel<<<(unsigned)blocks, THREADS, 0,
                  static_cast<cudaStream_t>(stream)>>>(rows, starts, ends, out,
                                                       nrows, p_len, num_seg);
  return sg_last_error();
}
