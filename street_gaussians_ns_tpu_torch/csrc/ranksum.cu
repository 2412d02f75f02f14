// Kernel F: rank-keyed row sum. out[c, r] = sum of rows[c, p] over the pairs
// p with ranks[p] == r, for r in [0, num_out); ranks are sorted ascending
// in [0, num_out], and rank num_out is the discard bucket, never written.
//
// Replaces street_gaussians_ns_tpu/ops/segreduce_pallas.py:_ranksum_kernel,
// which builds a rank-equality one-hot per block of 2048 ranks and
// contracts it with the pair chunk on the MXU, because the MXU is the TPU's
// only fast reducer and its gathers are slow. On the GPU the sorted ranks
// make every output's pairs one contiguous run [lo, hi): one thread per
// output rank finds lo by binary search of `ranks` (hi is the next lane's
// lo, by shuffle) and sums its run in pair order, row by row. Lanes of a
// warp hold neighbouring ranks, so their runs are neighbouring spans of
// every row and the stores are coalesced along the rank axis. No atomics:
// the sums are the same from run to run.
//
// The tail. A rank that has pairs owns a dozen or so on average, but a
// gaussian that covers the screen owns thousands. A run longer than
// LONG_RUN is not walked by its
// own lane: the warp takes such runs one at a time (ballot), all 32 lanes
// stride through the run together and a shuffle tree adds their partial
// sums, so the longest run costs len / 32 steps of a warp, not len steps of
// one thread.
//
// Bound on the H100: memory. The function reads rows (C x P, the rank row
// included) and writes out ((C - 1) x num_out), 4 bytes an element; the
// binary searches re-read `ranks` about log2(P) times per output, mostly
// from L2.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int LONG_RUN = 32;
constexpr int ROWS = 5;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ long long lower_bound(const int* __restrict__ ranks,
                                                 long long p_len, int key) {
  long long lo = 0, hi = p_len;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (__ldg(ranks + mid) < key)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(THREADS)
    ranksum_kernel(const float* __restrict__ rows,
                   const int* __restrict__ ranks, float* __restrict__ out,
                   int ng, long long p_len, int num_out) {
  const int lane = threadIdx.x & 31;
  const long long r = (long long)blockIdx.x * THREADS + threadIdx.x;
  // Every lane of a warp stays in the loop below (shuffles need them), so
  // lanes past num_out take an empty run.
  const bool live = r < num_out;
  const long long lo = live ? lower_bound(ranks, p_len, (int)r) : p_len;
  long long hi = __shfl_down_sync(FULL, lo, 1);
  if (lane == 31 || r + 1 >= num_out)
    hi = live ? lower_bound(ranks, p_len, (int)r + 1) : p_len;
  const long long len = hi - lo;
  const bool is_long = len > LONG_RUN;

  // ROWS rows are summed together, so that many loads are in flight at
  // once instead of one.
  if (live && !is_long) {
    for (int c0 = 0; c0 < ng; c0 += ROWS) {
      float s[ROWS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) s[i] = 0.0f;
      for (long long p = lo; p < hi; ++p) {
#pragma unroll
        for (int i = 0; i < ROWS; ++i)
          if (c0 + i < ng)
            s[i] += __ldg(rows + (long long)(c0 + i) * p_len + p);
      }
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
        if (c0 + i < ng) out[(long long)(c0 + i) * num_out + r] = s[i];
    }
  }

  unsigned pending = __ballot_sync(FULL, is_long);
  while (pending) {
    const int src = __ffs(pending) - 1;
    pending &= pending - 1;
    const long long lo_s = __shfl_sync(FULL, lo, src);
    const long long hi_s = __shfl_sync(FULL, hi, src);
    for (int c0 = 0; c0 < ng; c0 += ROWS) {
      float s[ROWS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) s[i] = 0.0f;
      for (long long p = lo_s + lane; p < hi_s; p += 32) {
#pragma unroll
        for (int i = 0; i < ROWS; ++i)
          if (c0 + i < ng)
            s[i] += __ldg(rows + (long long)(c0 + i) * p_len + p);
      }
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          s[i] += __shfl_xor_sync(FULL, s[i], off);
        if (lane == src && c0 + i < ng)
          out[(long long)(c0 + i) * num_out + r] = s[i];
      }
    }
  }
}

}  // namespace

// rows (ng + 1, p_len) float32 (only the first ng rows are read), ranks
// (p_len,) int32 sorted ascending, out (ng, num_out) float32, every element
// written.
SG_EXPORT int sg_rank_rowsum(const float* rows, const int* ranks, float* out,
                             int ng, long long p_len, int num_out,
                             void* stream) {
  if (num_out <= 0 || ng <= 0) return 0;
  if (p_len < 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = ((long long)num_out + THREADS - 1) / THREADS;
  ranksum_kernel<<<(unsigned)blocks, THREADS, 0,
                   static_cast<cudaStream_t>(stream)>>>(rows, ranks, out, ng,
                                                        p_len, num_out);
  return sg_last_error();
}
