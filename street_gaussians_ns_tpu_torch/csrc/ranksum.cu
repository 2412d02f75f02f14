// Kernel F: rank-keyed row sum. out[c, r] = sum of rows[c, p] over the pairs
// p with ranks[p] == r, for r in [0, num_out); ranks are sorted ascending
// in [0, num_out], and rank num_out is the discard bucket, never written.
//
// Replaces street_gaussians_ns_tpu/ops/segreduce_pallas.py:_ranksum_kernel,
// which builds a rank-equality one-hot per block of 2048 ranks and
// contracts it with the pair chunk on the MXU, because the MXU is the TPU's
// only fast reducer and its gathers are slow. On the GPU the sorted ranks
// make every output's pairs one contiguous run.
//
// Bound on the H100: memory. The function reads rows (C x P, the rank row
// included) and writes out ((C - 1) x num_out), 4 bytes an element. At full
// width only 48,402 of 1,310,720 ranks own pairs, so the output is mostly
// zeros and the pairs are few (789,517). The first version launched a
// thread per output rank: every thread binary-searched `ranks` (20
// dependent loads), and each lane with pairs walked its own run one 4-byte
// load at a time, so a warp's loads neither coalesced nor overlapped. This
// version launches over the pairs:
//
//   * The output is zeroed by a memset, at the copy rate, and the kernel
//     writes only the ranks that own pairs.
//   * Block b owns the runs whose first pair lies in its nominal span
//     [b BLOCK_PAIRS, (b + 1) BLOCK_PAIRS): it starts at the first run
//     head at or after the span's start and ends at the first one at or
//     after its end, so a run that crosses a span boundary is summed whole
//     by one block, and a run longer than a span (a gaussian over thousands
//     of tiles) by the block of its head, a window after another; blocks
//     inside such a run do nothing. A warp finds each bound with a 32-way
//     search that probes the 32 pairs at the span's edge first.
//   * A window of THREADS x ITEMS consecutive pairs at a time: a thread
//     reads ITEMS consecutive pairs of each row (a warp's loads are 512
//     contiguous bytes), sums its items in order, and a segmented scan
//     keyed on run heads (ranks[p] != ranks[p - 1]) carries the open run
//     across the threads of a warp (shuffles), the warps of the block
//     (shared memory, in warp order) and the windows (one carry). The
//     thread that holds a run's last pair writes its sum.
//
// Every sum is taken in one fixed order, set by the data alone, and no
// two blocks write one rank, so the kernel needs no atomics and two
// launches give the same bits. tests/test_torch_redesign_df.py holds a
// numpy model of this order, which the card's result equals bit for bit.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int ITEMS = 4;                       // pairs a thread, a window
constexpr int WINDOW = THREADS * ITEMS;        // pairs a block, a window
constexpr int BLOCK_PAIRS = WINDOW;            // a block's nominal span
constexpr int ROWS = 5;                        // rows summed in one pass
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

// The first p >= q that starts a run (p == 0, or ranks[p] > ranks[p - 1]),
// or p_len; the same in every lane of the calling warp. The first round
// probes q .. q + 31, where the answer lies unless q is inside a long run;
// until a probe lands past the run, each round probes 32 times as far
// apart (q + 32 .. q + 1,023, then .. q + 32,767), and from then on each
// round narrows the interval 32-fold.
__device__ long long first_head(const int* __restrict__ ranks,
                                long long p_len, long long q, int lane) {
  if (q <= 0) return 0;
  if (q >= p_len) return p_len;
  const int key = __ldg(ranks + q - 1);
  // The answer is the first p in [lo, hi] with ranks[p] > key (p_len: none).
  long long lo = q, hi = p_len, step = 1;
  bool bracketed = false;
  while (lo < hi) {
    const long long pos = lo + lane * step;
    const unsigned past =
        __ballot_sync(FULL, pos < hi && __ldg(ranks + pos) > key);
    if (past & 1u) return lo;
    if (past) {
      const int f = __ffs(past) - 1;
      hi = lo + f * step;
      lo += (f - 1) * step + 1;
      bracketed = true;
    } else {
      lo += min(31LL, (hi - 1 - lo) / step) * step + 1;
    }
    const long long even = max(1LL, (hi - lo + 31) / 32);
    step = bracketed ? even : min(step * 32, even);
  }
  return lo;
}

__global__ void __launch_bounds__(THREADS)
    ranksum_kernel(const float* __restrict__ rows,
                   const int* __restrict__ ranks, float* __restrict__ out,
                   int ng, long long p_len, int num_out) {
  __shared__ long long range[2];
  __shared__ bool warp_head[WARPS];
  __shared__ float warp_sum[WARPS][ROWS];
  __shared__ float carry[ROWS];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (warp < 2) {
    const long long q =
        min((long long)(blockIdx.x + warp) * BLOCK_PAIRS, p_len);
    const long long h = first_head(ranks, p_len, q, lane);
    if (lane == 0) range[warp] = h;
  }
  __syncthreads();
  const long long s = range[0], e = range[1];
  if (s >= e) return;

  for (int c0 = 0; c0 < ng; c0 += ROWS) {
    for (long long w0 = s; w0 < e; w0 += WINDOW) {
      const long long base = w0 + (long long)tid * ITEMS;
      // Run heads and tails among the thread's items; -1 stands for a pair
      // outside [s, e), which differs from every rank.
      int r[ITEMS];
#pragma unroll
      for (int k = 0; k < ITEMS; ++k)
        r[k] = base + k < e ? __ldg(ranks + base + k) : -1;
      const int prev = (base > s && base < e) ? __ldg(ranks + base - 1) : -1;
      const int next = base + ITEMS < e ? __ldg(ranks + base + ITEMS) : -1;
      bool head[ITEMS], tail[ITEMS];
      bool has_head = false;
#pragma unroll
      for (int k = 0; k < ITEMS; ++k) {
        const bool valid = base + k < e;
        head[k] = valid && r[k] != (k == 0 ? prev : r[k - 1]);
        tail[k] = valid && r[k] != (k + 1 < ITEMS ? r[k + 1] : next);
        has_head = has_head || head[k];
      }
      float v[ITEMS][ROWS];
#pragma unroll
      for (int k = 0; k < ITEMS; ++k)
#pragma unroll
        for (int i = 0; i < ROWS; ++i)
          v[k][i] = (base + k < e && c0 + i < ng)
                        ? __ldg(rows + (long long)(c0 + i) * p_len + base + k)
                        : 0.0f;

      // The thread's sum from its last run head (all its items if none).
      float agg[ROWS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        agg[i] = 0.0f;
#pragma unroll
        for (int k = 0; k < ITEMS; ++k)
          agg[i] = head[k] ? v[k][i] : agg[i] + v[k][i];
      }

      // Inclusive segmented scan over the warp's threads: a thread adds
      // the partial sum `off` lanes before it unless a head lies between.
      bool f = has_head;
      float a[ROWS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) a[i] = agg[i];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const bool f_up = __shfl_up_sync(FULL, (int)f, off) != 0;
#pragma unroll
        for (int i = 0; i < ROWS; ++i) {
          const float a_up = __shfl_up_sync(FULL, a[i], off);
          if (lane >= off && !f) a[i] = a_up + a[i];
        }
        if (lane >= off) f = f || f_up;
      }
      const bool ex_f = __shfl_up_sync(FULL, (int)f, 1) != 0;
      float ex[ROWS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) ex[i] = __shfl_up_sync(FULL, a[i], 1);
      if (lane == 31) {
        warp_head[warp] = f;
#pragma unroll
        for (int i = 0; i < ROWS; ++i) warp_sum[warp][i] = a[i];
      }
      __syncthreads();

      // The open run arriving at this thread: the window's carry, then the
      // warps before this one in order, then the lanes before it.
      float run[ROWS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        float wc = w0 == s ? 0.0f : carry[i];
        for (int w = 0; w < warp; ++w)
          wc = warp_head[w] ? warp_sum[w][i] : wc + warp_sum[w][i];
        run[i] = lane == 0 ? wc : (ex_f ? ex[i] : wc + ex[i]);
      }
      float carry_out[ROWS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
        carry_out[i] = has_head ? agg[i] : run[i] + agg[i];
#pragma unroll
      for (int k = 0; k < ITEMS; ++k) {
#pragma unroll
        for (int i = 0; i < ROWS; ++i)
          run[i] = head[k] ? v[k][i] : run[i] + v[k][i];
        if (tail[k] && (unsigned)r[k] < (unsigned)num_out) {
#pragma unroll
          for (int i = 0; i < ROWS; ++i)
            if (c0 + i < ng) out[(long long)(c0 + i) * num_out + r[k]] = run[i];
        }
      }
      // Everyone has read `carry` and the warp sums; the last thread hands
      // the open run on to the next window.
      __syncthreads();
      if (tid == THREADS - 1) {
#pragma unroll
        for (int i = 0; i < ROWS; ++i) carry[i] = carry_out[i];
      }
    }
  }
}

}  // namespace

// rows (ng + 1, p_len) float32 (only the first ng rows are read), ranks
// (p_len,) int32 sorted ascending, out (ng, num_out) float32, every element
// written: a memset, then the kernel over the ranks that own pairs.
SG_EXPORT int sg_rank_rowsum(const float* rows, const int* ranks, float* out,
                             int ng, long long p_len, int num_out,
                             void* stream) {
  if (num_out <= 0 || ng <= 0) return 0;
  if (p_len < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = cudaMemsetAsync(
      out, 0, sizeof(float) * (size_t)ng * (size_t)num_out, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (p_len == 0) return 0;
  const long long blocks = (p_len + BLOCK_PAIRS - 1) / BLOCK_PAIRS;
  ranksum_kernel<<<(unsigned)blocks, THREADS, 0, s>>>(rows, ranks, out, ng,
                                                      p_len, num_out);
  return sg_last_error();
}
