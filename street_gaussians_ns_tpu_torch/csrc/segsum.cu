// Kernel G: segmented row sum. out[c, i] = sum of rows[c, p] over
// p in [starts[i], ends[i]), for contiguous, ascending, non-overlapping
// runs; empty runs (start == end) may stand anywhere with any start and
// give 0; runs may leave gaps; the bounds are clipped to [0, P].
//
// Replaces street_gaussians_ns_tpu/ops/segreduce_pallas.py:_segsum_kernel,
// which builds a one-hot from the run bounds per block of 2048 segments
// and contracts it with the pair chunk on the MXU (bf16 inputs), because
// the MXU is the TPU's only fast reducer.
//
// Bound on the H100: memory. The function reads the rows that lie in some
// run (C x covered pairs) and the two bounds, and writes out (C x S), 4
// bytes an element. The unfused backward calls it on (10, 3,991,531)
// covered rows and 1,310,720 segments, a quarter of them empty and the
// non-empty ones ~4 pairs long (the longest 665). The first version ran a
// thread per segment, each walking its own run with 4-byte loads, so a
// warp's 32 loads went to 32 different runs and its lanes idled on short
// ones. This version walks the pairs coalesced, with kernel F's segmented
// scan (ranksum.cu), without F's search, because the run heads come from
// `starts`:
//
//   * block b takes the GROUP consecutive segments [b GROUP, (b + 1) GROUP)
//     and their span [S, E): S the first pair, E one past the last pair,
//     of its non-empty runs (empty runs, wherever they stand, are left out
//     of the span and written as 0 by the thread that loaded them);
//   * the span is cut into windows of CHUNK = 32 x ITEMS pairs, and the
//     block's warps take the windows in turn. A window owns the runs whose
//     first pair lies in it and sums them whole: from its first run head
//     to the end of its last run, CHUNK pairs at a time (a lane reads
//     ITEMS consecutive pairs of each row: a warp's loads are 512
//     contiguous bytes), past the window's end where its last run goes on.
//     So the spans' work spreads over the warps by pairs, not by segments:
//     a group whose span is 10,000 pairs long (a cluster of gaussians over
//     hundreds of tiles each) is 80 windows over 4 warps, not one thread
//     walking each run alone, and no warp waits at a block barrier;
//   * in each CHUNK the warp marks its runs' heads and ends (in shared
//     memory of its own), and a segmented scan keyed on the heads (in the
//     lane, then shuffles over the warp, then one carry to the next CHUNK)
//     sums each run in one fixed order; the lane holding a run's last pair
//     writes its sum. Pairs in a gap between runs ride on the run before
//     them, which has already been written, until the next head resets it.
//
// Every output column is written exactly once, so the kernel needs no
// memset and no atomics, and two launches give the same bits.
// tests/test_torch_redesign_gh.py holds a numpy model of this order, which
// the card's result equals bit for bit.
#include "common.cuh"

#include <limits.h>

namespace {

constexpr int THREADS = 128;
constexpr int ITEMS = 4;                       // pairs a lane, a chunk
constexpr int CHUNK = 32 * ITEMS;              // pairs a warp, a chunk
constexpr int GROUP = 128;                     // segments a block
constexpr int ROWS = 5;                        // rows summed in one pass
constexpr int MIN_BLOCKS = 5;                  // blocks an SM: <= 102 registers
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    segsum_kernel(const float* __restrict__ rows,
                  const int* __restrict__ starts, const int* __restrict__ ends,
                  float* __restrict__ out, int nrows, int p_len,
                  int num_seg) {
  __shared__ int s_lo[GROUP], s_hi[GROUP];
  __shared__ int s_min[WARPS], s_max[WARPS];
  __shared__ bool s_head[WARPS][CHUNK];
  __shared__ int s_tail[WARPS][CHUNK];  // the group's segment ending here
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long g0 = (long long)blockIdx.x * GROUP;
  const int nseg = (int)min((long long)GROUP, num_seg - g0);

  int lo_min = INT_MAX, hi_max = INT_MIN;
  for (int k = tid; k < GROUP; k += THREADS) {
    int lo = 0, hi = 0;
    if (k < nseg) {
      lo = min(max(__ldg(starts + g0 + k), 0), p_len);
      hi = min(max(__ldg(ends + g0 + k), lo), p_len);
      if (hi == lo) {
        for (int c = 0; c < nrows; ++c)
          out[(long long)c * num_seg + g0 + k] = 0.0f;
      } else {
        lo_min = min(lo_min, lo);
        hi_max = max(hi_max, hi);
      }
    }
    s_lo[k] = lo;
    s_hi[k] = hi;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    lo_min = min(lo_min, __shfl_xor_sync(FULL, lo_min, off));
    hi_max = max(hi_max, __shfl_xor_sync(FULL, hi_max, off));
  }
  if (lane == 0) {
    s_min[warp] = lo_min;
    s_max[warp] = hi_max;
  }
  __syncthreads();
  int s = INT_MAX, e = INT_MIN;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    s = min(s, s_min[w]);
    e = max(e, s_max[w]);
  }
  // Every run of the group empty: s > e, no window.
  const long long nwin = s < e ? ((long long)e - s + CHUNK - 1) / CHUNK : 0;
  bool* mark_head = s_head[warp];
  int* mark_tail = s_tail[warp];

  for (long long j = warp; j < nwin; j += WARPS) {
    // The runs this window owns: their heads lie in [w0, w1).
    // They are the non-empty segments of one range [k_lo, k_hi] of the
    // group; the pairs [first, last) hold them and the gaps between.
    const int w0 = s + (int)j * CHUNK;
    const int w1 = (int)min((long long)w0 + CHUNK, (long long)INT_MAX);
    int first = INT_MAX, last = -1, k_lo = GROUP, k_hi = -1;
    for (int k = lane; k < nseg; k += 32) {
      const int lo = s_lo[k], hi = s_hi[k];
      if (hi > lo && lo >= w0 && lo < w1) {
        first = min(first, lo);
        last = max(last, hi);
        k_lo = min(k_lo, k);
        k_hi = max(k_hi, k);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      first = min(first, __shfl_xor_sync(FULL, first, off));
      last = max(last, __shfl_xor_sync(FULL, last, off));
      k_lo = min(k_lo, __shfl_xor_sync(FULL, k_lo, off));
      k_hi = max(k_hi, __shfl_xor_sync(FULL, k_hi, off));
    }
    if (last < 0) continue;    // inside a run that started before

    for (int c0 = 0; c0 < nrows; c0 += ROWS) {
      float carry[ROWS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) carry[i] = 0.0f;
      for (int u0 = first; u0 < last; u0 += CHUNK) {
        // The rows first (they do not wait for the marks).
        const int base = u0 + lane * ITEMS;
        float v[ITEMS][ROWS];
#pragma unroll
        for (int k = 0; k < ITEMS; ++k)
#pragma unroll
          for (int i = 0; i < ROWS; ++i)
            v[k][i] = (base + k < last && c0 + i < nrows)
                          ? __ldg(rows + (long long)(c0 + i) * p_len + base + k)
                          : 0.0f;
#pragma unroll
        for (int k = 0; k < ITEMS; ++k) {
          mark_head[lane * ITEMS + k] = false;
          mark_tail[lane * ITEMS + k] = -1;
        }
        __syncwarp();
        for (int k = k_lo + lane; k <= k_hi; k += 32) {
          const int lo = s_lo[k], hi = s_hi[k];
          if (hi > lo) {
            if (lo >= u0 && lo - u0 < CHUNK) mark_head[lo - u0] = true;
            if (hi - 1 >= u0 && hi - 1 - u0 < CHUNK) mark_tail[hi - 1 - u0] = k;
          }
        }
        __syncwarp();
        bool head[ITEMS];
        int tail[ITEMS];
        bool has_head = false;
#pragma unroll
        for (int k = 0; k < ITEMS; ++k) {
          const bool valid = base + k < last;
          head[k] = valid && mark_head[lane * ITEMS + k];
          tail[k] = valid ? mark_tail[lane * ITEMS + k] : -1;
          has_head = has_head || head[k];
        }
        __syncwarp();

        // The lane's sum from its last run head (all its items if none).
        float agg[ROWS];
#pragma unroll
        for (int i = 0; i < ROWS; ++i) {
          agg[i] = 0.0f;
#pragma unroll
          for (int k = 0; k < ITEMS; ++k)
            agg[i] = head[k] ? v[k][i] : agg[i] + v[k][i];
        }
        // Inclusive segmented scan over the lanes: a lane adds the partial
        // sum `off` lanes before it unless a head lies between.
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
        // The open run arriving at this lane: the chunk's carry, then the
        // lanes before it.
        const bool ex_f = __shfl_up_sync(FULL, (int)f, 1) != 0;
        float run[ROWS];
#pragma unroll
        for (int i = 0; i < ROWS; ++i) {
          const float ex = __shfl_up_sync(FULL, a[i], 1);
          run[i] = lane == 0 ? carry[i] : (ex_f ? ex : carry[i] + ex);
        }
#pragma unroll
        for (int i = 0; i < ROWS; ++i) {
          const float out_i = has_head ? agg[i] : run[i] + agg[i];
          carry[i] = __shfl_sync(FULL, out_i, 31);
        }
#pragma unroll
        for (int k = 0; k < ITEMS; ++k) {
#pragma unroll
          for (int i = 0; i < ROWS; ++i)
            run[i] = head[k] ? v[k][i] : run[i] + v[k][i];
          if (tail[k] >= 0) {
#pragma unroll
            for (int i = 0; i < ROWS; ++i)
              if (c0 + i < nrows)
                out[(long long)(c0 + i) * num_seg + g0 + tail[k]] = run[i];
          }
        }
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
  if (p_len < 0 || p_len > INT_MAX - 2 * CHUNK)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = ((long long)num_seg + GROUP - 1) / GROUP;
  segsum_kernel<<<(unsigned)blocks, THREADS, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      rows, starts, ends, out, nrows, (int)p_len, num_seg);
  return sg_last_error();
}
