// Kernel D: forward tile compositor.
//
// Replaces street_gaussians_ns_tpu/ops/composite_pallas.py:_fwd_kernel
// in both its modes. One CTA per 16x16 tile walks the tile's sorted pair
// range [tile_start, tile_start + tile_count) of the (rows, 16, 128)
// feature stream front to back, with the oracle's rules
// (ops/rasterize_ref.py):
//   sigma  = 0.5 (a dx^2 + c dy^2) + b dx dy,  (dx, dy) = center - pixel
//   alpha  = min(0.999, opacity * exp(-max(sigma, 0)))
//   skip the pair if sigma < -1e-3 or alpha < 1/255
//   next_T = T (1 - alpha); if next_T <= 1e-4 the pixel is done, before
//   accumulating, and stays done
//   accum += colour * alpha * T; T = next_T; n_contrib = pair index + 1
// The TPU kernel evaluates the chunk in log space
// (T = exp(cumsum(log1p(-alpha))), T_before = T / (1 - alpha)); this one
// keeps a running product per pixel, which is exact in the order of the
// pairs and never divides. sigma, alpha, the T (1 - alpha) update and the
// termination test are common.cuh's and free of fused multiply-adds (the
// build's -fmad=false): kernel E replays them from the same stream and
// must take this kernel's branch at every (pixel, pair).
//
// Continuation (TIN, the TPU kernel's with_tin): a depth-sliced route
// composites one depth-rank window after another, and a later window's
// launch starts every pixel from the transmittance `tin` the earlier ones
// left (done where tin <= 1e-4) instead of 1. The accumulated colours then
// come out premultiplied by the whole chain, the windows' outputs simply
// add, and a pixel that the earlier windows saturated does no work: the
// CTA's exit count sees it as done from the start. A tile of count 0 still
// writes T_final = tin and n_contrib = 0; n_contrib counts within the
// window. The mode is a template parameter, so a launch without `tin` runs
// no code of it.
//
// The done state crosses windows in the sign of the transmittance. A pixel
// is done when a pair would push its T to 1e-4 or below, and it keeps the T
// it had before that pair, which is above 1e-4: the magnitude alone cannot
// tell the next window that the pixel has ended. With mark_done the kernel
// writes T_final negated for the pixels that are done, and a `tin` value
// that is negative (or <= 1e-4, the TPU kernel's own test) starts its pixel
// done with T = |tin|. The chain of windows then ends every pixel where
// the single launch over all pairs ends it.
//
// Strips (tile0): the CTA's tile is blockIdx.x + tile0 of the image grid
// (its pixel coordinates), while tile_start / tile_count and the outputs
// are indexed by blockIdx.x: a caller composites tiles [tile0, tile0 + n)
// by passing that slice of the ranges.
//
// Bound on the H100: the larger of the bytes (the pairs the tiles need,
// 6 + NC feature rows each, read once, plus the outputs) and about 16
// float32 operations with one exp per evaluated (pixel, pair); both are
// counted into `evals` when it is non-null. At full width the operations
// are the larger, by 2x. What bounds the kernel is instruction issue:
// nearly every issued instruction is a (pixel, pair) evaluation or its
// overhead, and the first version (one pixel a thread, 256 threads a
// tile, pairs staged 256 at a time) spent 11% of its time on 5 + NC
// separate shared-memory loads a pixel and pair, and formed each pixel's
// dx terms and loop overhead on its own. This version:
//
//   * PPT = 4 pixels a thread, 64 threads (two warps) a tile. A thread's
//     pixels share their column (rows r, r + 4, r + 8, r + 12), so dx and
//     the products of dx in sigma are formed once for four pixels, and a
//     pair's features are fetched once a thread, not once a pixel: a
//     pair's 6 + NC features lie together in shared memory (12 floats) and
//     come in three 16-byte loads that every lane shares.
//   * sigma and alpha of the four pixels are formed before any branch, so
//     four independent exp chains are in flight, and the rest of the step
//     is selects: the two skip tests, the termination test and the
//     updates. The colour sums use explicit fused multiply-adds (they take
//     no part in any branch); T, sigma and alpha do not.
//   * Batches of 64 pairs, and a warp leaves a batch as soon as all 128 of
//     its pixels are done (one vote a pair); the CTA leaves the tile at the
//     batch's end when both warps are done (__syncthreads_count).
//   * cp.async double buffering and issuing the deepest tiles first were
//     measured on kernel E and bought 3% or less; they are not here. Nor
//     are two warp-wide shortcuts that leave a pair early when it is far
//     from every live pixel of the warp, or when none of them considers
//     it: on the flagship frame's wide gaussians they are rarely taken and
//     cost more than they save (bwd_ablation.py --kernel fwd, PERF.md).
//
// No atomics outside the `evals` measurement aid: each pixel's outputs are
// written by its own thread, so two launches give the same bits and a
// tile0 strip gives the bits of the full launch.
#include "common.cuh"

namespace {

constexpr int TILE = 16;
constexpr int PIX = TILE * TILE;
constexpr int NFEAT = 16;
constexpr int K = 128;
constexpr int BATCH = 64;
constexpr int PPT = 4;                  // pixels a thread
constexpr int THREADS = PIX / PPT;       // threads a tile
constexpr int WARPS = THREADS / 32;
constexpr int SLOT = 12;                 // floats a staged pair takes
constexpr unsigned FULL = 0xffffffffu;
static_assert(PPT == 1 || PPT == 2 || PPT == 4, "1, 2 or 4 pixels a thread");

// c + a * b of the colour sums, fused: the file is built without
// multiply-add contraction, so that sigma, alpha and T round as the plain
// version does, and only the colour sums say so themselves.
__device__ __forceinline__ float muladd(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}

template <int NC, bool TIN, bool COUNT>
__global__ void __launch_bounds__(THREADS)
    composite_fwd_kernel(const float* __restrict__ feat,
                         const int* __restrict__ tile_start,
                         const int* __restrict__ tile_count, int ntx,
                         int tile0, const float* __restrict__ tin,
                         int mark_done, float* __restrict__ accum,
                         float* __restrict__ tfin,
                         int* __restrict__ ncon,
                         unsigned long long* __restrict__ evals) {
  constexpr int NG = 6 + NC;
  __shared__ __align__(16) float sm[BATCH][SLOT];
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const long long start = tile_start[t];
  const int count = tile_count[t];
  const int tg = t + tile0;
  const float px = (float)((tg % ntx) * TILE + (tid % TILE)) + 0.5f;

  // Pixel k of this thread is tile pixel k * THREADS + tid: its column is
  // the thread's, its row THREADS / 16 below the one before.
  float py[PPT], T[PPT], acc[PPT][NC];
  int last[PPT];
  bool done[PPT];
  unsigned int nev[PPT];
  bool all_done = true;
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int lp = k * THREADS + tid;
    py[k] = (float)((tg / ntx) * TILE + (lp / TILE)) + 0.5f;
    T[k] = 1.0f;
    done[k] = false;
    if (TIN) {
      const float v = tin[(long long)t * PIX + lp];
      T[k] = fabsf(v);
      done[k] = v <= SG_T_EPS;
    }
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[k][c] = 0.0f;
    last[k] = 0;
    nev[k] = 0;
    all_done = all_done && done[k];
  }

  for (int b0 = 0; b0 < count; b0 += BATCH) {
    const int nb = min(BATCH, count - b0);
    for (int i = tid; i < nb; i += THREADS) {
      const long long p = start + b0 + i;
      const float* src = feat + (p / K) * (NFEAT * K) + (p % K);
#pragma unroll
      for (int f = 0; f < NG; ++f) sm[i][f] = __ldg(src + f * K);
    }
    __syncthreads();
    for (int j = 0; j < nb; ++j) {
      // Every lane of the warp votes, so the warp leaves together.
      if (__all_sync(FULL, all_done)) break;
      const float4 f0 = *reinterpret_cast<const float4*>(&sm[j][0]);
      const float4 f1 = *reinterpret_cast<const float4*>(&sm[j][4]);
      const float4 f2 = NG > 8 ? *reinterpret_cast<const float4*>(&sm[j][8])
                               : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      const float col[4] = {f1.z, f1.w, f2.x, f2.y};
      float sigma[PPT], alpha[PPT];
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        float dx, dy, falloff;
        sigma[k] = sg_sigma(f0.x, f0.y, f0.z, f0.w, f1.x, px, py[k], dx, dy);
        alpha[k] = sg_alpha(f1.y, sigma[k], falloff);
      }
      all_done = true;
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        const bool live = !done[k];
        const bool considered = live && !(sigma[k] < SG_SIGMA_MIN) &&
                                !(alpha[k] < SG_ALPHA_THRESH);
        const float next_T = T[k] * (1.0f - alpha[k]);
        const bool ends = considered && next_T <= SG_T_EPS;
        const bool c = considered && !ends;
        const float w = c ? alpha[k] * T[k] : 0.0f;
#pragma unroll
        for (int ch = 0; ch < NC; ++ch)
          acc[k][ch] = muladd(col[ch], w, acc[k][ch]);
        T[k] = c ? next_T : T[k];
        last[k] = c ? b0 + j + 1 : last[k];
        done[k] = done[k] || ends;
        all_done = all_done && done[k];
        if (COUNT) nev[k] += live;
      }
    }
    // Barrier before the next batch overwrites sm; exit once all are done.
    if (__syncthreads_count(!all_done) == 0) break;
  }

#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const long long o = (long long)t * PIX + k * THREADS + tid;
#pragma unroll
    for (int c = 0; c < NC; ++c) accum[o * NC + c] = acc[k][c];
    tfin[o] = (mark_done && done[k]) ? -T[k] : T[k];
    ncon[o] = last[k];
  }

  // Measurement aid: evals[0] += evaluated (pixel, pair)s; evals[1] += the
  // pairs this tile needed, the most any of its pixels evaluated (a pixel
  // evaluates pairs 0, 1, ... without gaps until it is done), and
  // evals[2 + t] = the same for this tile alone.
  if (COUNT) {
    __shared__ unsigned int warp_need[WARPS];
    unsigned int need = 0;
    unsigned long long v = 0;
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      need = max(need, nev[k]);
      v += nev[k];
    }
    need = __reduce_max_sync(FULL, need);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(FULL, v, off);
    if ((tid & 31) == 0) {
      atomicAdd(evals, v);
      warp_need[tid >> 5] = need;
    }
    __syncthreads();
    if (tid == 0) {
      unsigned int tile_need = warp_need[0];
#pragma unroll
      for (int w = 1; w < WARPS; ++w) tile_need = max(tile_need, warp_need[w]);
      atomicAdd(evals + 1, (unsigned long long)tile_need);
      evals[2 + t] = tile_need;
    }
  }
}

template <int NC, bool TIN, bool COUNT>
void launch_mode(const float* feat, const int* tile_start,
                 const int* tile_count, int num_tiles, int ntx, int tile0,
                 const float* tin, int mark_done, float* accum, float* tfin,
                 int* ncon, unsigned long long* evals, cudaStream_t s) {
  composite_fwd_kernel<NC, TIN, COUNT><<<num_tiles, THREADS, 0, s>>>(
      feat, tile_start, tile_count, ntx, tile0, tin, mark_done, accum, tfin,
      ncon, evals);
}

template <int NC>
void launch(const float* feat, const int* tile_start, const int* tile_count,
            int num_tiles, int ntx, int tile0, const float* tin,
            int mark_done, float* accum, float* tfin, int* ncon,
            unsigned long long* evals, cudaStream_t s) {
  auto fn = tin != nullptr
                ? (evals != nullptr ? launch_mode<NC, true, true>
                                    : launch_mode<NC, true, false>)
                : (evals != nullptr ? launch_mode<NC, false, true>
                                    : launch_mode<NC, false, false>);
  fn(feat, tile_start, tile_count, num_tiles, ntx, tile0, tin, mark_done,
     accum, tfin, ncon, evals, s);
}

}  // namespace

// accum (num_tiles, 256, nc), tfin (num_tiles, 256) float32, ncon
// (num_tiles, 256) int32; tin (num_tiles, 256) float32 and evals (2 +
// num_tiles uint64) are optional (null = off).
SG_EXPORT int sg_composite_fwd(const float* feat, const int* tile_start,
                               const int* tile_count, int num_tiles, int ntx,
                               int nc, int tile0, const float* tin,
                               int mark_done, float* accum, float* tfin,
                               int* ncon,
                               unsigned long long* evals, void* stream) {
  if (num_tiles <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nc) {
    case 1:
      launch<1>(feat, tile_start, tile_count, num_tiles, ntx, tile0, tin,
                mark_done, accum, tfin, ncon, evals, s);
      break;
    case 2:
      launch<2>(feat, tile_start, tile_count, num_tiles, ntx, tile0, tin,
                mark_done, accum, tfin, ncon, evals, s);
      break;
    case 3:
      launch<3>(feat, tile_start, tile_count, num_tiles, ntx, tile0, tin,
                mark_done, accum, tfin, ncon, evals, s);
      break;
    case 4:
      launch<4>(feat, tile_start, tile_count, num_tiles, ntx, tile0, tin,
                mark_done, accum, tfin, ncon, evals, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return sg_last_error();
}
