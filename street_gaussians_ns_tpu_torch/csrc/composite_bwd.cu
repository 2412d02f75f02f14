// Kernel E: backward tile compositor (forward replay).
//
// Replaces street_gaussians_ns_tpu/ops/composite_pallas.py:_bwd_kernel /
// _bwd_tile in all its modes. For every pair, in sorted pair order and in
// the stream's own (rows, 16, 128) layout, it
// writes dL/d[x, y, conic a, b, c, opacity, colour 0..NC-1] summed over the
// tile's pixels into rows 0..5+NC, and copies the pair's depth rank (row 10
// of the feature stream) into row 10, which keys the gradient reduce
// (kernel F). Pairs that no pixel of their tile reached keep what the
// caller's buffer held (zeros, or nothing defined: ops/composite.py says
// which caller asks for which); a visited pair has all of rows 0..10
// written (rows 6 + NC..9 as zeros). A stream without ranks has zeros in
// row 10 (the TPU kernel's with_rank=False); the copy then writes zeros.
//
// Continuation (TIN) and strips (tile0) as in the forward kernel
// (composite_fwd.cu): the replay starts from the pixel's incoming
// transmittance `tin`, and the CTA's pixel coordinates are those of tile
// blockIdx.x + tile0. The formulas do not change: g . accum is taken on the
// window's own accum, which the forward premultiplied by the whole chain,
// and g_T is the cotangent of the window's own T_final; the chain from one
// window's T_final to the next one's `tin` is the caller's. A pixel with
// tin <= 1e-4 (or negative: done in an earlier window) has n_contrib 0
// and is never evaluated. Every pair's row is
// stored whole by its own tile, so a strip needs nothing like the TPU
// kernel's flush of a boundary row at its end.
//
// The replay. A thread replays the forward recurrence over the pairs below
// its pixels' n_contrib with the shared sg_sigma / sg_alpha (common.cuh),
// so sigma, alpha and the transmittance are bit for bit the forward's and it
// takes the forward's branch at every (pixel, pair). Per contributing
// (pixel, pair), with w = alpha T_before, gc = g_accum . colour and
// u = gc w:
//   dL/dcolour  = w g_accum
//   gS          = g . accum - (u summed over this and the earlier pairs)
//   dL/dalpha   = gc T_before - gS / (1 - alpha) - g_T T_final / (1 - alpha),
//                 0 where alpha sits at the 0.999 clamp
//   dL/dsigma   = -alpha dL/dalpha where sigma > 0, else 0
//   dL/dopacity = dL/dalpha exp(-max(sigma, 0))
//   x, y, conic = dL/dsigma times d sigma / d(x, y, a, b, c)
// 1 - alpha >= 1e-3 by the clamp, so the divisions are bounded. The suffix
// gS is formed by subtraction, as the TPU kernel forms it.
//
// Bound on the H100: the larger of the bytes (the visited pairs' 7 + NC
// feature rows read, their 11 gradient rows written, (2 NC + 3) x 256
// floats of cotangents and residuals per tile) and the float32 operations: the
// forward's 16 (one exp among them) per evaluated (pixel, pair), and about
// 51 more (at NC = 4, the add into each gradient row's sum included) only
// where the evaluation contributes. Both counts go into `evals` when it is
// non-null. The operations are the larger by 3.6x at full width, and the
// build's -fmad=false (a multiply-add is two instructions, so that the
// replay rounds as the forward does) puts the 67 TFLOP/s yardstick, which
// counts a fused multiply-add as two, out of reach by 2x on that ground
// alone.
//
// What the kernel is really bound by is instruction issue: nearly every
// pixel of a tile evaluates every visited pair (215 of 256 at full width)
// and 72% contribute, so there is no idle lane to win back, and what can
// be cut is what is issued beside the arithmetic. The first version (one
// pixel a thread, 256 threads a tile) spent a third of its instructions on
// the sum over the tile's pixels: per pair, each of 8 warps ran a 12-shuffle
// folding tree, stored into shared memory, and a second pass added the 8
// partial sums. This version:
//
//   * PPT = 4 pixels a thread, 64 threads (two warps) a tile. The pair's
//     features are fetched once a thread, not once a pixel; a thread adds
//     its pixels' 6 + NC terms in registers, so one folding tree covers 128
//     pixels instead of 32 and the second pass adds 2 partial sums, not 8.
//     A thread's pixels share their column (rows r, r + 4, r + 8, r + 12), and
//     sigma and alpha of the four are formed before any branch, so four
//     independent exp chains are in flight where the first version had
//     occupancy alone to hide one. The folding tree itself is unchanged:
//     at each of four levels a lane keeps one half of its terms and hands
//     the other half to its partner (5 + 3 + 2 + 1 + 1 = 12 shuffles for 10
//     terms), each term's total ends in one lane, and a warp none of whose
//     pixels contributes to a pair skips it.
//   * Fewer instructions in the gradient terms, which are formed after
//     the forward's branch is decided and are held to the plain version at
//     1e-4, not bit for bit: explicit fused multiply-adds (the replay
//     itself stays free of them), one fast division of (gS + g_T T_final)
//     by 1 - alpha in place of two IEEE divisions (2 ulp; 1 - alpha lies
//     in [1e-3, 1]), and the five geometry rows from three moments a
//     thread (its pixels share dx).
//   * Staging. A pair's ten features and its rank lie together in shared
//     memory (12 floats), so a thread fetches them with three 16-byte
//     loads that every lane shares. Batches of 64 pairs are double-buffered
//     with cp.async: batch b + 1 is in flight while batch b is replayed,
//     and a batch costs two block barriers, not three.
//   * A tile with no pairs returns before it reads any per-pixel state.
//     Tiles run in image order: issuing the deepest first was measured and
//     bought less than the sort that makes the order costs (PERF.md,
//     section 5).
//
// Every pair belongs to one tile and every sum is taken in one fixed order
// (a thread's pixels in order, the tree, the warps in order), so the stores
// need no atomics and two launches give the same bits; a tile0 strip gives
// the bits of the full launch. The TPU kernel's
// lane rotation, `pend` carry, DMA rings and chunk counts have no
// counterpart here: the loop runs to the tile's largest n_contrib.
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
constexpr int RANK_ROW = 10;
constexpr unsigned FULL = 0xffffffffu;
static_assert(PPT == 1 || PPT == 2 || PPT == 4, "1, 2 or 4 pixels a thread");

// a * b + c of the gradient terms, fused: the file is built without
// multiply-add contraction so that the replay rounds as the forward does,
// and only the terms formed after the branch is decided say so themselves.
__device__ __forceinline__ float muladd(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}

// One level of the folding tree over the first N entries of v: a lane
// whose `up` bit is clear keeps entries [0, H) and receives its partner's
// (lane ^ OFF) same entries; a lane whose bit is set keeps [H, 2H), moved
// down to [0, H). Entries at or past N count as zero.
template <int N, int H, int OFF, int NG>
__device__ __forceinline__ void fold(float (&v)[NG], bool up) {
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float upper = (i + H < N) ? v[i + H] : 0.0f;
    const float send = up ? v[i] : upper;
    const float keep = up ? upper : v[i];
    v[i] = keep + __shfl_xor_sync(FULL, send, OFF);
  }
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(dst),
               "l"(gmem)
               : "memory");
}

// Starts the copies of pairs [first, first + nb) of the stream into one
// staging buffer: features 0..NG-1 and the rank row, 12 floats a pair.
template <int NG>
__device__ __forceinline__ void stage(float (*buf)[SLOT],
                                      const float* __restrict__ feat,
                                      long long first, int nb, int tid) {
  for (int i = tid; i < nb; i += THREADS) {
    const long long p = first + i;
    const float* src = feat + (p / K) * (NFEAT * K) + (p % K);
#pragma unroll
    for (int f = 0; f < NG; ++f) cp_async4(&buf[i][f], src + f * K);
    cp_async4(&buf[i][RANK_ROW], src + RANK_ROW * K);
  }
}

template <int NC, bool TIN, bool COUNT>
__global__ void __launch_bounds__(THREADS)
    composite_bwd_kernel(const float* __restrict__ feat,
                         const int* __restrict__ tile_start,
                         const int* __restrict__ tile_count,
                         int ntx, int tile0,
                         const float* __restrict__ tin,
                         const float* __restrict__ g_accum,
                         const float* __restrict__ g_t,
                         const float* __restrict__ tfin,
                         const int* __restrict__ ncon,
                         const float* __restrict__ accum,
                         float* __restrict__ gpair,
                         unsigned long long* __restrict__ evals) {
  constexpr int NG = 6 + NC;
  constexpr int H0 = (NG + 1) / 2, H1 = (H0 + 1) / 2, H2 = (H1 + 1) / 2;
  static_assert((H2 + 1) / 2 == 1, "the folding tree has four levels");
  __shared__ __align__(16) float sm[2][BATCH][SLOT];
  __shared__ float red[WARPS][NG][BATCH];
  __shared__ int warp_nmax[WARPS];

  const int t = blockIdx.x;
  const int count = tile_count[t];
  if (count == 0) return;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long start = tile_start[t];
  const int tg = t + tile0;
  const float px = (float)((tg % ntx) * TILE + (tid % TILE)) + 0.5f;

  // Pixel k of this thread is tile pixel k * THREADS + tid: its column is
  // the thread's, its row THREADS / 16 below the one before. n[k] is the number
  // of pairs the pixel still replays: 0 once it is done.
  float py[PPT], ga[PPT][NC], gt_tfin[PPT], gda[PPT], T[PPT], cum_u[PPT];
  int n[PPT];
  int my_max = 0;
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int lp = k * THREADS + tid;
    const long long o = (long long)t * PIX + lp;
    py[k] = (float)((tg / ntx) * TILE + (lp / TILE)) + 0.5f;
    n[k] = min(ncon[o], count);
    my_max = max(my_max, n[k]);
    // g . accum of the window's own accum: the start of the suffix gS.
    gda[k] = 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      ga[k][c] = g_accum[o * NC + c];
      gda[k] = muladd(ga[k][c], accum[o * NC + c], gda[k]);
    }
    gt_tfin[k] = g_t[o] * tfin[o];
    T[k] = 1.0f;
    cum_u[k] = 0.0f;
    if (TIN) {
      const float v = tin[o];
      T[k] = fabsf(v);
      if (v <= SG_T_EPS) n[k] = 0;   // done on arrival; my_max keeps its
    }                                // n_contrib, which is 0 by contract
  }

  // The gradient row whose warp total the folding tree leaves in this
  // lane (-1: none), from the halves its bits keep at each level.
  int my_row = (lane & 2) ? 1 : 0;
  bool holds = (lane & 1) == 0 && my_row < H2;
  my_row += (lane & 4) ? H2 : 0;
  holds = holds && my_row < H1;
  my_row += (lane & 8) ? H1 : 0;
  holds = holds && my_row < H0;
  my_row += (lane & 16) ? H0 : 0;
  holds = holds && my_row < NG;
  if (!holds) my_row = -1;

  my_max = __reduce_max_sync(FULL, my_max);
  if (lane == 0) warp_nmax[warp] = my_max;
  __syncthreads();
  int nmax = warp_nmax[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) nmax = max(nmax, warp_nmax[w]);
  if (nmax == 0) return;

  unsigned int nev = 0, ncontrib = 0;
  const int nbatches = (nmax + BATCH - 1) / BATCH;
  stage<NG>(sm[0], feat, start, min(BATCH, nmax), tid);
  asm volatile("cp.async.commit_group;" ::: "memory");

  for (int b = 0; b < nbatches; ++b) {
    const int b0 = b * BATCH;
    const int nb = min(BATCH, nmax - b0);
    const float(*cur)[SLOT] = sm[b & 1];
    // Batch b has landed; behind the barrier nobody reads the other
    // buffer or `red` any more, so the next batch's copies may start and
    // run under this batch's replay.
    asm volatile("cp.async.wait_group 0;" ::: "memory");
    __syncthreads();
    if (b + 1 < nbatches) {
      stage<NG>(sm[(b + 1) & 1], feat, start + b0 + BATCH,
                min(BATCH, nmax - b0 - BATCH), tid);
      asm volatile("cp.async.commit_group;" ::: "memory");
    }

    for (int j = 0; j < nb; ++j) {
      const float4 f0 = *reinterpret_cast<const float4*>(&cur[j][0]);
      const float4 f1 = *reinterpret_cast<const float4*>(&cur[j][4]);
      const float4 f2 = *reinterpret_cast<const float4*>(&cur[j][8]);
      const float col[4] = {f1.z, f1.w, f2.x, f2.y};
      const int jj = b0 + j;
      // The replay of the thread's pixels, branch-free so that their exp
      // chains overlap: sigma and alpha as the forward forms them, then
      // the forward's two skip tests and its termination test, in its own
      // form. `c` marks the pixels the pair contributes to.
      float dx, dy[PPT], sigma[PPT], alpha[PPT], falloff[PPT], next_T[PPT];
      bool c[PPT];
      bool contributes = false;
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        sigma[k] = sg_sigma(f0.x, f0.y, f0.z, f0.w, f1.x, px, py[k], dx,
                            dy[k]);
        alpha[k] = sg_alpha(f1.y, sigma[k], falloff[k]);
        const bool live = jj < n[k];
        const bool considered = live && !(sigma[k] < SG_SIGMA_MIN) &&
                                !(alpha[k] < SG_ALPHA_THRESH);
        next_T[k] = T[k] * (1.0f - alpha[k]);
        const bool ends = considered && next_T[k] <= SG_T_EPS;
        c[k] = considered && !ends;
        if (ends) n[k] = 0;
        contributes = contributes || c[k];
        if (COUNT) {
          nev += live;
          ncontrib += c[k];
        }
      }
      if (__any_sync(FULL, contributes)) {
        // The gradient terms, branch-free too (a pixel the pair does not
        // contribute to adds zeros), so that the chains of the thread's
        // pixels overlap as well. The thread's pixels share dx, so the
        // five geometry rows are formed once a pair from three moments of
        // dL/dsigma over the pixels: sum of {1, dy, dy^2}.
        float g[NG];
#pragma unroll
        for (int f = 0; f < NG; ++f) g[f] = 0.0f;
        float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f;
#pragma unroll
        for (int k = 0; k < PPT; ++k) {
          const float w = c[k] ? alpha[k] * T[k] : 0.0f;
          float gc = 0.0f;
#pragma unroll
          for (int ch = 0; ch < NC; ++ch) {
            g[6 + ch] = muladd(w, ga[k][ch], g[6 + ch]);
            gc = muladd(ga[k][ch], col[ch], gc);
          }
          cum_u[k] = muladd(gc, w, cum_u[k]);
          const float om = 1.0f - alpha[k];
          const float gs = gda[k] - cum_u[k];
          const float raw =
              muladd(gc, T[k], -__fdividef(gs + gt_tfin[k], om));
          const float dl_da =
              (c[k] && alpha[k] < SG_ALPHA_CLAMP) ? raw : 0.0f;
          g[5] = muladd(dl_da, falloff[k], g[5]);
          const float dl_ds = sigma[k] > 0.0f ? -alpha[k] * dl_da : 0.0f;
          const float dl_ds_dy = dl_ds * dy[k];
          s0 += dl_ds;
          s1 += dl_ds_dy;
          s2 = muladd(dl_ds_dy, dy[k], s2);
          T[k] = c[k] ? next_T[k] : T[k];
        }
        const float dx_s0 = dx * s0;
        g[0] = muladd(f0.z, dx_s0, f0.w * s1);
        g[1] = muladd(f1.x, s1, f0.w * dx_s0);
        g[2] = 0.5f * dx * dx_s0;
        g[3] = dx * s1;
        g[4] = 0.5f * s2;
        fold<NG, H0, 16>(g, lane & 16);
        fold<H0, H1, 8>(g, lane & 8);
        fold<H1, H2, 4>(g, lane & 4);
        fold<H2, 1, 2>(g, lane & 2);
        g[0] += __shfl_xor_sync(FULL, g[0], 1);
        if (my_row >= 0) red[warp][my_row][j] = g[0];
      } else if (lane < NG) {
        red[warp][lane][j] = 0.0f;
      }
    }
    __syncthreads();

    for (int i = tid; i < nb; i += THREADS) {
      const long long p = start + b0 + i;
      const long long base = (p / K) * (NFEAT * K) + (p % K);
#pragma unroll
      for (int f = 0; f < NG; ++f) {
        float s = red[0][f][i];
#pragma unroll
        for (int w = 1; w < WARPS; ++w) s += red[w][f][i];
        gpair[base + f * K] = s;
      }
#pragma unroll
      for (int f = NG; f < RANK_ROW; ++f) gpair[base + f * K] = 0.0f;
      gpair[base + RANK_ROW * K] = cur[i][RANK_ROW];
    }
  }

  // Measurement aid: evals[0] += evaluated (pixel, pair)s; evals[1] += the
  // pairs this tile visited (its largest n_contrib); evals[2] += the
  // evaluations that contributed (passed both skip tests before the pixel
  // saturated).
  if (COUNT) {
    unsigned long long v = nev, c = ncontrib;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      v += __shfl_down_sync(FULL, v, off);
      c += __shfl_down_sync(FULL, c, off);
    }
    if (lane == 0) {
      atomicAdd(evals, v);
      atomicAdd(evals + 2, c);
    }
    if (tid == 0) atomicAdd(evals + 1, (unsigned long long)nmax);
  }
}

template <int NC, bool TIN, bool COUNT>
void launch_mode(const float* feat, const int* tile_start,
                 const int* tile_count, int num_tiles, int ntx, int tile0,
                 const float* tin, const float* g_accum,
                 const float* g_t, const float* tfin, const int* ncon,
                 const float* accum, float* gpair,
                 unsigned long long* evals, cudaStream_t s) {
  composite_bwd_kernel<NC, TIN, COUNT><<<num_tiles, THREADS, 0, s>>>(
      feat, tile_start, tile_count, ntx, tile0, tin, g_accum, g_t, tfin,
      ncon, accum, gpair, evals);
}

template <int NC>
void launch(const float* feat, const int* tile_start, const int* tile_count,
            int num_tiles, int ntx, int tile0, const float* tin,
            const float* g_accum, const float* g_t,
            const float* tfin, const int* ncon, const float* accum,
            float* gpair, unsigned long long* evals, cudaStream_t s) {
  auto fn = tin != nullptr
                ? (evals != nullptr ? launch_mode<NC, true, true>
                                    : launch_mode<NC, true, false>)
                : (evals != nullptr ? launch_mode<NC, false, true>
                                    : launch_mode<NC, false, false>);
  fn(feat, tile_start, tile_count, num_tiles, ntx, tile0, tin, g_accum, g_t,
     tfin, ncon, accum, gpair, evals, s);
}

}  // namespace

// feat and gpair (rows, 16, 128) float32; g_accum (num_tiles, 256, nc),
// accum (num_tiles, 256, nc), g_t, tfin (num_tiles, 256) float32, ncon
// (num_tiles, 256) int32; tin (num_tiles, 256) float32 and evals (three
// uint64) are optional (null = off). Only the visited pairs of gpair are
// written.
SG_EXPORT int sg_composite_bwd(const float* feat, const int* tile_start,
                               const int* tile_count, int num_tiles,
                               int ntx, int nc, int tile0,
                               const float* tin, const float* g_accum,
                               const float* g_t, const float* tfin,
                               const int* ncon, const float* accum,
                               float* gpair, unsigned long long* evals,
                               void* stream) {
  if (num_tiles <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nc) {
    case 1:
      launch<1>(feat, tile_start, tile_count, num_tiles, ntx, tile0, tin,
                g_accum, g_t, tfin, ncon, accum, gpair, evals, s);
      break;
    case 2:
      launch<2>(feat, tile_start, tile_count, num_tiles, ntx, tile0, tin,
                g_accum, g_t, tfin, ncon, accum, gpair, evals, s);
      break;
    case 3:
      launch<3>(feat, tile_start, tile_count, num_tiles, ntx, tile0, tin,
                g_accum, g_t, tfin, ncon, accum, gpair, evals, s);
      break;
    case 4:
      launch<4>(feat, tile_start, tile_count, num_tiles, ntx, tile0, tin,
                g_accum, g_t, tfin, ncon, accum, gpair, evals, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return sg_last_error();
}
