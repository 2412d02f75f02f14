// Kernel E: backward tile compositor (forward replay).
//
// Replaces street_gaussians_ns_tpu/ops/composite_pallas.py:_bwd_kernel /
// _bwd_tile in all its modes. For every pair, in sorted pair order and in the stream's own (rows, 16, 128) layout, it
// writes dL/d[x, y, conic a, b, c, opacity, colour 0..NC-1] summed over the
// tile's pixels into rows 0..5+NC, and copies the pair's depth rank (row 10
// of the feature stream) into row 10, which keys the gradient reduce
// (kernel F). Pairs that no pixel of their tile reached stay as the caller
// zero-filled them. The unfused path's stream has zeros in row 10 (the TPU
// kernel's with_rank=False); the copy then writes zeros and that path's
// reduce does not read the row.
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
// One CTA of 256 threads per 16x16 tile, one thread per pixel, as in the
// forward kernel. The thread replays the forward recurrence over the pairs
// below its own n_contrib with the shared sg_sigma / sg_alpha (common.cuh),
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
// Reduction over the tile's pixels: each thread's 6 + NC terms are added
// across its warp (skipped when no lane of the warp contributes to the
// pair), the 8 warp sums go to shared memory, and after a batch of pairs
// one thread per pair adds the 8 in a fixed order and stores the pair's
// gradient column. The warp sum is a folding tree: at each of four levels
// a lane keeps one half of its terms and hands the other half to its
// partner, so the 10 terms cost 5 + 3 + 2 + 1 + 1 = 12 shuffles, not the 50
// of ten separate butterflies, and each term's total ends in one lane.
// Every pair belongs to one tile, so the stores need no atomics and the
// result is the same from run to run. The
// TPU kernel's lane rotation, `pend` carry, DMA rings and chunk counts have
// no counterpart here: the loop runs to the tile's largest n_contrib.
//
// Bound on the H100: the larger of the bytes (the visited pairs' 7 + NC
// feature rows read, their 11 gradient rows written, (NC + 4) x 256 floats
// of cotangents and residuals per tile) and the float32 operations: the
// forward's 16 (one exp among them) per evaluated (pixel, pair), and about
// 51 more (at NC = 4, the add into each gradient row's sum included) only
// where the evaluation contributes, which most do not: a gaussian is small
// next to a tile. Both counts go into `evals` when it is non-null.
#include "common.cuh"

namespace {

constexpr int TILE = 16;
constexpr int PIX = TILE * TILE;
constexpr int NFEAT = 16;
constexpr int K = 128;
constexpr int BATCH = 64;
constexpr int WARPS = PIX / 32;
constexpr int RANK_ROW = 10;
constexpr unsigned FULL = 0xffffffffu;

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

template <int NC, bool TIN>
__global__ void __launch_bounds__(PIX)
    composite_bwd_kernel(const float* __restrict__ feat,
                         const int* __restrict__ tile_start,
                         const int* __restrict__ tile_count, int ntx,
                         int tile0, const float* __restrict__ tin,
                         const float* __restrict__ g_accum,
                         const float* __restrict__ g_t,
                         const float* __restrict__ tfin,
                         const int* __restrict__ ncon,
                         const float* __restrict__ gdotacc,
                         float* __restrict__ gpair,
                         unsigned long long* __restrict__ evals) {
  constexpr int NG = 6 + NC;
  constexpr int H0 = (NG + 1) / 2, H1 = (H0 + 1) / 2, H2 = (H1 + 1) / 2;
  static_assert((H2 + 1) / 2 == 1, "the folding tree has four levels");
  __shared__ float sm[NG][BATCH];
  __shared__ float red[WARPS][NG][BATCH];
  __shared__ int tile_nmax;

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long start = tile_start[t];
  const int count = tile_count[t];
  const int tg = t + tile0;
  const float px = (float)((tg % ntx) * TILE + (tid % TILE)) + 0.5f;
  const float py = (float)((tg / ntx) * TILE + (tid / TILE)) + 0.5f;

  const long long o = (long long)t * PIX + tid;
  const int my_n = min(ncon[o], count);
  float ga[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) ga[c] = g_accum[o * NC + c];
  const float gt_tfin = g_t[o] * tfin[o];
  const float gda = gdotacc[o];

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

  if (tid == 0) tile_nmax = 0;
  __syncthreads();
  atomicMax(&tile_nmax, my_n);
  __syncthreads();
  const int nmax = tile_nmax;

  float T = 1.0f;
  float cum_u = 0.0f;
  bool done = false;
  if (TIN) {
    const float v = tin[o];
    T = fabsf(v);
    done = v <= SG_T_EPS;
  }
  unsigned int nev = 0, ncontrib = 0;

  for (int b0 = 0; b0 < nmax; b0 += BATCH) {
    const int nb = min(BATCH, nmax - b0);
    if (tid < nb) {
      const long long p = start + b0 + tid;
      const float* src = feat + (p / K) * (NFEAT * K) + (p % K);
#pragma unroll
      for (int f = 0; f < NG; ++f) sm[f][tid] = __ldg(src + f * K);
    }
    __syncthreads();

    for (int j = 0; j < nb; ++j) {
      float g[NG];
#pragma unroll
      for (int f = 0; f < NG; ++f) g[f] = 0.0f;
      bool contributes = false;
      if (!done && b0 + j < my_n) {
        float dx, dy, falloff;
        const float sigma = sg_sigma(sm[0][j], sm[1][j], sm[2][j], sm[3][j],
                                     sm[4][j], px, py, dx, dy);
        ++nev;
        // The forward's two skip tests, in its own form.
        float alpha;
        if (!(sigma < SG_SIGMA_MIN) &&
            !((alpha = sg_alpha(sm[5][j], sigma, falloff)) <
              SG_ALPHA_THRESH)) {
          const float next_T = T * (1.0f - alpha);
          if (next_T <= SG_T_EPS) {
            done = true;
          } else {
            contributes = true;
            ++ncontrib;
            const float w = alpha * T;
            float gc = 0.0f;
#pragma unroll
            for (int c = 0; c < NC; ++c) {
              g[6 + c] = w * ga[c];
              gc += ga[c] * sm[6 + c][j];
            }
            cum_u += gc * w;
            const float om = 1.0f - alpha;
            float dl_da = 0.0f;
            if (alpha < SG_ALPHA_CLAMP) {
              const float gs = gda - cum_u;
              dl_da = gc * T - gs / om - gt_tfin / om;
            }
            g[5] = dl_da * falloff;
            if (sigma > 0.0f) {
              const float dl_ds = -alpha * dl_da;
              const float ca = sm[2][j], cb = sm[3][j], cc = sm[4][j];
              g[0] = dl_ds * (ca * dx + cb * dy);
              g[1] = dl_ds * (cc * dy + cb * dx);
              g[2] = dl_ds * (0.5f * dx * dx);
              g[3] = dl_ds * (dx * dy);
              g[4] = dl_ds * (0.5f * dy * dy);
            }
            T = next_T;
          }
        }
      }
      if (__any_sync(FULL, contributes)) {
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

    if (tid < nb) {
      const long long p = start + b0 + tid;
      const long long base = (p / K) * (NFEAT * K) + (p % K);
#pragma unroll
      for (int f = 0; f < NG; ++f) {
        float s = red[0][f][tid];
#pragma unroll
        for (int w = 1; w < WARPS; ++w) s += red[w][f][tid];
        gpair[base + f * K] = s;
      }
      gpair[base + RANK_ROW * K] = __ldg(feat + base + RANK_ROW * K);
    }
    // The next batch overwrites sm and red.
    __syncthreads();
  }

  // Measurement aid: evals[0] += evaluated (pixel, pair)s; evals[1] += the
  // pairs this tile visited (its largest n_contrib); evals[2] += the
  // evaluations that contributed (passed both skip tests before the pixel
  // saturated).
  if (evals != nullptr) {
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

template <int NC>
void launch(const float* feat, const int* tile_start, const int* tile_count,
            int num_tiles, int ntx, int tile0, const float* tin,
            const float* g_accum, const float* g_t, const float* tfin,
            const int* ncon, const float* gdotacc, float* gpair,
            unsigned long long* evals, cudaStream_t s) {
  if (tin != nullptr)
    composite_bwd_kernel<NC, true><<<num_tiles, PIX, 0, s>>>(
        feat, tile_start, tile_count, ntx, tile0, tin, g_accum, g_t, tfin,
        ncon, gdotacc, gpair, evals);
  else
    composite_bwd_kernel<NC, false><<<num_tiles, PIX, 0, s>>>(
        feat, tile_start, tile_count, ntx, tile0, tin, g_accum, g_t, tfin,
        ncon, gdotacc, gpair, evals);
}

}  // namespace

// feat and gpair (rows, 16, 128) float32, gpair zero-filled by the caller;
// g_accum (num_tiles, 256, nc), g_t, tfin, gdotacc (num_tiles, 256)
// float32, ncon (num_tiles, 256) int32; tin (num_tiles, 256) float32 and
// evals (three uint64) are optional (null = off).
SG_EXPORT int sg_composite_bwd(const float* feat, const int* tile_start,
                               const int* tile_count, int num_tiles, int ntx,
                               int nc, int tile0, const float* tin,
                               const float* g_accum, const float* g_t,
                               const float* tfin, const int* ncon,
                               const float* gdotacc, float* gpair,
                               unsigned long long* evals, void* stream) {
  if (num_tiles <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nc) {
    case 1:
      launch<1>(feat, tile_start, tile_count, num_tiles, ntx, tile0, tin,
                g_accum, g_t, tfin, ncon, gdotacc, gpair, evals, s);
      break;
    case 2:
      launch<2>(feat, tile_start, tile_count, num_tiles, ntx, tile0, tin,
                g_accum, g_t, tfin, ncon, gdotacc, gpair, evals, s);
      break;
    case 3:
      launch<3>(feat, tile_start, tile_count, num_tiles, ntx, tile0, tin,
                g_accum, g_t, tfin, ncon, gdotacc, gpair, evals, s);
      break;
    case 4:
      launch<4>(feat, tile_start, tile_count, num_tiles, ntx, tile0, tin,
                g_accum, g_t, tfin, ncon, gdotacc, gpair, evals, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return sg_last_error();
}
