// Kernel D: forward tile compositor.
//
// Replaces street_gaussians_ns_tpu/ops/composite_pallas.py:_fwd_kernel
// in both its modes. One CTA of 256 threads per 16x16 tile, one thread per
// pixel, walks the tile's sorted pair range
// [tile_start, tile_start + tile_count) of the (rows, 16, 128) feature
// stream front to back, with the oracle's rules
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
// pairs and never divides.
//
// Pairs are staged BATCH at a time into shared memory, one pair per
// thread, each of the 6 + NC used feature rows read as 128 contiguous
// floats (coalesced). The CTA leaves the loop when every pixel is done
// (__syncthreads_count), the GPU form of the TPU kernel's tile-level
// early exit.
//
// Continuation (TIN, the TPU kernel's with_tin): the depth-sliced path
// composites one depth-rank window after another, and a later window's
// launch starts every pixel from the transmittance `tin` the earlier ones
// left (done where tin <= 1e-4) instead of 1. The accumulated colours then
// come out premultiplied by the whole chain, the windows' outputs simply
// add, and a pixel that the earlier windows saturated does no work: the
// CTA's exit count sees it as done from the start. A tile of count 0 still
// writes T_final = tin and n_contrib = 0; n_contrib counts within the
// window. The mode is a template parameter, so a launch without `tin` runs
// the code it ran before the mode existed.
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
// Bound on the H100: the larger of the bytes (the stream once plus the
// outputs; a tile re-reads nothing from device memory) and about 16 float32
// operations with one exp per evaluated (pixel, pair), both counted into
// `evals` when it is non-null. At full width the bytes are larger. One CTA walks
// its tile's whole range, so the densest tiles (18k pairs at full width)
// set the tail; splitting them across CTAs is the next step.
#include "common.cuh"

namespace {

constexpr int TILE = 16;
constexpr int PIX = TILE * TILE;
constexpr int NFEAT = 16;
constexpr int K = 128;
constexpr int BATCH = PIX;

template <int NC, bool TIN>
__global__ void __launch_bounds__(PIX)
    composite_fwd_kernel(const float* __restrict__ feat,
                         const int* __restrict__ tile_start,
                         const int* __restrict__ tile_count, int ntx,
                         int tile0, const float* __restrict__ tin,
                         int mark_done, float* __restrict__ accum,
                         float* __restrict__ tfin,
                         int* __restrict__ ncon,
                         unsigned long long* __restrict__ evals) {
  __shared__ float sm[6 + NC][BATCH];
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const long long start = tile_start[t];
  const int count = tile_count[t];
  const int tg = t + tile0;
  const float px = (float)((tg % ntx) * TILE + (tid % TILE)) + 0.5f;
  const float py = (float)((tg / ntx) * TILE + (tid / TILE)) + 0.5f;
  const long long o = (long long)t * PIX + tid;

  float T = 1.0f;
  float acc[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) acc[c] = 0.0f;
  int last = 0;
  bool done = false;
  if (TIN) {
    const float v = tin[o];
    T = fabsf(v);
    done = v <= SG_T_EPS;
  }
  unsigned int nev = 0;

  for (int b0 = 0; b0 < count; b0 += BATCH) {
    const int nb = min(BATCH, count - b0);
    if (tid < nb) {
      const long long p = start + b0 + tid;
      const float* src = feat + (p / K) * (NFEAT * K) + (p % K);
#pragma unroll
      for (int f = 0; f < 6 + NC; ++f) sm[f][tid] = __ldg(src + f * K);
    }
    __syncthreads();
    if (!done) {
      for (int j = 0; j < nb; ++j) {
        float dx, dy, falloff;
        const float sigma = sg_sigma(sm[0][j], sm[1][j], sm[2][j], sm[3][j],
                                     sm[4][j], px, py, dx, dy);
        ++nev;
        if (sigma < SG_SIGMA_MIN) continue;
        const float alpha = sg_alpha(sm[5][j], sigma, falloff);
        if (alpha < SG_ALPHA_THRESH) continue;
        const float next_T = T * (1.0f - alpha);
        if (next_T <= SG_T_EPS) {
          done = true;
          break;
        }
        const float w = alpha * T;
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[c] += sm[6 + c][j] * w;
        T = next_T;
        last = b0 + j + 1;
      }
    }
    // Barrier before the next batch overwrites sm; exit once all are done.
    if (__syncthreads_count(!done) == 0) break;
  }

#pragma unroll
  for (int c = 0; c < NC; ++c) accum[o * NC + c] = acc[c];
  tfin[o] = (mark_done && done) ? -T : T;
  ncon[o] = last;

  // Measurement aid: evals[0] += evaluated (pixel, pair)s; evals[1] +=
  // the pairs this tile needed, the most any of its pixels evaluated (a
  // pixel evaluates pairs 0, 1, ... without gaps until it is done).
  if (evals != nullptr) {
    __shared__ unsigned int tile_need;
    if (tid == 0) tile_need = 0;
    __syncthreads();
    atomicMax(&tile_need, nev);
    unsigned long long v = nev;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
    if ((tid & 31) == 0) atomicAdd(evals, v);
    __syncthreads();
    if (tid == 0) atomicAdd(evals + 1, (unsigned long long)tile_need);
  }
}

template <int NC>
void launch(const float* feat, const int* tile_start, const int* tile_count,
            int num_tiles, int ntx, int tile0, const float* tin,
            int mark_done, float* accum, float* tfin, int* ncon,
            unsigned long long* evals, cudaStream_t s) {
  if (tin != nullptr)
    composite_fwd_kernel<NC, true><<<num_tiles, PIX, 0, s>>>(
        feat, tile_start, tile_count, ntx, tile0, tin, mark_done, accum,
        tfin, ncon, evals);
  else
    composite_fwd_kernel<NC, false><<<num_tiles, PIX, 0, s>>>(
        feat, tile_start, tile_count, ntx, tile0, tin, mark_done, accum,
        tfin, ncon, evals);
}

}  // namespace

// accum (num_tiles, 256, nc), tfin (num_tiles, 256) float32, ncon
// (num_tiles, 256) int32; tin (num_tiles, 256) float32 and evals (two
// uint64) are optional (null = off).
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
