// Kernel J: the view-dependent colour of every slot by spherical
// harmonics (models/splatfacto.sh_colors), forward and backward.
//
// Forward, for slot g with centre m_g, camera centre c, DC (3,) and rest
// (K - 1, 3) coefficients, K = (D + 1)^2 bases of degree <= D, `live` of
// them active:
//   d = (m_g - c) / max(|m_g - c|, 1e-12)
//   b_k = sh_basis(d)[k] * (k < live)          (core/sh.py sh_basis)
//   v = b_0 dc + b_1 rest[0] + ... + b_{K-1} rest[K-2] + 0.5, in that order
//   rgb = v < 0 ? 0 : v                        (torch.clamp(v, min=0))
// and, where the caller differentiates, a mask byte of the three channels'
// v >= 0. Backward, from the incoming gradient G of rgb:
//   G' = v >= 0 ? G : 0                        (clamp_min's rule)
//   d_dc = b_0 G',  d_rest[k - 1] = b_k G'
// The direction is detached: no gradient for the centres or the camera.
//
// Replaces no Pallas kernel: the JAX package's SH colour,
// street_gaussians_ns_tpu/core/sh.py eval_sh, is jnp code that XLA fuses.
// The port's plain version (models/splatfacto._sh_colors_plain) builds
// the basis from ~30 (N,) temporaries, concatenates DC and rest into an
// (N, K, 3) copy and contracts it with torch.einsum, which cuBLAS runs as a
// batched GEMV (one row a batch) forward and a batched K = 1 GEMM (a 16x3
// outer product a slot) backward.
//
// Bound on the H100: memory. At degree 3 the forward reads 204 bytes a
// slot (centre 12, DC 12, rest 180) and writes 13 (rgb, mask); the
// backward reads 25 (centre, gradient, mask) and writes 192. The basis, a
// few dozen flops, is recomputed from the centre in the backward rather
// than stored: 64 bytes a slot saved for 12 read. The pre-clamp sign is
// kept as one byte (3 bits) rather than recomputed, since recomputing it
// would read DC and rest again (192 bytes a slot). One thread owns one
// slot; a block's contiguous slab of rest (or of d_rest) passes through
// shared memory with 16-byte loads (stores), so a warp's device-memory
// accesses are coalesced; each thread then reads its own row of the slab,
// whose stride in words is odd, so without bank conflicts.
//
// Rounding is PyTorch's on the card, op for op (no multiply-add
// contraction, ops/_cuda.py NVCC_FLAGS; IEEE sqrtf and division):
//   * constants are the Python doubles rounded to float32, as PyTorch
//     rounds a Python scalar multiplied into a float32 tensor;
//   * |m - c| is PyTorch's CUDA vector_norm over a dim of 3, which splits
//     the three squares over two lanes: (x^2 + z^2) + y^2;
//   * the bases keep sh_basis's association; the inactive ones are
//     multiplied by 0 (a NaN stays NaN), as eval_sh multiplies by its mask;
//   * the clamps return a NaN operand, as torch.clamp does.
// So the colours equal the plain formulation that adds in k order bit for
// bit (einsum adds in cuBLAS's order: within 2e-6 of it), and the
// gradients equal autograd's through the plain version: each is one
// product.
#include "common.cuh"

namespace {

constexpr int THREADS = 128;

// core/sh.py's constants, rounded from the Python doubles.
constexpr float C0 = static_cast<float>(0.28209479177387814);
constexpr float C1 = static_cast<float>(0.4886025119029199);
constexpr float NC1 = static_cast<float>(-0.4886025119029199);
constexpr float C2_0 = static_cast<float>(1.0925484305920792);
constexpr float C2_1 = static_cast<float>(-1.0925484305920792);
constexpr float C2_2 = static_cast<float>(0.31539156525252005);
constexpr float C2_3 = static_cast<float>(-1.0925484305920792);
constexpr float C2_4 = static_cast<float>(0.5462742152960396);
constexpr float C3_0 = static_cast<float>(-0.5900435899266435);
constexpr float C3_1 = static_cast<float>(2.890611442640554);
constexpr float C3_2 = static_cast<float>(-0.4570457994644658);
constexpr float C3_3 = static_cast<float>(0.3731763325901154);
constexpr float C3_4 = static_cast<float>(-0.4570457994644658);
constexpr float C3_5 = static_cast<float>(1.445305721320277);
constexpr float C3_6 = static_cast<float>(-0.5900435899266435);
constexpr float C4_0 = static_cast<float>(2.5033429417967046);
constexpr float C4_1 = static_cast<float>(-1.7701307697799304);
constexpr float C4_2 = static_cast<float>(0.9461746957575601);
constexpr float C4_3 = static_cast<float>(-0.6690465435572892);
constexpr float C4_4 = static_cast<float>(0.10578554691520431);
constexpr float C4_5 = static_cast<float>(-0.6690465435572892);
constexpr float C4_6 = static_cast<float>(0.47308734787878004);
constexpr float C4_7 = static_cast<float>(-1.7701307697799304);
constexpr float C4_8 = static_cast<float>(0.6258357354491761);

template <int D>
struct Layout {
  static constexpr int K = (D + 1) * (D + 1);
  static constexpr int R = (K - 1) * 3;                 // rest floats a slot
  static constexpr int SR = (R > 0 && R % 2 == 0) ? R + 1 : R;  // odd
  static constexpr int SMEM = R > 0 ? THREADS * SR : 1;
};

// torch.clamp(v, min=lo) with lo not NaN: NaN stays NaN.
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return (v != v || v >= lo) ? v : lo;
}

// The masked bases b[0..K) of the direction from `center` (three floats,
// `cs` apart) to the slot centre m (three adjacent floats).
template <int D>
__device__ __forceinline__ void masked_basis(const float* __restrict__ m,
                                             const float* __restrict__ center,
                                             long long cs, int live,
                                             float* b) {
  const float vx = __ldg(m) - __ldg(center);
  const float vy = __ldg(m + 1) - __ldg(center + cs);
  const float vz = __ldg(m + 2) - __ldg(center + 2 * cs);
  const float nrm = clamp_min(sqrtf((vx * vx + vz * vz) + vy * vy), 1e-12f);
  const float x = vx / nrm, y = vy / nrm, z = vz / nrm;
  b[0] = C0;
  if constexpr (D >= 1) {
    b[1] = NC1 * y;
    b[2] = C1 * z;
    b[3] = NC1 * x;
  }
  if constexpr (D >= 2) {
    const float xx = x * x, yy = y * y, zz = z * z;
    const float xy = x * y, yz = y * z, xz = x * z;
    b[4] = C2_0 * xy;
    b[5] = C2_1 * yz;
    b[6] = C2_2 * ((2.0f * zz - xx) - yy);
    b[7] = C2_3 * xz;
    b[8] = C2_4 * (xx - yy);
    if constexpr (D >= 3) {
      b[9] = (C3_0 * y) * (3.0f * xx - yy);
      b[10] = (C3_1 * xy) * z;
      b[11] = (C3_2 * y) * ((4.0f * zz - xx) - yy);
      b[12] = (C3_3 * z) * ((2.0f * zz - 3.0f * xx) - 3.0f * yy);
      b[13] = (C3_4 * x) * ((4.0f * zz - xx) - yy);
      b[14] = (C3_5 * z) * (xx - yy);
      b[15] = (C3_6 * x) * (xx - 3.0f * yy);
    }
    if constexpr (D >= 4) {
      b[16] = (C4_0 * xy) * (xx - yy);
      b[17] = (C4_1 * yz) * (3.0f * xx - yy);
      b[18] = (C4_2 * xy) * (7.0f * zz - 1.0f);
      b[19] = (C4_3 * yz) * (7.0f * zz - 3.0f);
      b[20] = C4_4 * (zz * (35.0f * zz - 30.0f) + 3.0f);
      b[21] = (C4_5 * xz) * (7.0f * zz - 3.0f);
      b[22] = (C4_6 * (xx - yy)) * (7.0f * zz - 1.0f);
      b[23] = (C4_7 * xz) * (xx - 3.0f * yy);
      b[24] = C4_8 * (xx * (xx - 3.0f * yy) - yy * (3.0f * xx - yy));
    }
  }
#pragma unroll
  for (int k = 0; k < Layout<D>::K; ++k) b[k] = b[k] * (k < live ? 1.0f : 0.0f);
}

// Element i of a block's slab (rows of R floats) at its place in shared
// memory (rows of SR floats).
template <class L>
__device__ __forceinline__ int slab_at(int i) {
  if constexpr (L::SR == L::R) {
    return i;
  } else {
    return (i / L::R) * L::SR + i % L::R;
  }
}

// total floats from src (device memory) into the slab: 16-byte loads where
// src is 16-byte aligned (a block's slab starts at a multiple of
// THREADS * R floats, so whenever the tensor does).
template <class L>
__device__ __forceinline__ void stage_in(const float* __restrict__ src,
                                         int total, float* slab) {
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int n4 = total >> 2;
    const float4* s4 = reinterpret_cast<const float4*>(src);
    for (int i = threadIdx.x; i < n4; i += THREADS) {
      const float4 v = __ldcs(s4 + i);
      if constexpr (L::SR == L::R) {
        reinterpret_cast<float4*>(slab)[i] = v;
      } else {
        slab[slab_at<L>(4 * i)] = v.x;
        slab[slab_at<L>(4 * i + 1)] = v.y;
        slab[slab_at<L>(4 * i + 2)] = v.z;
        slab[slab_at<L>(4 * i + 3)] = v.w;
      }
    }
    done = n4 << 2;
  }
  for (int i = done + threadIdx.x; i < total; i += THREADS) {
    slab[slab_at<L>(i)] = __ldcs(src + i);
  }
}

// The slab's first total floats out to dst, 16-byte stores where aligned.
template <class L>
__device__ __forceinline__ void stage_out(const float* slab, float* dst,
                                          int total) {
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    const int n4 = total >> 2;
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (int i = threadIdx.x; i < n4; i += THREADS) {
      float4 v;
      if constexpr (L::SR == L::R) {
        v = reinterpret_cast<const float4*>(slab)[i];
      } else {
        v = make_float4(slab[slab_at<L>(4 * i)], slab[slab_at<L>(4 * i + 1)],
                        slab[slab_at<L>(4 * i + 2)],
                        slab[slab_at<L>(4 * i + 3)]);
      }
      __stcs(d4 + i, v);
    }
    done = n4 << 2;
  }
  for (int i = done + threadIdx.x; i < total; i += THREADS) {
    __stcs(dst + i, slab[slab_at<L>(i)]);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
    sh_fwd_kernel(const float* __restrict__ means, long long ms,
                  const float* __restrict__ dc, long long ds,
                  const float* __restrict__ rest,
                  const float* __restrict__ center, long long cs, int live,
                  float* __restrict__ rgb, unsigned char* __restrict__ mask,
                  long long n) {
  using L = Layout<D>;
  __shared__ __align__(16) float slab[L::SMEM];
  const long long base = (long long)blockIdx.x * THREADS;
  const int cnt = n - base < THREADS ? (int)(n - base) : THREADS;
  if constexpr (L::R > 0) {
    stage_in<L>(rest + base * L::R, cnt * L::R, slab);
    __syncthreads();
  }
  const int t = threadIdx.x;
  if (t >= cnt) return;
  const long long g = base + t;
  float b[L::K];
  masked_basis<D>(means + g * ms, center, cs, live, b);
  const float* row = slab + t * L::SR;
  unsigned bits = 0;
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    float acc = b[0] * __ldg(dc + g * ds + ch);
#pragma unroll
    for (int k = 1; k < L::K; ++k) acc = acc + b[k] * row[(k - 1) * 3 + ch];
    const float v = acc + 0.5f;
    rgb[g * 3 + ch] = v < 0.0f ? 0.0f : v;
    bits |= (v >= 0.0f ? 1u : 0u) << ch;
  }
  if (mask != nullptr) mask[g] = static_cast<unsigned char>(bits);
}

template <int D>
__global__ void __launch_bounds__(THREADS)
    sh_bwd_kernel(const float* __restrict__ means, long long ms,
                  const float* __restrict__ center, long long cs, int live,
                  const float* __restrict__ grad, long long gs0,
                  long long gs1, const unsigned char* __restrict__ mask,
                  float* __restrict__ d_dc, float* __restrict__ d_rest,
                  long long n) {
  using L = Layout<D>;
  __shared__ __align__(16) float slab[L::SMEM];
  const long long base = (long long)blockIdx.x * THREADS;
  const int cnt = n - base < THREADS ? (int)(n - base) : THREADS;
  const int t = threadIdx.x;
  if (t < cnt) {
    const long long g = base + t;
    float b[L::K];
    masked_basis<D>(means + g * ms, center, cs, live, b);
    const unsigned bits = __ldg(mask + g);
    float* row = slab + t * L::SR;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      const float gp = (bits >> ch) & 1u ? __ldg(grad + g * gs0 + ch * gs1)
                                         : 0.0f;
      d_dc[g * 3 + ch] = b[0] * gp;
#pragma unroll
      for (int k = 1; k < L::K; ++k) row[(k - 1) * 3 + ch] = b[k] * gp;
    }
  }
  if constexpr (L::R > 0) {
    __syncthreads();
    stage_out<L>(slab, d_rest + base * L::R, cnt * L::R);
  }
}

template <int D>
int launch_fwd(const float* means, long long ms, const float* dc,
               long long ds, const float* rest, const float* center,
               long long cs, int live, float* rgb, unsigned char* mask,
               long long n, cudaStream_t stream) {
  const long long blocks = (n + THREADS - 1) / THREADS;
  sh_fwd_kernel<D><<<(unsigned)blocks, THREADS, 0, stream>>>(
      means, ms, dc, ds, rest, center, cs, live, rgb, mask, n);
  return sg_last_error();
}

template <int D>
int launch_bwd(const float* means, long long ms, const float* center,
               long long cs, int live, const float* grad, long long gs0,
               long long gs1, const unsigned char* mask, float* d_dc,
               float* d_rest, long long n, cudaStream_t stream) {
  const long long blocks = (n + THREADS - 1) / THREADS;
  sh_bwd_kernel<D><<<(unsigned)blocks, THREADS, 0, stream>>>(
      means, ms, center, cs, live, grad, gs0, gs1, mask, d_dc, d_rest, n);
  return sg_last_error();
}

}  // namespace

// means (n, 3) and dc (n, 3) float32 with unit column stride and row
// strides ms, ds (elements); rest (n, (D+1)^2 - 1, 3) float32 contiguous;
// center three float32 values cs apart; live: bases active (0..K); rgb
// (n, 3) float32; mask (n,) uint8 or null (not written).
SG_EXPORT int sg_sh_colors_fwd(const float* means, long long ms,
                               const float* dc, long long ds,
                               const float* rest, const float* center,
                               long long cs, int degree, int live,
                               float* rgb, unsigned char* mask, long long n,
                               void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (degree) {
    case 0: return launch_fwd<0>(means, ms, dc, ds, rest, center, cs, live, rgb, mask, n, s);
    case 1: return launch_fwd<1>(means, ms, dc, ds, rest, center, cs, live, rgb, mask, n, s);
    case 2: return launch_fwd<2>(means, ms, dc, ds, rest, center, cs, live, rgb, mask, n, s);
    case 3: return launch_fwd<3>(means, ms, dc, ds, rest, center, cs, live, rgb, mask, n, s);
    case 4: return launch_fwd<4>(means, ms, dc, ds, rest, center, cs, live, rgb, mask, n, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// grad (n, 3) float32 with strides gs0, gs1 (elements); mask the forward's;
// d_dc (n, 3) and d_rest (n, (D+1)^2 - 1, 3) float32 contiguous.
SG_EXPORT int sg_sh_colors_bwd(const float* means, long long ms,
                               const float* center, long long cs,
                               int degree, int live, const float* grad,
                               long long gs0, long long gs1,
                               const unsigned char* mask, float* d_dc,
                               float* d_rest, long long n, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (degree) {
    case 0: return launch_bwd<0>(means, ms, center, cs, live, grad, gs0, gs1, mask, d_dc, d_rest, n, s);
    case 1: return launch_bwd<1>(means, ms, center, cs, live, grad, gs0, gs1, mask, d_dc, d_rest, n, s);
    case 2: return launch_bwd<2>(means, ms, center, cs, live, grad, gs0, gs1, mask, d_dc, d_rest, n, s);
    case 3: return launch_bwd<3>(means, ms, center, cs, live, grad, gs0, gs1, mask, d_dc, d_rest, n, s);
    case 4: return launch_bwd<4>(means, ms, center, cs, live, grad, gs0, gs1, mask, d_dc, d_rest, n, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
