// Kernel I: the row trim of the fused binning. For gaussian g with the
// int32 tile box [x0b, x1b) x [y0b, y1b), h = y1b - y0b rows, and coverage
// level q, w_i is the tile-column width its q-contour ellipse covers in box
// row i (core/projection.row_tile_range), for i < min(h, max_h). The kernel
// writes first[g] and last[g], the first and last row with w_i > 0 (-1
// where there is none), and count[g] = sum of w_i, the gaussian's exact
// pair count (ops/tiles.py _row_trim_counts).
//
// Replaces no Pallas kernel: the JAX package's trim,
// street_gaussians_ns_tpu/ops/tiles.py:93 _row_trim_counts, is jnp code that
// XLA fuses into one pass over an (N, max_h) broadcast. The port's plain
// version (ops/tiles.py _row_trim_counts_plain) runs that broadcast eagerly
// in chunks of 2^23 elements: about 50 elementwise launches a chunk, each
// intermediate a round trip through device memory.
//
// Bound on the H100: memory. The function reads about 56 bytes a gaussian
// (x and y and the conic from strided rows of the depth-sorted table, the
// box as one 16-byte load, q) and writes 12; its arithmetic, a few dozen
// flops a box row, is far below the card's rate. So one thread owns one
// gaussian and keeps the rest in registers. What depends on the gaussian
// alone (a and c clamped, q clamped, det, dym, dy_v, q a) is formed once,
// then a loop walks only the rows the box has, carrying the running first,
// last and sum. No shared memory, no atomics, nothing across blocks: each
// gaussian's result depends on its own row of the inputs alone.
//
// Rounding is the plain version's on the card, op for op, so the three
// outputs equal it bit for bit on every input, non-finite ones included:
//   * IEEE sqrtf and division (nvcc's defaults without fast-math) and no
//     multiply-add contraction (-fmad=false, ops/_cuda.py NVCC_FLAGS);
//   * the division by the tile size is a product with 1.0f / tile_size,
//     as PyTorch's CUDA division by a scalar computes it (exact for 16);
//   * min, max and clamp return a NaN operand as torch.minimum,
//     torch.maximum and torch.clamp do; fminf / fmaxf would drop it;
//   * floor, then the float -> int32 conversion of PyTorch's CUDA
//     .to(torch.int32) (cvt.rzi), as core/projection._floor_int uses it
//     on the card: out-of-range values saturate, NaN is 0;
//   * int32 sums and differences wrap, as PyTorch's do (so a floor of
//     INT_MAX plus one is INT_MIN, as in the JAX package).
#include "common.cuh"

namespace {

constexpr int THREADS = 256;

// torch.maximum / torch.minimum: a NaN operand is the result.
__device__ __forceinline__ float t_max(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return a > b ? a : b;
}

__device__ __forceinline__ float t_min(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return a < b ? a : b;
}

// torch.clamp(v, min=lo) with lo not NaN: NaN stays NaN.
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return (v != v || v >= lo) ? v : lo;
}

// core/projection._floor_int on the card: floor, then the conversion of
// PyTorch's CUDA .to(torch.int32) (cvt.rzi) written out: out-of-range
// values saturate, NaN becomes 0.
__device__ __forceinline__ int floor_int(float v) {
  const float f = floorf(v);
  if (f != f) return 0;
  if (f >= 2147483648.0f) return 2147483647;
  if (f <= -2147483648.0f) return -2147483647 - 1;
  return static_cast<int>(f);
}

__device__ __forceinline__ int wrap_add(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}

__device__ __forceinline__ int wrap_sub(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(b));
}

__global__ void __launch_bounds__(THREADS)
    row_trim_kernel(const float* __restrict__ conics, long long conic_stride,
                    const float* __restrict__ xys, long long xy_stride,
                    const int4* __restrict__ box, const float* __restrict__ q,
                    int* __restrict__ first_out, int* __restrict__ last_out,
                    int* __restrict__ count_out, long long n, int tile_size,
                    int max_h) {
  const long long g = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (g >= n) return;
  const int4 bx = __ldg(box + g);          // x0b, x1b, y0b, y1b
  const int h = wrap_sub(bx.w, bx.z);
  const int rows = h < max_h ? h : max_h;
  int first = -1, last = -1;
  unsigned sum = 0;
  if (rows > 0) {
    const float* cn = conics + g * conic_stride;
    const float* xy = xys + g * xy_stride;
    // ellipse_row_xrange's per-gaussian terms, in its order of operations.
    const float a = clamp_min(__ldg(cn), static_cast<float>(1e-12));
    const float b = __ldg(cn + 1);
    const float c = clamp_min(__ldg(cn + 2), static_cast<float>(1e-12));
    const float qq = clamp_min(__ldg(q + g), 0.0f);
    const float cx = __ldg(xy), cy = __ldg(xy + 1);
    const float det = clamp_min(a * c - b * b, static_cast<float>(1e-12));
    const float dym = sqrtf(qq * a / det);
    const float ndym = -dym;
    const float dy_v = -sqrtf(qq) * b / sqrtf(det * c);
    const float ndy_v = -dy_v;
    const float qa = qq * a;
    const float nb = -b;
    const bool q_pos = qq > 0.0f;
    const float tile_f = static_cast<float>(tile_size);
    const float inv_tile = 1.0f / tile_f;
    for (int i = 0; i < rows; ++i) {
      // row_tile_range for tile row ty = y0b + i.
      const int ty = wrap_add(bx.z, i);
      const float ylo = static_cast<float>(
          static_cast<int>(static_cast<unsigned>(ty) *
                           static_cast<unsigned>(tile_size)));
      const float yhi = ylo + tile_f;
      const float rlo = ylo - cy, rhi = yhi - cy;
      const float dlo = t_min(t_max(rlo, ndym), dym);
      const float dhi = t_min(t_max(rhi, ndym), dym);
      const bool valid = (rlo <= dym) & (rhi >= ndym) & q_pos;
      const float dy_hi = t_min(t_max(dy_v, dlo), dhi);
      const float dy_lo = t_min(t_max(ndy_v, dlo), dhi);
      const float s_hi = sqrtf(clamp_min(qa - det * dy_hi * dy_hi, 0.0f));
      const float s_lo = sqrtf(clamp_min(qa - det * dy_lo * dy_lo, 0.0f));
      const float x_hi = cx + (nb * dy_hi + s_hi) / a;
      const float x_lo = cx + (nb * dy_lo + (-s_lo)) / a;
      int x0 = floor_int(x_lo * inv_tile);
      x0 = x0 > bx.x ? x0 : bx.x;
      x0 = x0 < bx.y ? x0 : bx.y;
      int x1 = wrap_add(floor_int(x_hi * inv_tile), 1);
      x1 = x1 > x0 ? x1 : x0;
      x1 = x1 < bx.y ? x1 : bx.y;
      const bool in_row = valid & (ty >= bx.z) & (ty < bx.w);
      const int w = in_row ? wrap_sub(x1, x0) : 0;
      if (w > 0) {
        if (first < 0) first = i;
        last = i;
      }
      sum += static_cast<unsigned>(w);
    }
  }
  first_out[g] = first;
  last_out[g] = last;
  count_out[g] = static_cast<int>(sum);
}

}  // namespace

// conics (n, 3) and xys (n, 2) float32 with unit column stride and the given
// row strides (elements); box (n, 4) int32 contiguous and 16-byte aligned;
// q (n,) float32; first, last, count (n,) int32.
SG_EXPORT int sg_row_trim(const float* conics, long long conic_stride,
                          const float* xys, long long xy_stride,
                          const int* box, const float* q, int* first,
                          int* last, int* count, long long n, int tile_size,
                          int max_h, void* stream) {
  if (tile_size <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  const long long blocks = (n + THREADS - 1) / THREADS;
  row_trim_kernel<<<(unsigned)blocks, THREADS, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      conics, conic_stride, xys, xy_stride,
      reinterpret_cast<const int4*>(box), q, first, last, count, n,
      tile_size, max_h);
  return sg_last_error();
}
