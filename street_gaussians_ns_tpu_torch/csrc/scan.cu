// Kernel A: inclusive flat scan (add or max) of an int32 or float32 (M,)
// array.
//
// Replaces street_gaussians_ns_tpu/ops/scan_pallas.py:_flat_scan_kernel,
// which walks the blocks in order on one TPU core and carries the running
// total in scratch memory. GPU blocks run in no order, so the carry becomes
// a tree: (1) every block scans its TILE elements (per-thread serial scan,
// warp shuffle scan, block scan of warp totals) and writes its total;
// (2) the block totals are scanned by the same routine, recursively;
// (3) every block but the first combines its scanned predecessor total
// into its elements.
//
// Bound on the H100: memory. The function reads M and writes M elements
// (4 bytes each); the recursion adds M/TILE elements per level and the
// offset pass re-reads and re-writes the output once more. A single-pass
// decoupled look-back scan would remove that second pass (a later
// optimisation; the scans on the render path are ~1.3-1.7 M elements).
#include "common.cuh"

#include <limits.h>
#include <math.h>

namespace {

constexpr int THREADS = 512;
constexpr int ITEMS = 8;
constexpr int TILE = THREADS * ITEMS;  // elements per block

template <typename T>
struct AddOp {
  __device__ static T ident() { return T(0); }
  __device__ static T apply(T a, T b) { return a + b; }
};

template <typename T>
struct MaxOp;

template <>
struct MaxOp<int> {
  __device__ static int ident() { return INT_MIN; }
  __device__ static int apply(int a, int b) { return a > b ? a : b; }
};

template <>
struct MaxOp<float> {
  __device__ static float ident() { return -INFINITY; }
  __device__ static float apply(float a, float b) { return fmaxf(a, b); }
};

// Scans one TILE of x into out (in place allowed: each thread reads its own
// elements before writing them). totals[blockIdx.x] gets the tile total.
template <typename T, typename Op>
__global__ void __launch_bounds__(THREADS)
    block_scan(const T* x, T* out, T* totals, long long n) {
  __shared__ T warp_tot[THREADS / 32];
  const long long base =
      (long long)blockIdx.x * TILE + (long long)threadIdx.x * ITEMS;
  T v[ITEMS];
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const long long j = base + i;
    v[i] = j < n ? x[j] : Op::ident();
  }
#pragma unroll
  for (int i = 1; i < ITEMS; ++i) v[i] = Op::apply(v[i - 1], v[i]);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  T t = v[ITEMS - 1];
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const T y = __shfl_up_sync(0xffffffffu, t, off);
    if (lane >= off) t = Op::apply(y, t);
  }
  if (lane == 31) warp_tot[warp] = t;
  __syncthreads();
  if (warp == 0) {
    T w = lane < THREADS / 32 ? warp_tot[lane] : Op::ident();
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const T y = __shfl_up_sync(0xffffffffu, w, off);
      if (lane >= off) w = Op::apply(y, w);
    }
    if (lane < THREADS / 32) warp_tot[lane] = w;
  }
  __syncthreads();
  // Exclusive prefix of this thread within the block.
  T excl = __shfl_up_sync(0xffffffffu, t, 1);
  if (lane == 0) excl = Op::ident();
  if (warp > 0) excl = Op::apply(warp_tot[warp - 1], excl);
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const long long j = base + i;
    if (j < n) out[j] = Op::apply(excl, v[i]);
  }
  if (totals != nullptr && threadIdx.x == THREADS - 1)
    totals[blockIdx.x] = Op::apply(excl, v[ITEMS - 1]);
}

// Block b (of tiles 1..nb-1) combines the scanned total of tiles < b.
template <typename T, typename Op>
__global__ void __launch_bounds__(THREADS)
    add_offsets(T* out, const T* scanned_totals, long long n) {
  const long long b = (long long)blockIdx.x + 1;
  const T off = scanned_totals[b - 1];
  const long long base = b * TILE;
  for (int i = threadIdx.x; i < TILE; i += THREADS) {
    const long long j = base + i;
    if (j < n) out[j] = Op::apply(off, out[j]);
  }
}

// scratch must hold sum over levels of ceil(n_level / TILE) elements while
// n_level > TILE (ops/scan.py:_scratch_len computes the same sum).
template <typename T, typename Op>
void scan_rec(const T* x, T* out, T* scratch, long long n, cudaStream_t s) {
  const long long nb = (n + TILE - 1) / TILE;
  if (nb <= 1) {
    block_scan<T, Op><<<1, THREADS, 0, s>>>(x, out, nullptr, n);
    return;
  }
  T* totals = scratch;
  block_scan<T, Op><<<(unsigned)nb, THREADS, 0, s>>>(x, out, totals, n);
  scan_rec<T, Op>(totals, totals, scratch + nb, nb, s);
  add_offsets<T, Op><<<(unsigned)(nb - 1), THREADS, 0, s>>>(out, totals, n);
}

}  // namespace

// dtype: 0 int32, 1 float32. op: 0 add, 1 max.
SG_EXPORT int sg_flat_scan(const void* x, void* out, void* scratch,
                           long long n, int dtype, int op, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0) return 0;
  if (dtype == 0 && op == 0)
    scan_rec<int, AddOp<int>>(static_cast<const int*>(x),
                              static_cast<int*>(out),
                              static_cast<int*>(scratch), n, s);
  else if (dtype == 0 && op == 1)
    scan_rec<int, MaxOp<int>>(static_cast<const int*>(x),
                              static_cast<int*>(out),
                              static_cast<int*>(scratch), n, s);
  else if (dtype == 1 && op == 0)
    scan_rec<float, AddOp<float>>(static_cast<const float*>(x),
                                  static_cast<float*>(out),
                                  static_cast<float*>(scratch), n, s);
  else if (dtype == 1 && op == 1)
    scan_rec<float, MaxOp<float>>(static_cast<const float*>(x),
                                  static_cast<float*>(out),
                                  static_cast<float*>(scratch), n, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return sg_last_error();
}
