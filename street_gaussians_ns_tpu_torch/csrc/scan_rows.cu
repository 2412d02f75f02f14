// Kernel H: inclusive scan (add or max) along axis 0 of a row-major (M, C)
// int32 or float32 array, C in 1..16.
//
// Replaces street_gaussians_ns_tpu/ops/scan_pallas.py:_scan_kernel, which
// walks blocks of rows in order on one TPU core, scans each block with
// log-step rolls and hands one carry row to the next grid step. GPU blocks
// run in no order, so the carry becomes a tree, as in kernel A (scan.cu):
// (1) every block scans its slab of rows and writes one row of column
// totals; (2) the (blocks, C) totals are scanned by the same routine,
// recursively; (3) every block but the first combines the scanned totals
// row of its predecessor into its rows.
//
// A slab is ELEMS contiguous elements: THREADS threads, each owning
// rpt = 32 / C consecutive rows. The slab goes through shared memory, so
// the loads and stores are coalesced whatever C is; the shared index is
// padded by one word in 32 so that threads striding by rpt * C words do
// not meet in one bank. A thread scans its rows serially per column, the
// thread totals are scanned across the warp by shuffles and across the 8
// warps through shared memory, in a fixed order: the float32 sums do not
// change from run to run (their association differs from a serial sum's).
// int32 sums wrap.
//
// Bound on the H100: memory. The function reads M x C and writes M x C
// elements of 4 bytes; the offsets pass re-reads and re-writes the output
// once more.
#include "common.cuh"

#include <limits.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int PER_THREAD = 32;               // elements a thread owns, at most
constexpr int ELEMS = THREADS * PER_THREAD;  // elements of a slab, at most
constexpr int MAX_C = 16;
constexpr unsigned FULL = 0xffffffffu;

template <typename T>
struct AddOp;

template <>
struct AddOp<int> {
  __device__ static int ident() { return 0; }
  __device__ static int apply(int a, int b) {
    return (int)((unsigned)a + (unsigned)b);
  }
};

template <>
struct AddOp<float> {
  __device__ static float ident() { return 0.0f; }
  __device__ static float apply(float a, float b) { return a + b; }
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

__device__ __forceinline__ int pad(int i) { return i + (i >> 5); }

// Scans one slab of rpt * THREADS rows of x into out (in place allowed: the
// slab is read whole before any of it is written). totals, when non-null,
// gets the slab's column totals as row blockIdx.x of a (blocks, c) array.
template <typename T, typename Op>
__global__ void __launch_bounds__(THREADS)
    rows_block_scan(const T* x, T* out, T* totals, long long m, int c,
                    int rpt) {
  __shared__ T sm[ELEMS + ELEMS / 32];
  __shared__ T warp_tot[WARPS][MAX_C];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long rb = (long long)THREADS * rpt;
  const long long row0 = (long long)blockIdx.x * rb;
  const long long nrows = min(rb, m - row0);
  const int nel = (int)(nrows * c);
  const int slab = (int)rb * c;
  const T* src = x + row0 * c;
  for (int i = tid; i < slab; i += THREADS)
    sm[pad(i)] = i < nel ? src[i] : Op::ident();
  __syncthreads();

  const int base = tid * rpt * c;
  T excl[MAX_C];
#pragma unroll
  for (int col = 0; col < MAX_C; ++col) {
    excl[col] = Op::ident();
    if (col < c) {
      T run = sm[pad(base + col)];
      for (int r = 1; r < rpt; ++r) {
        const int j = pad(base + r * c + col);
        run = Op::apply(run, sm[j]);
        sm[j] = run;
      }
      T t = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const T y = __shfl_up_sync(FULL, t, off);
        if (lane >= off) t = Op::apply(y, t);
      }
      if (lane == 31) warp_tot[warp][col] = t;
      const T e = __shfl_up_sync(FULL, t, 1);
      if (lane > 0) excl[col] = e;
    }
  }
  __syncthreads();

#pragma unroll
  for (int col = 0; col < MAX_C; ++col) {
    if (col < c) {
      T off = Op::ident();
      for (int w = 0; w < warp; ++w) off = Op::apply(off, warp_tot[w][col]);
      off = Op::apply(off, excl[col]);
      for (int r = 0; r < rpt; ++r) {
        const int j = pad(base + r * c + col);
        sm[j] = Op::apply(off, sm[j]);
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < nel; i += THREADS) out[row0 * c + i] = sm[pad(i)];
  // Rows past m hold the identity, so the slab's last row is its total.
  if (totals != nullptr && tid < c)
    totals[(long long)blockIdx.x * c + tid] = sm[pad(slab - c + tid)];
}

// Block b (of slabs 1..nb-1) combines row b - 1 of the scanned totals.
template <typename T, typename Op>
__global__ void __launch_bounds__(THREADS)
    rows_add_offsets(T* out, const T* scanned_totals, long long m, int c,
                     int rpt) {
  __shared__ T off[MAX_C];
  const long long b = (long long)blockIdx.x + 1;
  if (threadIdx.x < c) off[threadIdx.x] = scanned_totals[(b - 1) * c + threadIdx.x];
  __syncthreads();
  const long long rb = (long long)THREADS * rpt;
  const long long row0 = b * rb;
  const int nel = (int)(min(rb, m - row0) * c);
  T* dst = out + row0 * c;
  for (int i = threadIdx.x; i < nel; i += THREADS)
    dst[i] = Op::apply(off[i % c], dst[i]);
}

// scratch must hold the sum over levels of blocks_level * c elements while
// blocks_level > 1 (ops/scan.py:_rows_scratch_len computes the same sum).
template <typename T, typename Op>
void scan_rows_rec(const T* x, T* out, T* scratch, long long m, int c,
                   cudaStream_t s) {
  const int rpt = PER_THREAD / c;
  const long long rb = (long long)THREADS * rpt;
  const long long nb = (m + rb - 1) / rb;
  if (nb <= 1) {
    rows_block_scan<T, Op><<<1, THREADS, 0, s>>>(x, out, nullptr, m, c, rpt);
    return;
  }
  T* totals = scratch;
  rows_block_scan<T, Op><<<(unsigned)nb, THREADS, 0, s>>>(x, out, totals, m,
                                                          c, rpt);
  scan_rows_rec<T, Op>(totals, totals, scratch + nb * c, nb, c, s);
  rows_add_offsets<T, Op><<<(unsigned)(nb - 1), THREADS, 0, s>>>(
      out, totals, m, c, rpt);
}

}  // namespace

// x and out (m, c) row-major; dtype: 0 int32, 1 float32. op: 0 add, 1 max.
SG_EXPORT int sg_scan_rows(const void* x, void* out, void* scratch,
                           long long m, int c, int dtype, int op,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m <= 0) return 0;
  if (c < 1 || c > MAX_C) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0 && op == 0)
    scan_rows_rec<int, AddOp<int>>(static_cast<const int*>(x),
                                   static_cast<int*>(out),
                                   static_cast<int*>(scratch), m, c, s);
  else if (dtype == 0 && op == 1)
    scan_rows_rec<int, MaxOp<int>>(static_cast<const int*>(x),
                                   static_cast<int*>(out),
                                   static_cast<int*>(scratch), m, c, s);
  else if (dtype == 1 && op == 0)
    scan_rows_rec<float, AddOp<float>>(static_cast<const float*>(x),
                                       static_cast<float*>(out),
                                       static_cast<float*>(scratch), m, c, s);
  else if (dtype == 1 && op == 1)
    scan_rows_rec<float, MaxOp<float>>(static_cast<const float*>(x),
                                       static_cast<float*>(out),
                                       static_cast<float*>(scratch), m, c, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return sg_last_error();
}
