// Kernel A: inclusive flat scan (add or max) of an int32 or float32 (M,)
// array, in one launch: a single-pass scan with decoupled look-back.
//
// Replaces street_gaussians_ns_tpu/ops/scan_pallas.py:_flat_scan_kernel,
// which walks the blocks in order on one TPU core and carries the running
// total in scratch memory. GPU blocks run in no order, so the carry is
// handed from tile to tile through global memory instead:
//
//   * a block takes its tile number from an atomic ticket, so every tile
//     with a smaller number belongs to a block that has already started
//     (a block never waits for one that the card has yet to schedule);
//   * it scans its TILE elements in registers (16 a thread, read 16 bytes
//     at a time; thread scan, warp shuffle scan, scan of the warp totals);
//   * its first warp publishes the tile's total as one 64-bit descriptor
//     {status, value} with a single 8-byte store, so status and value are
//     never seen torn and no other memory has to be ordered behind the
//     flag: AGGREGATE carries the tile's own total, INCLUSIVE the total of
//     everything up to and including the tile;
//   * the warp then looks back over its predecessors' descriptors, 32 at
//     a time, adding AGGREGATEs until it meets an INCLUSIVE, publishes its
//     own INCLUSIVE, and the block writes its output once. (Rounds of 128
//     descriptors, four a lane, were measured at the render's sizes and
//     bought nothing.)
//
// int32 add, int32 max and float32 max do not depend on the order of
// combination, so the result is exact and the same from launch to launch
// whichever descriptors a tile happens to find summarised. float32 add
// does depend on it, so that instantiation (ORDERED) never publishes an
// INCLUSIVE past tile 0: every tile adds the AGGREGATEs of all its
// predecessors in one fixed order (windows of 32 from the nearest back, a
// fixed shuffle tree inside a window). An AGGREGATE needs no look-back, so
// nothing serialises; the descriptor reads grow with the square of the
// tile count (131 k reads at 2.1 M elements), which no caller pays: the
// render's scans are all int32.
//
// The scratch (one word of counters, one descriptor a tile) must be zero
// at launch. It is kept per (device, stream) by ops/scan.py and the last
// block to finish zeroes it again: every other block has then finished
// its look-back, and the next launch on that stream starts after this one
// ends. That spares a memset and an allocation per call, and the scan is
// bound by its launch, not its bytes (8-17 MB a call, 2.5-5 us at 3.35
// TB/s): one kernel launch is what a call costs on the card. (Telling the
// launches apart by an epoch in the status word would spare the zeroing
// too, but a launch replayed from a CUDA graph would then meet its own
// earlier descriptors; zeroed scratch stays right under replay.) An array of
// one tile or less is scanned by a single block and touches no scratch.
#include "common.cuh"

#include <limits.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr int ITEMS = 16;
constexpr int TILE = THREADS * ITEMS;  // elements per block
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned EMPTY = 0, AGGREGATE = 1, INCLUSIVE = 2;

__device__ __forceinline__ unsigned to_bits(int v) { return (unsigned)v; }
__device__ __forceinline__ unsigned to_bits(float v) {
  return __float_as_uint(v);
}
template <typename T>
__device__ __forceinline__ T from_bits(unsigned b);
template <>
__device__ __forceinline__ int from_bits<int>(unsigned b) { return (int)b; }
template <>
__device__ __forceinline__ float from_bits<float>(unsigned b) {
  return __uint_as_float(b);
}

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

__device__ __forceinline__ unsigned long long descriptor(unsigned status,
                                                         unsigned bits) {
  return ((unsigned long long)status << 32) | bits;
}

// One 8-byte store / load at device scope; the descriptor carries its own
// value, so relaxed ordering is enough.
__device__ __forceinline__ void publish(unsigned long long* d,
                                        unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(d), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long peek(
    const unsigned long long* d) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(d)
               : "memory");
  return v;
}

// scratch[0] holds two 32-bit counters (the ticket, the finished blocks),
// scratch[1 + t] the descriptor of tile t. With num_tiles == 1 the scratch
// is not touched (it may be null). In place (out == x) is allowed: a
// thread reads its own elements before it writes them.
template <typename T, typename Op, bool ORDERED, bool VEC>
__global__ void __launch_bounds__(THREADS)
    lookback_scan(const T* x, T* out, unsigned long long* scratch,
                  long long n, unsigned num_tiles) {
  __shared__ T warp_tot[WARPS];
  __shared__ T s_prefix;
  __shared__ unsigned s_tile;
  __shared__ bool s_last;
  unsigned* counters = reinterpret_cast<unsigned*>(scratch);
  unsigned long long* desc = scratch + 1;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  unsigned tile = 0;
  if (num_tiles > 1) {
    if (threadIdx.x == 0) s_tile = atomicAdd(&counters[0], 1u);
    __syncthreads();
    tile = s_tile;
  }

  const long long base =
      (long long)tile * TILE + (long long)threadIdx.x * ITEMS;
  const bool whole = VEC && base + ITEMS <= n;
  T v[ITEMS];
  if (whole) {
    const uint4* src = reinterpret_cast<const uint4*>(x + base);
#pragma unroll
    for (int k = 0; k < ITEMS / 4; ++k) {
      const uint4 q = src[k];
      v[4 * k + 0] = from_bits<T>(q.x);
      v[4 * k + 1] = from_bits<T>(q.y);
      v[4 * k + 2] = from_bits<T>(q.z);
      v[4 * k + 3] = from_bits<T>(q.w);
    }
  } else {
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const long long j = base + i;
      v[i] = j < n ? x[j] : Op::ident();
    }
  }
#pragma unroll
  for (int i = 1; i < ITEMS; ++i) v[i] = Op::apply(v[i - 1], v[i]);

  T t = v[ITEMS - 1];
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const T y = __shfl_up_sync(FULL, t, off);
    if (lane >= off) t = Op::apply(y, t);
  }
  if (lane == 31) warp_tot[warp] = t;
  __syncthreads();

  if (warp == 0) {
    T w = lane < WARPS ? warp_tot[lane] : Op::ident();
#pragma unroll
    for (int off = 1; off < WARPS; off <<= 1) {
      const T y = __shfl_up_sync(FULL, w, off);
      if (lane >= off) w = Op::apply(y, w);
    }
    if (lane < WARPS) warp_tot[lane] = w;
    const T agg = __shfl_sync(FULL, w, WARPS - 1);   // the tile's total

    T prefix = Op::ident();
    if (num_tiles > 1) {
      if (tile == 0) {
        if (lane == 0) publish(desc, descriptor(INCLUSIVE, to_bits(agg)));
      } else {
        if (lane == 0)
          publish(desc + tile, descriptor(AGGREGATE, to_bits(agg)));
        // Lane l of a window looks at tile b - l; a tile before the first
        // counts as an INCLUSIVE of the identity.
        for (int b = (int)tile - 1;; b -= 32) {
          const int idx = b - lane;
          unsigned long long d;
          do {
            d = idx >= 0 ? peek(desc + idx)
                         : descriptor(INCLUSIVE, to_bits(Op::ident()));
          } while (__any_sync(FULL, (unsigned)(d >> 32) == EMPTY));
          const unsigned incl =
              __ballot_sync(FULL, (unsigned)(d >> 32) == INCLUSIVE);
          // The nearest INCLUSIVE ends the look-back; tiles behind it are
          // already inside its value.
          const int last = incl ? __ffs(incl) - 1 : 31;
          T s = lane <= last ? from_bits<T>((unsigned)d) : Op::ident();
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            s = Op::apply(s, __shfl_down_sync(FULL, s, off));
          prefix = Op::apply(__shfl_sync(FULL, s, 0), prefix);
          if (incl) break;
        }
        if (!ORDERED && lane == 0)
          publish(desc + tile,
                  descriptor(INCLUSIVE, to_bits(Op::apply(prefix, agg))));
      }
      if (lane == 0) {
        // This block reads and writes no descriptor from here on.
        __threadfence();
        s_last = atomicAdd(&counters[1], 1u) == num_tiles - 1;
      }
    }
    if (lane == 0) s_prefix = prefix;
  }
  __syncthreads();

  // Exclusive prefix of this thread: the tiles before, the warps before,
  // the lanes before.
  T excl = __shfl_up_sync(FULL, t, 1);
  if (lane == 0) excl = Op::ident();
  if (warp > 0) excl = Op::apply(warp_tot[warp - 1], excl);
  excl = Op::apply(s_prefix, excl);
  if (whole) {
    uint4* dst = reinterpret_cast<uint4*>(out + base);
#pragma unroll
    for (int k = 0; k < ITEMS / 4; ++k) {
      uint4 q;
      q.x = to_bits(Op::apply(excl, v[4 * k + 0]));
      q.y = to_bits(Op::apply(excl, v[4 * k + 1]));
      q.z = to_bits(Op::apply(excl, v[4 * k + 2]));
      q.w = to_bits(Op::apply(excl, v[4 * k + 3]));
      dst[k] = q;
    }
  } else {
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const long long j = base + i;
      if (j < n) out[j] = Op::apply(excl, v[i]);
    }
  }

  // The last block to finish leaves the scratch zeroed for the next
  // launch on this stream.
  if (num_tiles > 1 && s_last) {
    __threadfence();
    for (unsigned i = threadIdx.x; i < num_tiles; i += THREADS)
      desc[i] = 0ull;
    if (threadIdx.x == 0) scratch[0] = 0ull;
  }
}

template <typename T, typename Op, bool ORDERED>
int launch(const void* x, void* out, void* scratch, long long n,
           unsigned num_tiles, cudaStream_t s) {
  const T* xi = static_cast<const T*>(x);
  T* oi = static_cast<T*>(out);
  unsigned long long* sc = static_cast<unsigned long long*>(scratch);
  const bool vec =
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) &
       15) == 0;
  if (vec)
    lookback_scan<T, Op, ORDERED, true><<<num_tiles, THREADS, 0, s>>>(
        xi, oi, sc, n, num_tiles);
  else
    lookback_scan<T, Op, ORDERED, false><<<num_tiles, THREADS, 0, s>>>(
        xi, oi, sc, n, num_tiles);
  return sg_last_error();
}

}  // namespace

// dtype: 0 int32, 1 float32. op: 0 add, 1 max. scratch: scratch_words
// 8-byte words, all zero, owned by this stream until the launch has ended
// (at least 1 + ceil(n / 4096) of them when n > 4096; else not touched).
SG_EXPORT int sg_flat_scan(const void* x, void* out, void* scratch,
                           long long scratch_words, long long n, int dtype,
                           int op, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0) return 0;
  const long long tiles = (n + TILE - 1) / TILE;
  if (tiles > 0x7fffffffLL ||
      (tiles > 1 && (scratch == nullptr || scratch_words < tiles + 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned nt = static_cast<unsigned>(tiles);
  if (dtype == 0 && op == 0)
    return launch<int, AddOp<int>, false>(x, out, scratch, n, nt, s);
  if (dtype == 0 && op == 1)
    return launch<int, MaxOp<int>, false>(x, out, scratch, n, nt, s);
  if (dtype == 1 && op == 0)
    return launch<float, AddOp<float>, true>(x, out, scratch, n, nt, s);
  if (dtype == 1 && op == 1)
    return launch<float, MaxOp<float>, false>(x, out, scratch, n, nt, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
