// Kernel H: inclusive scan (add or max) along axis 0 of a row-major (M, C)
// int32 or float32 array, C in 1..16, in one launch: a single-pass scan
// with decoupled look-back.
//
// Replaces street_gaussians_ns_tpu/ops/scan_pallas.py:_scan_kernel, which
// walks blocks of rows in order on one TPU core, scans each block with
// log-step rolls and hands one carry row to the next grid step. GPU blocks
// run in no order, so the carry row is handed from tile to tile through
// global memory, as kernel A (scan.cu) hands its carry:
//
//   * a block takes its tile number from an atomic ticket, so every tile
//     with a smaller number belongs to a block that has already started;
//   * a tile is THREADS x RPT rows, RPT = PER_THREAD / C (512 rows of 16
//     columns, 1,280 of 6), read once through shared memory with 16-byte
//     loads whatever C is (the shared index is padded one word in 32 so
//     that threads striding by RPT x C words spread over the banks);
//   * a thread scans its RPT rows in registers, column by column (C is a
//     template parameter, so every index is static); the 256 threads'
//     column totals are scanned column by column across the block, a warp
//     taking columns w and w + 8: eight totals in a lane, then one shuffle
//     scan, so a warp runs at most two shuffle scans where the first
//     version ran C a thread;
//   * the tile publishes its column totals (AGGREGATE), finds its prefix by
//     looking back, publishes its running totals (INCLUSIVE), and the block
//     writes its output once.
//
// The descriptors. A's {status, value} fits one 8-byte word; H's tile
// total is up to 16 values. A status word published after separate value
// slots (a fence, a release store, an acquire load before the values)
// costs a reader two trips to L2 per look-back window, and a slower
// look-back lets the published running totals fall further behind the
// newest tiles, which makes every look-back longer still. So a tile
// publishes one 8-byte word {tag, state, value} per column, in a single
// store each, and a reader takes a column's state and value from one
// 8-byte load: it can never see a value without its state, and no fence
// orders one word behind another. The whole block looks back, 32 tiles a
// round (32 x C words, one or two a thread, so no thread holds C loads in
// flight and the kernel stays at 64 registers), up to WINDOWS rounds kept
// in shared memory; a column whose INCLUSIVE lies further back waits on
// the oldest round kept until one appears there.
//
// The order of additions. Column c's exclusive prefix is INCLUSIVE_j +
// AGGREGATE_{j+1} + ... + AGGREGATE_{i-1}, added in ascending tile order
// from the nearest tile j whose INCLUSIVE (in column c) the look-back
// meets; the tile publishes INCLUSIVE_i = prefix + AGGREGATE_i. By
// induction INCLUSIVE_j is bit for bit the left fold AGGREGATE_0 + ... +
// AGGREGATE_j, so the prefix has the same bits whichever j the look-back
// meets: the float32 sum is the same from launch to launch, and the reads
// are linear in the distance to that j (kernel A's float32 add reads all
// its predecessors). Inside a tile the association is fixed. int32 add
// (which wraps), int32 max and float32 max are exact.
// tests/test_torch_redesign_gh.py holds a numpy model of this order and of
// the look-back under random interleavings; the card's result equals it
// bit for bit.
//
// The scratch: word 0 holds the ticket and the finished blocks, word 1 the
// launch count, then MAX_C descriptor words a tile
// (ops/scan.py:_rows_scratch_len). A descriptor counts only if its tag is
// this launch's ((launch count mod 2^30) + 1), so the descriptors never
// need clearing: the last block to finish resets the two counters and
// advances the launch count, which lives in the scratch and so also
// advances when a CUDA graph replays the launch. ops/scan.py keeps the
// scratch per (device, stream), zeroed once when it is made, so a call
// allocates and clears nothing. An array of one tile is scanned without
// scratch.
//
// Bound on the H100: memory. The function reads M x C and writes M x C
// elements of 4 bytes, once each.
#include "common.cuh"

#include <limits.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int PER_THREAD = 32;    // elements a thread owns, at most
constexpr int WINDOWS = 4;        // look-back rounds of 32 tiles kept
constexpr int MIN_BLOCKS = 4;     // blocks an SM: 64 registers a thread
constexpr int MAX_C = 16;
constexpr int HEAD_WORDS = 2;     // {ticket, finished blocks}, launch count
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned INCLUSIVE = 1u;   // the state bit of a descriptor

template <int C>
struct Shape {
  static constexpr int RPT = PER_THREAD / C;    // rows a thread
  static constexpr int E = RPT * C;             // elements a thread
  static constexpr int ROWS = THREADS * RPT;    // rows a tile
  static constexpr int ELEMS = THREADS * E;     // elements a tile
  // Shared words: the tile (padded); aliased over it once the threads
  // hold their rows, the threads' column totals (padded) and the
  // look-back's rounds.
  static constexpr int TOT = C * THREADS + C * THREADS / 32;
  static constexpr int WIN = WINDOWS * 32 * C;
  static constexpr int SMEM = (ELEMS + ELEMS / 32 > TOT + WIN)
                                  ? ELEMS + ELEMS / 32 : TOT + WIN;
};

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

// One 8-byte store / load at device scope: {tag << 1 | state, value}.
__device__ __forceinline__ void publish(unsigned long long* d, unsigned tag,
                                        unsigned state, unsigned bits) {
  const unsigned long long v =
      ((unsigned long long)((tag << 1) | state) << 32) | bits;
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

// scratch: HEAD_WORDS counter words, then MAX_C descriptor words a tile
// (unused when num_tiles == 1; may be null then). In place (out == x) is
// allowed: a tile is read whole before any of it is written.
template <typename T, typename Op, int C>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    rows_lookback_scan(const T* x, T* out, unsigned long long* scratch,
                       long long m, unsigned num_tiles, bool vec) {
  using S = Shape<C>;
  constexpr int LOADS = (S::ELEMS / 4 + THREADS - 1) / THREADS;
  __shared__ T sm[S::SMEM];
  __shared__ T s_agg[MAX_C];
  __shared__ T s_prefix[MAX_C];
  __shared__ unsigned s_tile, s_tag, s_todo;
  __shared__ int s_near[MAX_C];
  __shared__ bool s_incl[32 * MAX_C];
  __shared__ bool s_last;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  unsigned* counters = reinterpret_cast<unsigned*>(scratch);
  unsigned long long* desc = scratch + HEAD_WORDS;

  unsigned tile = 0, tag = 0;
  if (num_tiles > 1) {
    if (tid == 0) {
      s_tile = atomicAdd(&counters[0], 1u);
      // The launch count changes only after every block has taken its
      // ticket and finished its look-back.
      s_tag = (*reinterpret_cast<volatile unsigned*>(&counters[2]) &
               0x3fffffffu) + 1u;
    }
    __syncthreads();
    tile = s_tile;
    tag = s_tag;
  }
  const long long base = (long long)tile * S::ELEMS;
  const int nel = (int)min((long long)S::ELEMS, m * C - base);
  const bool whole = vec && nel == S::ELEMS;

  if (whole) {
    const uint4* src = reinterpret_cast<const uint4*>(x + base);
    uint4 q[LOADS];
#pragma unroll
    for (int k = 0; k < LOADS; ++k) {
      const int i = tid + k * THREADS;
      if (i < S::ELEMS / 4) q[k] = src[i];
    }
#pragma unroll
    for (int k = 0; k < LOADS; ++k) {
      const int i = tid + k * THREADS;
      if (i < S::ELEMS / 4) {
        sm[pad(4 * i + 0)] = from_bits<T>(q[k].x);
        sm[pad(4 * i + 1)] = from_bits<T>(q[k].y);
        sm[pad(4 * i + 2)] = from_bits<T>(q[k].z);
        sm[pad(4 * i + 3)] = from_bits<T>(q[k].w);
      }
    }
  } else {
    // Rows past m hold the identity.
    for (int i = tid; i < S::ELEMS; i += THREADS)
      sm[pad(i)] = i < nel ? x[base + i] : Op::ident();
  }
  __syncthreads();

  // The thread's RPT rows, scanned column by column in registers.
  T v[S::E];
#pragma unroll
  for (int e = 0; e < S::E; ++e) v[e] = sm[pad(tid * S::E + e)];
#pragma unroll
  for (int e = C; e < S::E; ++e) v[e] = Op::apply(v[e - C], v[e]);
  __syncthreads();
  T* tot = sm;                  // [C][THREADS], padded
  T* win = sm + S::TOT;         // [WINDOWS][32][C]: the rounds kept
#pragma unroll
  for (int col = 0; col < C; ++col)
    tot[pad(col * THREADS + tid)] = v[S::E - C + col];
  __syncthreads();

  // Column col's 256 thread totals, scanned by warp col % WARPS: 8 a lane,
  // then one shuffle scan; the exclusive prefixes go back in place.
  for (int col = warp; col < C; col += WARPS) {
    constexpr int K = THREADS / 32;
    const int b = col * THREADS + lane * K;
    T r[K];
#pragma unroll
    for (int k = 0; k < K; ++k) r[k] = tot[pad(b + k)];
#pragma unroll
    for (int k = 1; k < K; ++k) r[k] = Op::apply(r[k - 1], r[k]);
    T t = r[K - 1];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const T y = __shfl_up_sync(FULL, t, off);
      if (lane >= off) t = Op::apply(y, t);
    }
    T ex = __shfl_up_sync(FULL, t, 1);
    if (lane == 0) ex = Op::ident();
    tot[pad(b)] = ex;
#pragma unroll
    for (int k = 1; k < K; ++k) tot[pad(b + k)] = Op::apply(ex, r[k - 1]);
    if (lane == 31) s_agg[col] = t;
  }
  __syncthreads();

  if (num_tiles > 1) {
    // Tile 0 is its own INCLUSIVE.
    if (warp == 0 && lane < C)
      publish(desc + (long long)tile * MAX_C + lane, tag,
              tile == 0 ? INCLUSIVE : 0u, to_bits(s_agg[lane]));
    if (tile > 0) {
      // The whole block looks back (its threads would wait at the next
      // barrier anyway), so a thread holds one or two descriptors and not
      // C: round w reads word q = l C + c (thread q % THREADS) of tile
      // tile - 1 - 32 w - l; a tile before the first reads as an
      // AGGREGATE, never used (tile 0 is INCLUSIVE in every column).
      // Column c's nearest INCLUSIVE is entry s_near[c] of the rounds kept,
      // entry q being tile tile - 1 - q.
      constexpr int WORDS = 32 * C;
      constexpr int PER = (WORDS + THREADS - 1) / THREADS;
      unsigned todo = (1u << C) - 1u;
      int w = 0;
      while (todo) {
        const int slot = w < WINDOWS ? w : WINDOWS - 1;
        unsigned long long d[PER];
        for (;;) {
          bool empty = false;
#pragma unroll
          for (int r = 0; r < PER; ++r) {
            const int q = tid + r * THREADS;
            const long long t = (long long)tile - 1 - 32LL * w - q / C;
            d[r] = (q < WORDS && t >= 0)
                       ? peek(desc + t * MAX_C + q % C)
                       : ((unsigned long long)(tag << 1) << 32);
            empty = empty || (unsigned)(d[r] >> 33) != tag;
          }
          if (!__syncthreads_or(empty)) break;
        }
        // A column already settled keeps the values it was settled on (a
        // re-poll may find its AGGREGATEs turned INCLUSIVE).
#pragma unroll
        for (int r = 0; r < PER; ++r) {
          const int q = tid + r * THREADS;
          if (q < WORDS && ((todo >> (q % C)) & 1u)) {
            win[slot * WORDS + q] = from_bits<T>((unsigned)d[r]);
            s_incl[q] = ((unsigned)(d[r] >> 32) & INCLUSIVE) != 0;
          }
        }
        __syncthreads();
        if (warp == 0) {
#pragma unroll
          for (int c = 0; c < C; ++c) {
            if (!((todo >> c) & 1u)) continue;
            const unsigned incl = __ballot_sync(FULL, s_incl[lane * C + c]);
            if (incl) {
              todo &= ~(1u << c);
              if (lane == 0) s_near[c] = slot * 32 + __ffs(incl) - 1;
            }
          }
          if (lane == 0) s_todo = todo;
        }
        __syncthreads();
        todo = s_todo;
        // Past WINDOWS rounds the oldest one is polled again until every
        // column has an INCLUSIVE there.
        if (w < WINDOWS - 1 || !todo) ++w;
      }
      if (warp == 0 && lane < C) {
        // Forward from the nearest INCLUSIVE, in ascending tile order.
        int q = s_near[lane];
        T prefix = win[q * C + lane];
        for (; q >= 8; q -= 8) {
          T a[8];
#pragma unroll
          for (int k = 0; k < 8; ++k) a[k] = win[(q - 1 - k) * C + lane];
#pragma unroll
          for (int k = 0; k < 8; ++k) prefix = Op::apply(prefix, a[k]);
        }
        for (--q; q >= 0; --q) prefix = Op::apply(prefix, win[q * C + lane]);
        publish(desc + (long long)tile * MAX_C + lane, tag, INCLUSIVE,
                to_bits(Op::apply(prefix, s_agg[lane])));
        s_prefix[lane] = prefix;
      }
    }
    if (tid == 0) {
      // This block reads and writes no descriptor from here on.
      __threadfence();
      s_last = atomicAdd(&counters[1], 1u) == num_tiles - 1;
    }
  }
  if (tile == 0 && tid < C) s_prefix[tid] = Op::ident();
  __syncthreads();

  // Output = (the tile's prefix, then the threads before) + the thread's
  // own running value.
  T pre[C];
#pragma unroll
  for (int col = 0; col < C; ++col)
    pre[col] = Op::apply(s_prefix[col], tot[pad(col * THREADS + tid)]);
#pragma unroll
  for (int e = 0; e < S::E; ++e) v[e] = Op::apply(pre[e % C], v[e]);
  __syncthreads();
#pragma unroll
  for (int e = 0; e < S::E; ++e) sm[pad(tid * S::E + e)] = v[e];
  __syncthreads();
  if (whole) {
    uint4* dst = reinterpret_cast<uint4*>(out + base);
#pragma unroll
    for (int k = 0; k < LOADS; ++k) {
      const int i = tid + k * THREADS;
      if (i < S::ELEMS / 4)
        dst[i] = make_uint4(to_bits(sm[pad(4 * i + 0)]),
                            to_bits(sm[pad(4 * i + 1)]),
                            to_bits(sm[pad(4 * i + 2)]),
                            to_bits(sm[pad(4 * i + 3)]));
    }
  } else {
    for (int i = tid; i < nel; i += THREADS) out[base + i] = sm[pad(i)];
  }

  // The last block to finish resets the counters and moves the launch
  // count on, which retires every descriptor of this launch.
  if (num_tiles > 1 && s_last && tid == 0) {
    counters[0] = counters[1] = 0u;
    counters[2] += 1u;
  }
}

template <typename T, typename Op, int C>
int launch(const void* x, void* out, void* scratch, long long scratch_words,
           long long m, cudaStream_t s) {
  const long long tiles = (m + Shape<C>::ROWS - 1) / Shape<C>::ROWS;
  if (tiles > 0x7fffffffLL ||
      (tiles > 1 && (scratch == nullptr ||
                     scratch_words < HEAD_WORDS + MAX_C * tiles)))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec =
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) &
       15) == 0;
  rows_lookback_scan<T, Op, C><<<(unsigned)tiles, THREADS, 0, s>>>(
      static_cast<const T*>(x), static_cast<T*>(out),
      static_cast<unsigned long long*>(scratch), m, (unsigned)tiles, vec);
  return sg_last_error();
}

template <typename T, typename Op>
int launch_c(const void* x, void* out, void* scratch, long long words,
             long long m, int c, cudaStream_t s) {
  switch (c) {
#define SG_ROWS_CASE(N) \
  case N:               \
    return launch<T, Op, N>(x, out, scratch, words, m, s);
    SG_ROWS_CASE(1) SG_ROWS_CASE(2) SG_ROWS_CASE(3) SG_ROWS_CASE(4)
    SG_ROWS_CASE(5) SG_ROWS_CASE(6) SG_ROWS_CASE(7) SG_ROWS_CASE(8)
    SG_ROWS_CASE(9) SG_ROWS_CASE(10) SG_ROWS_CASE(11) SG_ROWS_CASE(12)
    SG_ROWS_CASE(13) SG_ROWS_CASE(14) SG_ROWS_CASE(15) SG_ROWS_CASE(16)
#undef SG_ROWS_CASE
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x and out (m, c) row-major; dtype: 0 int32, 1 float32. op: 0 add, 1 max.
// scratch: scratch_words 8-byte words, zero when first used and owned by
// this stream until the launch has ended (ops/scan.py:_rows_scratch_len;
// not touched when the array fits one tile).
SG_EXPORT int sg_scan_rows(const void* x, void* out, void* scratch,
                           long long scratch_words, long long m, int c,
                           int dtype, int op, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m <= 0) return 0;
  if (dtype == 0 && op == 0)
    return launch_c<int, AddOp<int>>(x, out, scratch, scratch_words, m, c, s);
  if (dtype == 0 && op == 1)
    return launch_c<int, MaxOp<int>>(x, out, scratch, scratch_words, m, c, s);
  if (dtype == 1 && op == 0)
    return launch_c<float, AddOp<float>>(x, out, scratch, scratch_words, m, c,
                                         s);
  if (dtype == 1 && op == 1)
    return launch_c<float, MaxOp<float>>(x, out, scratch, scratch_words, m, c,
                                         s);
  return static_cast<int>(cudaErrorInvalidValue);
}
