// Kernel K: one Adam step of every leaf of every optimizer group in one
// launch (engine/optimizers.adam_step on CUDA tensors). For each element of
// leaf l, with its group's float32 constants:
//   g' = active[row] ? g : +0.0          (row = element / floats a row)
//   m' = b1 m + (1 - b1) g'
//   v' = b2 v + (1 - b2) (g' g')
//   p' = p - lr (m' / c1) / (sqrt(v' / c2) + eps)
// written to new tensors p', m', v' (nothing is written into the
// arguments). A leaf without an `active` mask reads every gradient.
//
// Replaces no Pallas kernel: the JAX package's Adam,
// street_gaussians_ns_tpu/engine/optimizers.py:72 adam_update, is jnp code
// that XLA fuses, and its inactive-row mask (engine/scene_train_step.py:50
// mask_inactive_grads) a jnp.where fused beside it. The port's plain
// version (engine/optimizers._adam_plain, and the row mask before it) runs
// 14 elementwise launches a leaf and a masked copy of every gaussian
// gradient: ~128 bytes of device traffic a float.
//
// Bound on the H100: memory. A float is read four times (p, g, m, v) and
// written three times (p', m', v'): 28 bytes, plus one mask byte a row;
// the arithmetic, a dozen flops, is far below the card's rate. So the
// design moves those bytes once and nothing else:
//   * the table of up to 32 leaves is a kernel parameter (passed by value,
//     under 4 KB), so one launch covers every group and no table is copied
//     to the card first;
//   * the launch's work items are the leaves' items laid end to end, and
//     every thread strides over all of them (a grid of the blocks the card
//     holds at once), so small leaves (the bbox deltas) cost no launch and
//     large ones (the background, the sky) spread over every SM;
//   * an item is 4 floats through 16-byte streaming loads and stores where
//     all seven of a leaf's pointers are 16-byte aligned (the tail of such
//     a leaf, and every float of a leaf that is not, one float at a time);
//   * the mask byte is read where the gradient is, so no masked copy is
//     made and an inactive row's gradient, finite or not, never reaches
//     the moments.
//
// Rounding is PyTorch's on the card, op for op (no multiply-add
// contraction, ops/_cuda.py NVCC_FLAGS; IEEE sqrtf and division):
//   * b1, 1 - b1, b2, 1 - b2, lr and eps are the Python doubles rounded to
//     float32, as PyTorch rounds a Python scalar multiplied into (added to)
//     a float32 tensor;
//   * m' / c1 and v' / c2 are products with the float32 reciprocal of the
//     float32 c1, c2 (the wrapper passes it): PyTorch's CUDA division of a
//     tensor by a host scalar multiplies by 1 / scalar formed on the host;
//   * the quotient of the two tensors is an IEEE division.
// So p', m' and v' equal the plain version run on the card bit for bit.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_LEAVES = 32;
constexpr int MAX_DEVICES = 64;

struct Leaf {
  const float* p;
  const float* g;
  const float* m;
  const float* v;
  float* p_out;
  float* m_out;
  float* v_out;
  const unsigned char* active;   // null: every row active
  long long end;                 // one past the leaf's last item
  int numel;
  int row;                       // floats a row of `active`
  int vec;                       // 1: items of 4 floats; 0: of 1 float
  float lr, b1, omb1, b2, omb2, eps, inv_c1, inv_c2;
};

struct Table {
  Leaf leaf[MAX_LEAVES];
  int n;
};

static_assert(sizeof(Table) <= 4096, "the table must fit a kernel parameter");

__device__ __forceinline__ void adam1(const Leaf& f, float p, float g,
                                      float m, float v, float& po, float& mo,
                                      float& vo) {
  mo = f.b1 * m + f.omb1 * g;
  vo = f.b2 * v + f.omb2 * (g * g);
  const float num = f.lr * (mo * f.inv_c1);
  const float den = sqrtf(vo * f.inv_c2) + f.eps;
  po = p - num / den;
}

__device__ __forceinline__ bool row_active(const Leaf& f, int e) {
  return f.active == nullptr || __ldg(f.active + e / f.row) != 0;
}

__device__ __forceinline__ void scalar_item(const Leaf& f, int e) {
  const float g = row_active(f, e) ? __ldcs(f.g + e) : 0.0f;
  float po, mo, vo;
  adam1(f, __ldcs(f.p + e), g, __ldcs(f.m + e), __ldcs(f.v + e), po, mo, vo);
  __stcs(f.p_out + e, po);
  __stcs(f.m_out + e, mo);
  __stcs(f.v_out + e, vo);
}

__device__ __forceinline__ void vector_item(const Leaf& f, int j) {
  const int e = 4 * j;
  if (e + 4 > f.numel) {                 // the leaf's tail
    for (int k = e; k < f.numel; ++k) scalar_item(f, k);
    return;
  }
  const float4 p = __ldcs(reinterpret_cast<const float4*>(f.p) + j);
  float4 g = __ldcs(reinterpret_cast<const float4*>(f.g) + j);
  const float4 m = __ldcs(reinterpret_cast<const float4*>(f.m) + j);
  const float4 v = __ldcs(reinterpret_cast<const float4*>(f.v) + j);
  if (f.active != nullptr) {
    // The row of element e, then step through the next three.
    bool live[4];
    int r = e / f.row;
    int rem = e - r * f.row;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      live[k] = __ldg(f.active + r) != 0;
      if (++rem == f.row) {
        rem = 0;
        ++r;
      }
    }
    g.x = live[0] ? g.x : 0.0f;
    g.y = live[1] ? g.y : 0.0f;
    g.z = live[2] ? g.z : 0.0f;
    g.w = live[3] ? g.w : 0.0f;
  }
  float4 po, mo, vo;
  adam1(f, p.x, g.x, m.x, v.x, po.x, mo.x, vo.x);
  adam1(f, p.y, g.y, m.y, v.y, po.y, mo.y, vo.y);
  adam1(f, p.z, g.z, m.z, v.z, po.z, mo.z, vo.z);
  adam1(f, p.w, g.w, m.w, v.w, po.w, mo.w, vo.w);
  __stcs(reinterpret_cast<float4*>(f.p_out) + j, po);
  __stcs(reinterpret_cast<float4*>(f.m_out) + j, mo);
  __stcs(reinterpret_cast<float4*>(f.v_out) + j, vo);
}

// The table is read in place from the parameter space (__grid_constant__:
// no per-thread copy), its index uniform across a warp but at leaf ends.
__global__ void __launch_bounds__(THREADS)
    adam_kernel(const __grid_constant__ Table t) {
  const long long items = t.leaf[t.n - 1].end;
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  int l = 0;
  long long begin = 0;
  for (long long i = static_cast<long long>(blockIdx.x) * THREADS +
                     threadIdx.x;
       i < items; i += stride) {
    while (i >= t.leaf[l].end) begin = t.leaf[l++].end;
    const Leaf& f = t.leaf[l];
    const int j = static_cast<int>(i - begin);
    if (f.vec)
      vector_item(f, j);
    else
      scalar_item(f, j);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Blocks of THREADS the card holds at once, per device (0: not asked yet).
int resident_blocks(int dev, int* out) {
  static int cached[MAX_DEVICES] = {0};
  if (dev >= 0 && dev < MAX_DEVICES && cached[dev] > 0) {
    *out = cached[dev];
    return 0;
  }
  int sms = 0, per_sm = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, adam_kernel,
                                                      THREADS, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  *out = sms * (per_sm > 0 ? per_sm : 1);
  if (dev >= 0 && dev < MAX_DEVICES) cached[dev] = *out;
  return 0;
}

}  // namespace

// n leaves, 1 <= n <= 32. Leaf i: ptrs[8 i + 0 .. 7] = p, g, m, v, p', m',
// v' (float32, contiguous, numel[i] each, 0 <= numel[i] < 2^31) and its
// row mask (bool bytes, one a row of row[i] floats; null: every row
// active); hyper[8 i + 0 .. 7] = lr, b1, 1 - b1, b2, 1 - b2, eps, 1 / c1,
// 1 / c2 as float32. One launch on `stream`, none when every leaf is empty.
SG_EXPORT int sg_adam(int n, void* const* ptrs, const long long* numel,
                      const int* row, const float* hyper, void* stream) {
  if (n < 1 || n > MAX_LEAVES) return static_cast<int>(cudaErrorInvalidValue);
  Table t;
  t.n = n;
  long long end = 0;
  for (int i = 0; i < n; ++i) {
    Leaf& f = t.leaf[i];
    void* const* q = ptrs + 8 * i;
    const float* h = hyper + 8 * i;
    if (numel[i] < 0 || numel[i] > 2147483647LL ||
        (q[7] != nullptr && row[i] < 1))
      return static_cast<int>(cudaErrorInvalidValue);
    f.p = static_cast<const float*>(q[0]);
    f.g = static_cast<const float*>(q[1]);
    f.m = static_cast<const float*>(q[2]);
    f.v = static_cast<const float*>(q[3]);
    f.p_out = static_cast<float*>(q[4]);
    f.m_out = static_cast<float*>(q[5]);
    f.v_out = static_cast<float*>(q[6]);
    f.active = static_cast<const unsigned char*>(q[7]);
    f.numel = static_cast<int>(numel[i]);
    f.row = row[i];
    f.vec = 1;
    for (int k = 0; k < 7; ++k) f.vec &= aligned16(q[k]) ? 1 : 0;
    end += f.vec ? (numel[i] + 3) / 4 : numel[i];
    f.end = end;
    f.lr = h[0];
    f.b1 = h[1];
    f.omb1 = h[2];
    f.b2 = h[3];
    f.omb2 = h[4];
    f.eps = h[5];
    f.inv_c1 = h[6];
    f.inv_c2 = h[7];
  }
  if (end == 0) return 0;
  int dev = 0, resident = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rc = resident_blocks(dev, &resident);
  if (rc != 0) return rc;
  const long long need = (end + THREADS - 1) / THREADS;
  const long long blocks = need < resident ? need : resident;
  adam_kernel<<<static_cast<unsigned>(blocks), THREADS, 0,
                static_cast<cudaStream_t>(stream)>>>(t);
  return sg_last_error();
}
