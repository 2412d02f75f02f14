// Kernel L: the EWA projection of every slot (core/projection.project),
// forward and backward.
//
// Forward, for slot g with centre m, linear scales s, quaternion q (wxyz),
// the world-to-camera matrix [R | t] and intrinsics fx, fy, cx, cy:
//   (px, py, tz) = R m + t;  tz' = tz > clip ? tz : 1
//   q' = |q|^2 < 1e-24 ? q : q / |q|;  S = R(q') diag(s^2) R(q')^T
//   J = [[fx / tz', 0, -fx tx / tz'^2], [0, fy / tz', -fy ty / tz'^2]],
//       tx = clamp(px / tz', +-1.3 tan_fovx) tz' (ty alike)
//   T = J R;  (a, b, c) = T S T^T;  a' = a + 0.3, c' = c + 0.3
//   conic = (c', -b, a') / det',  det' = a' c' - b^2 (1 where det' <= 0)
//   comp = sqrt(max((a c - b^2) / det', 0)),  radius = ceil(3 sqrt(l_max))
//   xy = ((fx px) / tz' + cx, (fy py) / tz' + cy),  depth = tz
// and the tile box of the q-contour (q = min(9, 2 ln(255 o)) with the
// opacities, 9 without), the tile count, zero radius and count outside
// `active`, and the centre offset added. Backward: the closed form of
// autograd's gradient through the plain version (ops/project.py
// _project_vjp_plain, which states the subgradients), from the gradients
// of the centres, depths, conics and compensation, to the means, scales,
// quaternions and, where the caller asks, the view matrix: one thread a
// slot recomputes the forward's values from the inputs (nothing is kept
// between the two launches), and the view matrix's 12 entries are added
// over each block in a fixed tree (float64), then over the blocks by one
// block of a second launch in a fixed order: no atomics, the same bits
// every run.
//
// Replaces no Pallas kernel: the JAX package's projection,
// street_gaussians_ns_tpu/core/projection.py project, is jnp code that XLA
// fuses. The port's plain version is ~385 eager operations forward and
// ~230 autograd nodes backward, each a pass over every slot.
//
// Bound on the H100: memory. The forward reads 44 bytes a slot (centre,
// scales, quaternion, opacity; 53 with the mask and the offset) and
// writes 52 (centre 8, depth 4, radius 4, conic 12, comp 4, count 4, box
// 16); the backward reads 40 and the gradients given (24-28) and writes
// 40. One thread owns one slot; a warp's rows lie together, so its loads
// and stores fill whole sectors.
//
// Rounding is PyTorch's on the card, op for op (no multiply-add
// contraction, ops/_cuda.py NVCC_FLAGS; IEEE sqrtf, division and logf):
//   * constants are the Python doubles rounded to float32, as PyTorch
//     rounds a Python scalar multiplied into a float32 tensor;
//   * 0.5 W / fx is fx.reciprocal() * (0.5 W) (Tensor.__rtruediv__), and
//     1 / tz' a reciprocal; v / tile_size is v * (1 / tile_size) (PyTorch's
//     CUDA division by a host scalar);
//   * |q|^2 is torch.sum over a dim of 4 on the card, which gives each of
//     two lanes every other element: (q0^2 + q2^2) + (q1^2 + q3^2);
//   * minimum, maximum and clamp return a NaN operand; float to int32 is
//     the saturating cvt.rzi (NaN to 0), as PyTorch's conversion on the
//     card.
// So every output equals the plain version's on the card bit for bit.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr float BLUR = static_cast<float>(0.3);
constexpr float LIM = static_cast<float>(1.3);

// torch.maximum / torch.minimum: a NaN operand is the result.
__device__ __forceinline__ float t_max(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}
__device__ __forceinline__ float t_min(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}
// torch.clamp with a bound that is not NaN: NaN stays NaN.
__device__ __forceinline__ float clamp_lo(float v, float lo) {
  return v != v ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float clamp_hi(float v, float hi) {
  return v != v ? v : fminf(v, hi);
}

struct Camera {
  float r[9], t[3], fx, fy, cx, cy, lim_x, lim_y;
};

__device__ __forceinline__ Camera load_camera(const float* __restrict__ vm,
                                              const float* fx,
                                              const float* fy,
                                              const float* cx,
                                              const float* cy, float half_w,
                                              float half_h) {
  Camera k;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) k.r[3 * i + j] = __ldg(vm + 4 * i + j);
    k.t[i] = __ldg(vm + 4 * i + 3);
  }
  k.fx = __ldg(fx);
  k.fy = __ldg(fy);
  k.cx = __ldg(cx);
  k.cy = __ldg(cy);
  k.lim_x = ((1.0f / k.fx) * half_w) * LIM;
  k.lim_y = ((1.0f / k.fy) * half_h) * LIM;
  return k;
}

// The forward's values that the backward needs, formed as the plain
// version forms them.
struct Geometry {
  float px, py, tz, tzs;
  bool valid;
  float ux, uy, mxx, mxy, clx, cly, tx, ty, rz, rz2;
  float j00, j02, j11, j12;
  float T[2][3];
  float q[4], qn[4], den;
  bool tiny;
  float r[3][3], sc[3], s[3];
  float cov[3][3];
  float u[3], v[3];
  float a, b, c, ab, cb, det_orig, det, dw;
  bool det_ok;
};

__device__ __forceinline__ void geometry(const Camera& k, const float* m,
                                         const float* sc, const float* q,
                                         float clip, Geometry& G) {
  const float* R = k.r;
  G.px = ((R[0] * m[0] + R[1] * m[1]) + R[2] * m[2]) + k.t[0];
  G.py = ((R[3] * m[0] + R[4] * m[1]) + R[5] * m[2]) + k.t[1];
  G.tz = ((R[6] * m[0] + R[7] * m[1]) + R[8] * m[2]) + k.t[2];
  G.valid = G.tz > clip;
  G.tzs = G.valid ? G.tz : 1.0f;

  const float n2 = (q[0] * q[0] + q[2] * q[2]) + (q[1] * q[1] + q[3] * q[3]);
  G.tiny = n2 < 1e-24f;
  G.den = sqrtf(G.tiny ? 1.0f : n2);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    G.q[i] = q[i];
    G.qn[i] = G.tiny ? q[i] : q[i] / G.den;
  }
  const float w = G.qn[0], x = G.qn[1], y = G.qn[2], z = G.qn[3];
  G.r[0][0] = 1.0f - (y * y + z * z) * 2.0f;
  G.r[0][1] = (x * y - w * z) * 2.0f;
  G.r[0][2] = (x * z + w * y) * 2.0f;
  G.r[1][0] = (x * y + w * z) * 2.0f;
  G.r[1][1] = 1.0f - (x * x + z * z) * 2.0f;
  G.r[1][2] = (y * z - w * x) * 2.0f;
  G.r[2][0] = (x * z - w * y) * 2.0f;
  G.r[2][1] = (y * z + w * x) * 2.0f;
  G.r[2][2] = 1.0f - (x * x + y * y) * 2.0f;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    G.sc[i] = sc[i];
    G.s[i] = sc[i] * sc[i];
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = i; j < 3; ++j) {
      const float v = ((G.r[i][0] * G.r[j][0]) * G.s[0] +
                       (G.r[i][1] * G.r[j][1]) * G.s[1]) +
                      (G.r[i][2] * G.r[j][2]) * G.s[2];
      G.cov[i][j] = v;
      G.cov[j][i] = v;
    }
  }

  G.ux = G.px / G.tzs;
  G.uy = G.py / G.tzs;
  G.mxx = t_max(G.ux, -k.lim_x);
  G.mxy = t_max(G.uy, -k.lim_y);
  G.clx = t_min(G.mxx, k.lim_x);
  G.cly = t_min(G.mxy, k.lim_y);
  G.tx = G.clx * G.tzs;
  G.ty = G.cly * G.tzs;
  G.rz = 1.0f / G.tzs;
  G.rz2 = G.rz * G.rz;
  G.j00 = k.fx * G.rz;
  G.j02 = (-k.fx * G.tx) * G.rz2;
  G.j11 = k.fy * G.rz;
  G.j12 = (-k.fy * G.ty) * G.rz2;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    G.T[0][j] = G.j00 * R[j] + G.j02 * R[6 + j];
    G.T[1][j] = G.j11 * R[3 + j] + G.j12 * R[6 + j];
  }
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    G.u[j] = (G.T[0][0] * G.cov[0][j] + G.T[0][1] * G.cov[1][j]) +
             G.T[0][2] * G.cov[2][j];
    G.v[j] = (G.T[1][0] * G.cov[0][j] + G.T[1][1] * G.cov[1][j]) +
             G.T[1][2] * G.cov[2][j];
  }
  G.a = (G.u[0] * G.T[0][0] + G.u[1] * G.T[0][1]) + G.u[2] * G.T[0][2];
  G.b = (G.u[0] * G.T[1][0] + G.u[1] * G.T[1][1]) + G.u[2] * G.T[1][2];
  G.c = (G.v[0] * G.T[1][0] + G.v[1] * G.T[1][1]) + G.v[2] * G.T[1][2];
  G.det_orig = G.a * G.c - G.b * G.b;
  G.ab = G.a + BLUR;
  G.cb = G.c + BLUR;
  G.det = G.ab * G.cb - G.b * G.b;
  G.det_ok = G.det > 0.0f;
  G.dw = G.det_ok ? G.det : 1.0f;
}

__device__ __forceinline__ void load_slot(const float* __restrict__ means,
                                          long long ms,
                                          const float* __restrict__ scales,
                                          long long ss,
                                          const float* __restrict__ quats,
                                          long long qs, long long g,
                                          float* m, float* sc, float* q) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    m[i] = __ldg(means + g * ms + i);
    sc[i] = __ldg(scales + g * ss + i);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) q[i] = __ldg(quats + g * qs + i);
}

// core/projection.py tile_bound: floor(clamp(floor(v / ts) + plus, 0, hi)).
__device__ __forceinline__ int tile_bound(float v, float inv_ts, float plus,
                                          float hi) {
  float f = floorf(v * inv_ts) + plus;
  f = f != f ? f : fminf(fmaxf(f, 0.0f), hi);
  return __float2int_rz(floorf(f));
}

template <bool OPAC>
__global__ void __launch_bounds__(THREADS)
    project_fwd_kernel(const float* __restrict__ means, long long ms,
                       const float* __restrict__ scales, long long ss,
                       const float* __restrict__ quats, long long qs,
                       const float* __restrict__ opac,
                       const unsigned char* __restrict__ active,
                       const float* __restrict__ offset, long long os,
                       const float* __restrict__ vm, const float* fx,
                       const float* fy, const float* cx, const float* cy,
                       int width, int height, int tile_size, float clip,
                       float* __restrict__ xys, float* __restrict__ depths,
                       int* __restrict__ radii, float* __restrict__ conics,
                       float* __restrict__ comp, int* __restrict__ tiles,
                       int* __restrict__ box, long long n) {
  const long long g = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (g >= n) return;
  const Camera k = load_camera(vm, fx, fy, cx, cy, 0.5f * width,
                               0.5f * height);
  float m[3], sc[3], q[4];
  load_slot(means, ms, scales, ss, quats, qs, g, m, sc, q);
  Geometry G;
  geometry(k, m, sc, q, clip, G);

  const float cmp = sqrtf(clamp_lo(G.det_orig / G.dw, 0.0f));
  const float mid = (G.ab + G.cb) * 0.5f;
  const float l1 = mid + sqrtf(clamp_lo(mid * mid - G.det, 0.1f));
  const float radius_f = ceilf(sqrtf(l1) * 3.0f);
  float qv = 9.0f;
  if constexpr (OPAC) {
    qv = clamp_hi(logf(clamp_lo(__ldg(opac + g), 1e-12f) * 255.0f) * 2.0f,
                  9.0f);
  }
  const float rx = ceilf(sqrtf(clamp_lo(qv * G.ab, 1e-8f)));
  const float ry = ceilf(sqrtf(clamp_lo(qv * G.cb, 1e-8f)));
  const float ctr_x = (k.fx * G.px) * G.rz + k.cx;
  const float ctr_y = (k.fy * G.py) * G.rz + k.cy;

  const float inv_ts = 1.0f / static_cast<float>(tile_size);
  const float ntx = static_cast<float>((width + tile_size - 1) / tile_size);
  const float nty = static_cast<float>((height + tile_size - 1) / tile_size);
  const int x0 = tile_bound(ctr_x - rx, inv_ts, 0.0f, ntx);
  const int y0 = tile_bound(ctr_y - ry, inv_ts, 0.0f, nty);
  int x1 = tile_bound(ctr_x + rx, inv_ts, 1.0f, ntx);
  int y1 = tile_bound(ctr_y + ry, inv_ts, 1.0f, nty);
  bool visible = G.valid && G.det_ok;
  if constexpr (OPAC) visible = visible && qv > 0.0f;
  x1 = visible ? max(x1, x0) : x0;
  y1 = visible ? max(y1, y0) : y0;
  int rad = visible ? __float2int_rz(radius_f) : 0;
  int cnt = visible ? (x1 - x0) * (y1 - y0) : 0;
  if (active != nullptr && !active[g]) rad = cnt = 0;

  float ox = 0.0f, oy = 0.0f;
  if (offset != nullptr) {
    ox = __ldg(offset + g * os);
    oy = __ldg(offset + g * os + 1);
  }
  reinterpret_cast<float2*>(xys)[g] =
      offset != nullptr ? make_float2(ctr_x + ox, ctr_y + oy)
                        : make_float2(ctr_x, ctr_y);
  depths[g] = G.tz;
  radii[g] = rad;
  conics[3 * g] = G.cb / G.dw;
  conics[3 * g + 1] = -G.b / G.dw;
  conics[3 * g + 2] = G.ab / G.dw;
  comp[g] = cmp;
  tiles[g] = cnt;
  reinterpret_cast<int4*>(box)[g] = make_int4(x0, x1, y0, y1);
}

// The closed-form gradient of one slot (ops/project.py _project_vjp_plain,
// line for line). gR: the 12 view-matrix entries' gradients (R row-major,
// then t).
__device__ __forceinline__ void slot_grad(const Camera& k, const float* m,
                                          const Geometry& G, float gx,
                                          float gy, float gd, float g0,
                                          float g1, float g2, bool has_comp,
                                          float gk, float* d_m, float* d_s,
                                          float* d_q, float* gR) {
  const float* R = k.r;
  float g_px = (gx * G.rz) * k.fx;
  float g_py = (gy * G.rz) * k.fy;
  float g_rz = gx * (k.fx * G.px) + gy * (k.fy * G.py);
  const float g_ab0 = g2 / G.dw, g_cb0 = g0 / G.dw;
  float g_b = -g1 / G.dw;
  float g_dw = -((g0 * G.cb - g1 * G.b) + g2 * G.ab) / (G.dw * G.dw);
  float g_do = 0.0f;
  if (has_comp) {
    const float ratio = G.det_orig / G.dw;
    const float cmp = sqrtf(clamp_lo(ratio, 0.0f));
    const float g_ratio = ratio >= 0.0f ? gk / (2.0f * cmp) : 0.0f;
    g_do = g_ratio / G.dw;
    g_dw = g_dw - g_ratio * ratio / G.dw;
  }
  const float g_det = G.det_ok ? g_dw : 0.0f;
  const float g_a = (g_ab0 + g_det * G.cb) + g_do * G.c;
  const float g_c = (g_cb0 + g_det * G.ab) + g_do * G.a;
  g_b = g_b - 2.0f * G.b * (g_det + g_do);

  float g_T[2][3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    g_T[0][j] = 2.0f * g_a * G.u[j] + g_b * G.v[j];
    g_T[1][j] = g_b * G.u[j] + 2.0f * g_c * G.v[j];
  }
  float g_cov[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = i; j < 3; ++j) {
      const float* T0 = G.T[0];
      const float* T1 = G.T[1];
      g_cov[i][j] = i == j ? (g_a * T0[i] * T0[i] + g_b * T0[i] * T1[i] +
                              g_c * T1[i] * T1[i])
                           : (2.0f * g_a * T0[i] * T0[j] +
                              g_b * (T0[i] * T1[j] + T0[j] * T1[i]) +
                              2.0f * g_c * T1[i] * T1[j]);
    }
  }
  float g_j00 = 0.0f, g_j02 = 0.0f, g_j11 = 0.0f, g_j12 = 0.0f;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    g_j00 += g_T[0][j] * R[j];
    g_j02 += g_T[0][j] * R[6 + j];
    g_j11 += g_T[1][j] * R[3 + j];
    g_j12 += g_T[1][j] * R[6 + j];
    gR[j] = g_T[0][j] * G.j00;
    gR[3 + j] = g_T[1][j] * G.j11;
    gR[6 + j] = g_T[0][j] * G.j02 + g_T[1][j] * G.j12;
  }
  g_rz = g_rz + g_j00 * k.fx + g_j11 * k.fy;
  const float g_rz2 = g_j02 * (-k.fx * G.tx) + g_j12 * (-k.fy * G.ty);
  const float g_tx = g_j02 * G.rz2 * -k.fx;
  const float g_ty = g_j12 * G.rz2 * -k.fy;
  g_rz = g_rz + 2.0f * G.rz * g_rz2;
  float g_tzs = -g_rz * G.rz * G.rz + g_tx * G.clx + g_ty * G.cly;

  // minimum(mx, lim), then maximum(u, -lim), as autograd splits them.
  float gcx = g_tx * G.tzs, gcy = g_ty * G.tzs;
  gcx = G.mxx == k.lim_x ? gcx / 2.0f : (G.mxx > k.lim_x ? 0.0f : gcx);
  gcy = G.mxy == k.lim_y ? gcy / 2.0f : (G.mxy > k.lim_y ? 0.0f : gcy);
  const float g_ux =
      G.ux == -k.lim_x ? gcx / 2.0f : (G.ux < -k.lim_x ? 0.0f : gcx);
  const float g_uy =
      G.uy == -k.lim_y ? gcy / 2.0f : (G.uy < -k.lim_y ? 0.0f : gcy);
  g_px = g_px + g_ux / G.tzs;
  g_py = g_py + g_uy / G.tzs;
  g_tzs = g_tzs - (g_ux * G.ux + g_uy * G.uy) / G.tzs;
  const float g_tz = (G.valid ? g_tzs : 0.0f) + gd;
  const float g_cam[3] = {g_px, g_py, g_tz};
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    d_m[j] = (g_px * R[j] + g_py * R[3 + j]) + g_tz * R[6 + j];
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) gR[3 * i + j] += g_cam[i] * m[j];
    gR[9 + i] = g_cam[i];
  }

  // The covariance: c_ij = sum_k r_ik r_jk s_k.
  float g_r[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int kk = 0; kk < 3; ++kk) {
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const float h = i == j ? 2.0f * g_cov[i][i]
                               : g_cov[i < j ? i : j][i < j ? j : i];
        acc += h * G.r[j][kk];
      }
      g_r[i][kk] = acc * G.s[kk];
    }
  }
#pragma unroll
  for (int kk = 0; kk < 3; ++kk) {
    float acc = 0.0f;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = i; j < 3; ++j) acc += g_cov[i][j] * G.r[i][kk] * G.r[j][kk];
    }
    d_s[kk] = 2.0f * acc * G.sc[kk];
  }
  const float w = G.qn[0], x = G.qn[1], y = G.qn[2], z = G.qn[3];
  const float(*H)[3] = g_r;
  float g_qn[4];
  g_qn[0] = 2.0f * (-z * H[0][1] + y * H[0][2] + z * H[1][0] - x * H[1][2] -
                    y * H[2][0] + x * H[2][1]);
  g_qn[1] = 2.0f * (y * H[0][1] + z * H[0][2] + y * H[1][0] -
                    2.0f * x * H[1][1] - w * H[1][2] + z * H[2][0] +
                    w * H[2][1] - 2.0f * x * H[2][2]);
  g_qn[2] = 2.0f * (-2.0f * y * H[0][0] + x * H[0][1] + w * H[0][2] +
                    x * H[1][0] + z * H[1][2] - w * H[2][0] + z * H[2][1] -
                    2.0f * y * H[2][2]);
  g_qn[3] = 2.0f * (-2.0f * z * H[0][0] - w * H[0][1] + x * H[0][2] +
                    w * H[1][0] - 2.0f * z * H[1][1] + y * H[1][2] +
                    x * H[2][0] + y * H[2][1]);
  float dot = 0.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i) dot += g_qn[i] * G.q[i];
  const float den3 = G.den * G.den * G.den;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    d_q[i] = G.tiny ? g_qn[i] : g_qn[i] / G.den - G.q[i] * dot / den3;
  }
}

template <bool VIEW>
__global__ void __launch_bounds__(THREADS)
    project_bwd_kernel(const float* __restrict__ means, long long ms,
                       const float* __restrict__ scales, long long ss,
                       const float* __restrict__ quats, long long qs,
                       const float* __restrict__ vm, const float* fx,
                       const float* fy, const float* cx, const float* cy,
                       int width, int height, float clip,
                       const float* __restrict__ g_xys, long long gx0,
                       long long gx1, const float* __restrict__ g_depth,
                       long long gds, const float* __restrict__ g_conic,
                       long long gc0, long long gc1,
                       const float* __restrict__ g_comp, long long gks,
                       float* __restrict__ d_means,
                       float* __restrict__ d_scales,
                       float* __restrict__ d_quats,
                       double* __restrict__ partials, long long n) {
  const long long g = (long long)blockIdx.x * THREADS + threadIdx.x;
  float gR[12];
#pragma unroll
  for (int e = 0; e < 12; ++e) gR[e] = 0.0f;
  if (g < n) {
    const Camera k = load_camera(vm, fx, fy, cx, cy, 0.5f * width,
                                 0.5f * height);
    float m[3], sc[3], q[4];
    load_slot(means, ms, scales, ss, quats, qs, g, m, sc, q);
    Geometry G;
    geometry(k, m, sc, q, clip, G);
    const float gx = g_xys != nullptr ? __ldg(g_xys + g * gx0) : 0.0f;
    const float gy = g_xys != nullptr ? __ldg(g_xys + g * gx0 + gx1) : 0.0f;
    const float gd = g_depth != nullptr ? __ldg(g_depth + g * gds) : 0.0f;
    float c3[3] = {0.0f, 0.0f, 0.0f};
    if (g_conic != nullptr) {
#pragma unroll
      for (int i = 0; i < 3; ++i) c3[i] = __ldg(g_conic + g * gc0 + i * gc1);
    }
    const bool has_comp = g_comp != nullptr;
    const float gk = has_comp ? __ldg(g_comp + g * gks) : 0.0f;
    float d_m[3], d_s[3], d_q[4];
    slot_grad(k, m, G, gx, gy, gd, c3[0], c3[1], c3[2], has_comp, gk, d_m,
              d_s, d_q, gR);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      d_means[3 * g + i] = d_m[i];
      d_scales[3 * g + i] = d_s[i];
    }
    reinterpret_cast<float4*>(d_quats)[g] =
        make_float4(d_q[0], d_q[1], d_q[2], d_q[3]);
  }
  if constexpr (VIEW) {
    // The block's 12 sums: a shuffle tree in each warp, then the warps in
    // order, in float64.
    __shared__ double warp_sums[THREADS / 32][12];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int e = 0; e < 12; ++e) {
      double v = static_cast<double>(gR[e]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        v += __shfl_down_sync(0xffffffffu, v, off);
      }
      if (lane == 0) warp_sums[warp][e] = v;
    }
    __syncthreads();
    if (threadIdx.x < 12) {
      double v = 0.0;
      for (int w = 0; w < THREADS / 32; ++w) v += warp_sums[w][threadIdx.x];
      partials[blockIdx.x * 12LL + threadIdx.x] = v;
    }
  }
}

// The view matrix's gradient (4, 4) from the blocks' partials: warp e adds
// entry e over the blocks (lane l takes blocks l, l + 32, ... in order),
// then a shuffle tree; the last row is zero.
__global__ void __launch_bounds__(12 * 32)
    view_grad_kernel(const double* __restrict__ partials, long long blocks,
                     float* __restrict__ out) {
  const int lane = threadIdx.x & 31, e = threadIdx.x >> 5;
  double v = 0.0;
  for (long long b = lane; b < blocks; b += 32) v += partials[b * 12 + e];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  if (lane == 0) {
    const int at = e < 9 ? 4 * (e / 3) + e % 3 : 4 * (e - 9) + 3;
    out[at] = static_cast<float>(v);
  }
  if (threadIdx.x < 4) out[12 + threadIdx.x] = 0.0f;
}

}  // namespace

// means, scales (n, 3) and quats (n, 4) float32 with a unit column stride
// and row strides ms, ss, qs (elements); opac (n,) float32, active (n,)
// bool and offset (n, 2) float32 (row stride os) each or null; viewmat
// (4, 4) float32 row-major; fx, fy, cx, cy one float32 each, in device
// memory; outputs contiguous: xys (n, 2), depths (n,), radii (n,) int32,
// conics (n, 3), comp (n,), tiles (n,) int32, box (n, 4) int32.
SG_EXPORT int sg_project_fwd(const float* means, long long ms,
                             const float* scales, long long ss,
                             const float* quats, long long qs,
                             const float* opac, const unsigned char* active,
                             const float* offset, long long os,
                             const float* viewmat, const float* fx,
                             const float* fy, const float* cx,
                             const float* cy, int width, int height,
                             int tile_size, float clip, float* xys,
                             float* depths, int* radii, float* conics,
                             float* comp, int* tiles, int* box, long long n,
                             void* stream) {
  if (n <= 0) return 0;
  if (tile_size <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned blocks = static_cast<unsigned>((n + THREADS - 1) / THREADS);
  if (opac != nullptr) {
    project_fwd_kernel<true><<<blocks, THREADS, 0, s>>>(
        means, ms, scales, ss, quats, qs, opac, active, offset, os, viewmat,
        fx, fy, cx, cy, width, height, tile_size, clip, xys, depths, radii,
        conics, comp, tiles, box, n);
  } else {
    project_fwd_kernel<false><<<blocks, THREADS, 0, s>>>(
        means, ms, scales, ss, quats, qs, opac, active, offset, os, viewmat,
        fx, fy, cx, cy, width, height, tile_size, clip, xys, depths, radii,
        conics, comp, tiles, box, n);
  }
  return sg_last_error();
}

// The forward's geometry arguments; the gradients of the centres (n, 2),
// depths (n,), conics (n, 3) and compensation (n,), float32 with strides
// in elements, each or null (not given); d_means, d_scales (n, 3) and
// d_quats (n, 4) contiguous; d_view (4, 4) or null, and with it partials,
// 12 doubles a block of 256 slots (partials_len of them).
SG_EXPORT int sg_project_bwd(const float* means, long long ms,
                             const float* scales, long long ss,
                             const float* quats, long long qs,
                             const float* viewmat, const float* fx,
                             const float* fy, const float* cx,
                             const float* cy, int width, int height,
                             float clip, const float* g_xys, long long gx0,
                             long long gx1, const float* g_depth,
                             long long gds, const float* g_conic,
                             long long gc0, long long gc1,
                             const float* g_comp, long long gks,
                             float* d_means, float* d_scales, float* d_quats,
                             double* partials, long long partials_len,
                             float* d_view, long long n, void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long blocks = (n + THREADS - 1) / THREADS;
  if (d_view != nullptr) {
    if (partials == nullptr || partials_len < blocks * 12) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    if (blocks > 0) {
      project_bwd_kernel<true><<<(unsigned)blocks, THREADS, 0, s>>>(
          means, ms, scales, ss, quats, qs, viewmat, fx, fy, cx, cy, width,
          height, clip, g_xys, gx0, gx1, g_depth, gds, g_conic, gc0, gc1,
          g_comp, gks, d_means, d_scales, d_quats, partials, n);
    }
    view_grad_kernel<<<1, 12 * 32, 0, s>>>(partials, blocks, d_view);
  } else if (blocks > 0) {
    project_bwd_kernel<false><<<(unsigned)blocks, THREADS, 0, s>>>(
        means, ms, scales, ss, quats, qs, viewmat, fx, fy, cx, cy, width,
        height, clip, g_xys, gx0, gx1, g_depth, gds, g_conic, gc0, gc1,
        g_comp, gks, d_means, d_scales, d_quats, nullptr, n);
  }
  return sg_last_error();
}
