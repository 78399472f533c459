// The geometry layer of a render: the covariance from scale and quaternion,
// the EWA projection to screen space and the SH colour, each forward and
// backward, one thread per splat.
//
// Replaces no Pallas kernel: the JAX package leaves this per-splat math
// (ops/projection.py:build_cov3d and project, ops/sh.py:sh_to_rgb) to XLA,
// which fuses it into a few loops. The port ran it as a chain of eager
// PyTorch ops, and a trace of a stage-0 training step (985x730, 1M splats)
// put 12.2 of its 23.3 ms of device time there: some 600 launches of
// elementwise, cat and small-GEMM kernels a step, each writing its [N, ...]
// result to device memory for the next to read back.
//
// Bound on an H100: bytes. The work is per splat and nothing is reused.
// About 1-2 kFLOP a splat forward and backward is ~0.03 ms at 67 TFLOP/s for
// 1M splats, while the inputs read once and the outputs written once (per
// splat the SH rows, 192 B at degree 3, and d_sh as much again; means,
// scales, quaternions, cov3d and its cotangent, the projected fields and
// their cotangents) are ~1 GB a stage-0 step, ~0.3 ms at 3.35 TB/s. What
// the design does about that bound:
//   * one thread computes a splat's whole chain in registers, so nothing
//     between a kernel's inputs and its outputs goes to device memory;
//   * each backward recomputes its forward's intermediates from the
//     forward's inputs: no [N, ...] intermediate is saved or read back;
//   * the SH rows, most of the bytes, move through shared memory: a block's
//     rows are one range of device memory, loaded and stored by coalesced
//     accesses, and each thread reads its own row from shared memory at a
//     stride that is odd in words, so without bank conflicts. Only the
//     (deg+1)^2 coefficients in use are loaded. The rows of Sigma and of its
//     gradient (36 bytes a splat) leave through shared memory the same way:
//     nine stores 36 bytes apart per thread ran the covariance kernel at
//     27% of its bound, the coalesced pass at 82%;
//   * the cotangents are read in place, at their row stride (the blend's
//     backward hands them as columns of one [N, F] buffer), without a copy;
//   * the camera is read from device memory, so a launch needs no host sync
//     and a captured step may select its view on the device; only the
//     image's width and height come from the host.
// Rounding: fp32, built with -fmad=false. Each forward evaluates the plain
// version's expressions (the functions of ops/projection.py and ops/sh.py)
// in their order, and where the plain version calls a library product or
// reduction (the camera transform's matrix product, the norms, the SH
// einsum) it sums in the order that call takes on the card, fused
// multiply-adds included; so on the card it rounds as the plain version
// does. (The CPU's library sums some of these in other orders.)

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr float kNearZ = 0.2f;
constexpr float kDilation = 0.3f;
constexpr float kTile = 16.0f;
constexpr int kTileI = 16;
constexpr float kIntSat = 1073741824.0f;  // 2^30: _to_i32's saturation
constexpr float kNoCull = 3.4e38f;        // cull radius without opacities
constexpr float kEps = 1e-12f;            // the norms' +1e-12

// torch.clamp and torch.clamp(min=): a NaN passes through
__device__ __forceinline__ float clamp_f(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x < lo ? lo : x;
}
__device__ __forceinline__ int clamp_i(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}
// projection._to_i32: saturate at +-2^30, then truncate (NaN gives 0, as
// the card's float-to-int conversion does)
__device__ __forceinline__ int to_i32(float x) {
  return __float2int_rz(clamp_f(x, -kIntSat, kIntSat));
}
// torch.minimum: NaN where either is
__device__ __forceinline__ float minimum(float a, float b) {
  return a != a ? a : (b != b ? b : (b < a ? b : a));
}

// ---------------------------------------------------------------------------
// Covariance: Sigma = (R S)(R S)^T, R from the quaternion (w, x, y, z)
// normalised by |q| + 1e-12 (projection.quat_to_rotmat, build_cov3d)

struct Quat {
  float q[4];   // as given
  float qn[4];  // normalised
  float norm;   // |q|
  float den;    // |q| + 1e-12
  float R[9];   // row major
};

__device__ __forceinline__ void quat_rot(const float* __restrict__ quats, int i,
                                         Quat& Q) {
  for (int c = 0; c < 4; ++c) Q.q[c] = quats[4 * i + c];
  // torch.linalg.norm's order on the card for a row of 4
  Q.norm = sqrtf((Q.q[0] * Q.q[0] + Q.q[2] * Q.q[2]) + (Q.q[1] * Q.q[1] + Q.q[3] * Q.q[3]));
  Q.den = Q.norm + kEps;
  for (int c = 0; c < 4; ++c) Q.qn[c] = Q.q[c] / Q.den;
  const float r = Q.qn[0], x = Q.qn[1], y = Q.qn[2], z = Q.qn[3];
  Q.R[0] = 1.0f - 2.0f * (y * y + z * z);
  Q.R[1] = 2.0f * (x * y - r * z);
  Q.R[2] = 2.0f * (x * z + r * y);
  Q.R[3] = 2.0f * (x * y + r * z);
  Q.R[4] = 1.0f - 2.0f * (x * x + z * z);
  Q.R[5] = 2.0f * (y * z - r * x);
  Q.R[6] = 2.0f * (x * z - r * y);
  Q.R[7] = 2.0f * (y * z + r * x);
  Q.R[8] = 1.0f - 2.0f * (x * x + y * y);
}

// Writes the block's rows of 9 floats, staged in shared memory at row r * 9
// (an odd stride in words: each thread's writes there meet no bank
// conflict), to dst from the block's first row, in one coalesced pass
// instead of nine stores 36 bytes apart.
__device__ __forceinline__ void store_rows9(const float* __restrict__ staged, int rows,
                                            float* __restrict__ dst) {
  for (int e = threadIdx.x; e < rows * 9; e += kThreads) dst[e] = staged[e];
}

__global__ void __launch_bounds__(kThreads)
cov3d_fwd_kernel(const float* __restrict__ scales, const float* __restrict__ quats,
                 int n, float* __restrict__ cov) {
  __shared__ float rows[kThreads * 9];
  const int base = blockIdx.x * kThreads;
  const int i = base + threadIdx.x;
  if (i < n) {
    Quat Q;
    quat_rot(quats, i, Q);
    float L[9];  // L = R diag(s)
    for (int a = 0; a < 3; ++a)
      for (int k = 0; k < 3; ++k) L[3 * a + k] = Q.R[3 * a + k] * scales[3 * i + k];
    float* out = rows + 9 * threadIdx.x;
    for (int a = 0; a < 3; ++a)
      for (int b = 0; b < 3; ++b)
        out[3 * a + b] = (L[3 * a] * L[3 * b] + L[3 * a + 1] * L[3 * b + 1]) +
                         L[3 * a + 2] * L[3 * b + 2];
  }
  __syncthreads();
  store_rows9(rows, min(kThreads, n - base), cov + 9 * static_cast<size_t>(base));
}

__global__ void __launch_bounds__(kThreads)
cov3d_bwd_kernel(const float* __restrict__ scales, const float* __restrict__ quats,
                 const float* __restrict__ d_cov, int n,
                 float* __restrict__ d_scales, float* __restrict__ d_quats) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  Quat Q;
  quat_rot(quats, i, Q);
  float s[3], L[9], G[9];
  for (int k = 0; k < 3; ++k) s[k] = scales[3 * i + k];
  for (int a = 0; a < 3; ++a)
    for (int k = 0; k < 3; ++k) L[3 * a + k] = Q.R[3 * a + k] * s[k];
  const float* g = d_cov + 9 * static_cast<size_t>(i);
  // cov[a][b] = sum_k L[a][k] L[b][k]: L[a][k] meets d_cov[a][b] + d_cov[b][a]
  for (int a = 0; a < 3; ++a)
    for (int b = 0; b < 3; ++b) G[3 * a + b] = g[3 * a + b] + g[3 * b + a];
  float dR[9], ds[3] = {0.0f, 0.0f, 0.0f};
  for (int a = 0; a < 3; ++a)
    for (int k = 0; k < 3; ++k) {
      const float dL = (G[3 * a] * L[k] + G[3 * a + 1] * L[3 + k]) + G[3 * a + 2] * L[6 + k];
      ds[k] += dL * Q.R[3 * a + k];
      dR[3 * a + k] = dL * s[k];
    }
  for (int k = 0; k < 3; ++k) d_scales[3 * i + k] = ds[k];
  // R's entries are quadratic in the normalised quaternion (r, x, y, z)
  const float r = Q.qn[0], x = Q.qn[1], y = Q.qn[2], z = Q.qn[3];
  float dq[4];
  dq[0] = 2.0f * (-z * dR[1] + y * dR[2] + z * dR[3] - x * dR[5] - y * dR[6] + x * dR[7]);
  dq[1] = 2.0f * (y * dR[1] + z * dR[2] + y * dR[3] - 2.0f * x * dR[4] - r * dR[5] +
                  z * dR[6] + r * dR[7] - 2.0f * x * dR[8]);
  dq[2] = 2.0f * (-2.0f * y * dR[0] + x * dR[1] + r * dR[2] + x * dR[3] + z * dR[5] -
                  r * dR[6] + z * dR[7] - 2.0f * y * dR[8]);
  dq[3] = 2.0f * (-2.0f * z * dR[0] - r * dR[1] + x * dR[2] + r * dR[3] - 2.0f * z * dR[4] +
                  y * dR[5] + x * dR[6] + y * dR[7]);
  // qn = q / (|q| + eps); the norm's gradient is 0 at q = 0 (a dead splat's)
  const float d_den = -(((dq[0] * Q.qn[0] + dq[1] * Q.qn[1]) + dq[2] * Q.qn[2]) +
                        dq[3] * Q.qn[3]) / Q.den;
  const float d_norm = Q.norm == 0.0f ? 0.0f : d_den / Q.norm;
  for (int c = 0; c < 4; ++c) d_quats[4 * i + c] = dq[c] / Q.den + Q.q[c] * d_norm;
}

// ---------------------------------------------------------------------------
// Projection (projection.project): camera space, the fov-clamped Jacobian,
// cov2d = J W Sigma W^T J^T + 0.3 I, conic, radius, pixel centre, tile rect

struct Cam {
  float R[9], t[3], fx, fy, tanx, tany, limx, limy, w, h;
};

__device__ __forceinline__ void load_cam(const float* __restrict__ R,
                                         const float* __restrict__ t,
                                         const float* __restrict__ fx,
                                         const float* __restrict__ fy, int width,
                                         int height, Cam& c) {
  for (int k = 0; k < 9; ++k) c.R[k] = __ldg(R + k);
  for (int k = 0; k < 3; ++k) c.t[k] = __ldg(t + k);
  c.fx = __ldg(fx);
  c.fy = __ldg(fy);
  c.w = static_cast<float>(width);
  c.h = static_cast<float>(height);
  c.tanx = c.w / (2.0f * c.fx);  // Camera.tanfovx
  c.tany = c.h / (2.0f * c.fy);
  c.limx = 1.3f * c.tanx;
  c.limy = 1.3f * c.tany;
}

// The differentiable part of the projection, up to the conic.
struct Proj {
  float t[3];       // camera space
  bool in_front;    // tz > NEAR_Z
  float tz_safe;
  float xz, yz;     // t / tz_safe, before the guard band's clamp
  float txz, tyz;   // clamped
  float inv_z;
  float M[6];       // J W, 2 x 3
  float MS[6];      // M Sigma^T, 2 x 3
  float c00, c01, c11;
  bool det_ok;
  float det_safe, inv_det;
};

__device__ __forceinline__ void project_core(const float* __restrict__ means,
                                             const float* __restrict__ cov, int i,
                                             const Cam& c, float C[9], Proj& p) {
  const float m0 = means[3 * i], m1 = means[3 * i + 1], m2 = means[3 * i + 2];
  // means @ R^T as a matrix product sums it: a chain of fused multiply-adds
  for (int j = 0; j < 3; ++j)
    p.t[j] = __fmaf_rn(m2, c.R[3 * j + 2], __fmaf_rn(m1, c.R[3 * j + 1], m0 * c.R[3 * j])) +
             c.t[j];
  const float tz = p.t[2];
  p.in_front = tz > kNearZ;
  p.tz_safe = p.in_front ? tz : 1.0f;
  p.xz = p.t[0] / p.tz_safe;
  p.yz = p.t[1] / p.tz_safe;
  p.txz = clamp_f(p.xz, -c.limx, c.limx);
  p.tyz = clamp_f(p.yz, -c.limy, c.limy);
  p.inv_z = 1.0f / p.tz_safe;
  const float j00 = c.fx * p.inv_z;
  const float j02 = (-c.fx * p.txz) * p.inv_z;
  const float j11 = c.fy * p.inv_z;
  const float j12 = (-c.fy * p.tyz) * p.inv_z;
  for (int k = 0; k < 3; ++k) {
    p.M[k] = j00 * c.R[k] + j02 * c.R[6 + k];
    p.M[3 + k] = j11 * c.R[3 + k] + j12 * c.R[6 + k];
  }
  const float* g = cov + 9 * static_cast<size_t>(i);
  for (int k = 0; k < 9; ++k) C[k] = g[k];
  // MS[a][j] = sum_k M[a][k] Sigma[j][k]; cov2d[a][b] = sum_j MS[a][j] M[b][j]
  for (int a = 0; a < 2; ++a)
    for (int j = 0; j < 3; ++j)
      p.MS[3 * a + j] = (p.M[3 * a] * C[3 * j] + p.M[3 * a + 1] * C[3 * j + 1]) +
                        p.M[3 * a + 2] * C[3 * j + 2];
  p.c00 = ((p.MS[0] * p.M[0] + p.MS[1] * p.M[1]) + p.MS[2] * p.M[2]) + kDilation;
  p.c01 = (p.MS[0] * p.M[3] + p.MS[1] * p.M[4]) + p.MS[2] * p.M[5];
  p.c11 = ((p.MS[3] * p.M[3] + p.MS[4] * p.M[4]) + p.MS[5] * p.M[5]) + kDilation;
  const float det = p.c00 * p.c11 - p.c01 * p.c01;
  p.det_ok = det > 0.0f;
  p.det_safe = p.det_ok ? det : 1.0f;
  p.inv_det = 1.0f / p.det_safe;
}

__global__ void __launch_bounds__(kThreads)
project_fwd_kernel(const float* __restrict__ means, const float* __restrict__ cov,
                   const float* __restrict__ Rw, const float* __restrict__ tw,
                   const float* __restrict__ fx, const float* __restrict__ fy,
                   const float* __restrict__ opac, const float* __restrict__ tap,
                   int n, int width, int height, float* __restrict__ mean2d,
                   float* __restrict__ depth, float* __restrict__ conic,
                   int* __restrict__ radius, float* __restrict__ cull_radius,
                   int* __restrict__ rect_min, int* __restrict__ rect_max,
                   int* __restrict__ num_tiles, bool* __restrict__ valid) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  Cam c;
  load_cam(Rw, tw, fx, fy, width, height, c);
  float C[9];
  Proj p;
  project_core(means, cov, i, c, C, p);
  conic[3 * i] = p.c11 * p.inv_det;
  conic[3 * i + 1] = -p.c01 * p.inv_det;
  conic[3 * i + 2] = p.c00 * p.inv_det;

  const float mid = 0.5f * (p.c00 + p.c11);
  const float disc = sqrtf(clamp_min(mid * mid - p.det_safe, 0.1f));
  const float lam1 = mid + disc;
  float radius_f = ceilf(3.0f * sqrtf(clamp_min(lam1, 0.0f)));
  float cull = kNoCull;
  bool in_front = p.in_front;
  if (opac != nullptr) {
    // opacity-aware cutoff: beyond r_cut every pixel's alpha is < 1/255
    const float o = clamp_min(opac[i], 0.0f);
    const bool can_hit = 255.0f * o >= 1.0f;
    const float r_cut = sqrtf(2.0f * clamp_min(lam1, 0.0f) *
                              logf(clamp_min(255.0f * o, 1.0f)));
    radius_f = can_hit ? minimum(radius_f, ceilf(r_cut)) : 0.0f;
    cull = can_hit ? ceilf(r_cut) : 0.0f;
    in_front = in_front && can_hit;
  }
  cull_radius[i] = cull;

  float ndc_x = p.xz / c.tanx;
  float ndc_y = p.yz / c.tany;
  if (tap != nullptr) {
    ndc_x = ndc_x + tap[2 * i];
    ndc_y = ndc_y + tap[2 * i + 1];
  }
  const float px = ((ndc_x + 1.0f) * c.w - 1.0f) * 0.5f;
  const float py = ((ndc_y + 1.0f) * c.h - 1.0f) * 0.5f;
  mean2d[2 * i] = px;
  mean2d[2 * i + 1] = py;
  depth[i] = p.t[2];

  const int grid_x = (width + kTileI - 1) / kTileI;
  const int grid_y = (height + kTileI - 1) / kTileI;
  const float r = radius_f;
  const int rx_min = clamp_i(to_i32((px - r) / kTile), 0, grid_x);
  const int ry_min = clamp_i(to_i32((py - r) / kTile), 0, grid_y);
  const int rx_max = clamp_i(to_i32((px + r + kTile - 1.0f) / kTile), 0, grid_x);
  const int ry_max = clamp_i(to_i32((py + r + kTile - 1.0f) / kTile), 0, grid_y);
  const int area = (rx_max - rx_min) * (ry_max - ry_min);
  const bool ok = in_front && p.det_ok && area > 0;
  rect_min[2 * i] = rx_min;
  rect_min[2 * i + 1] = ry_min;
  rect_max[2 * i] = rx_max;
  rect_max[2 * i + 1] = ry_max;
  radius[i] = to_i32(ok ? r : 0.0f);
  num_tiles[i] = ok ? area : 0;
  valid[i] = ok;
}

// One splat of project_bwd_kernel; its d_cov row goes to dC.
__device__ __forceinline__ void project_bwd_splat(
    const float* __restrict__ means, const float* __restrict__ cov,
    const float* __restrict__ Rw, const float* __restrict__ tw,
    const float* __restrict__ fx, const float* __restrict__ fy,
    const float* __restrict__ g_mean2d, int s_mean2d, const float* __restrict__ g_conic,
    int s_conic, const float* __restrict__ g_depth, int s_depth, int i, int width,
    int height, float* __restrict__ d_means, float* __restrict__ dC,
    float* __restrict__ d_tap) {
  Cam c;
  load_cam(Rw, tw, fx, fy, width, height, c);
  float C[9];
  Proj p;
  project_core(means, cov, i, c, C, p);
  const size_t ii = i;
  float gpx = 0.0f, gpy = 0.0f, ga = 0.0f, gb = 0.0f, gc = 0.0f, gz = 0.0f;
  if (g_mean2d != nullptr) {
    gpx = g_mean2d[ii * s_mean2d];
    gpy = g_mean2d[ii * s_mean2d + 1];
  }
  if (g_conic != nullptr) {
    ga = g_conic[ii * s_conic];
    gb = g_conic[ii * s_conic + 1];
    gc = g_conic[ii * s_conic + 2];
  }
  if (g_depth != nullptr) gz = g_depth[ii * s_depth];

  // conic = (c11, -c01, c00) / det_safe; det gets no gradient where det <= 0
  const float d_inv_det = (ga * p.c11 - gb * p.c01) + gc * p.c00;
  float d_c00 = gc * p.inv_det;
  float d_c01 = -gb * p.inv_det;
  float d_c11 = ga * p.inv_det;
  if (p.det_ok) {
    const float d_det = -d_inv_det * (p.inv_det * p.inv_det);
    d_c00 += d_det * p.c11;
    d_c11 += d_det * p.c00;
    d_c01 += -2.0f * p.c01 * d_det;
  }
  // c00 = MS0.M0, c01 = MS0.M1, c11 = MS1.M1
  float dMS[6], dM[6];
  for (int j = 0; j < 3; ++j) {
    dMS[j] = d_c00 * p.M[j] + d_c01 * p.M[3 + j];
    dMS[3 + j] = d_c11 * p.M[3 + j];
    dM[j] = d_c00 * p.MS[j];
    dM[3 + j] = d_c01 * p.MS[j] + d_c11 * p.MS[3 + j];
  }
  // MS[a][j] = sum_k M[a][k] Sigma[j][k]
  for (int j = 0; j < 3; ++j)
    for (int k = 0; k < 3; ++k) dC[3 * j + k] = p.M[k] * dMS[j] + p.M[3 + k] * dMS[3 + j];
  for (int a = 0; a < 2; ++a)
    for (int k = 0; k < 3; ++k)
      dM[3 * a + k] += (dMS[3 * a] * C[k] + dMS[3 * a + 1] * C[3 + k]) +
                       dMS[3 * a + 2] * C[6 + k];
  // M0 = j00 W0 + j02 W2, M1 = j11 W1 + j12 W2
  const float* R = c.R;
  const float d_j00 = (dM[0] * R[0] + dM[1] * R[1]) + dM[2] * R[2];
  const float d_j02 = (dM[0] * R[6] + dM[1] * R[7]) + dM[2] * R[8];
  const float d_j11 = (dM[3] * R[3] + dM[4] * R[4]) + dM[5] * R[5];
  const float d_j12 = (dM[3] * R[6] + dM[4] * R[7]) + dM[5] * R[8];
  const float d_inv_z = ((c.fx * d_j00 + (-c.fx * p.txz) * d_j02) + c.fy * d_j11) +
                        (-c.fy * p.tyz) * d_j12;
  // the guard band's clamp passes the gradient where -lim <= x <= lim
  float d_xz = p.xz >= -c.limx && p.xz <= c.limx ? -c.fx * p.inv_z * d_j02 : 0.0f;
  float d_yz = p.yz >= -c.limy && p.yz <= c.limy ? -c.fy * p.inv_z * d_j12 : 0.0f;
  // mean2d: px = ((x / tz_safe / tanx + tap + 1) W - 1) / 2
  const float d_ndc_x = gpx * 0.5f * c.w;
  const float d_ndc_y = gpy * 0.5f * c.h;
  if (d_tap != nullptr) {
    d_tap[2 * ii] = d_ndc_x;
    d_tap[2 * ii + 1] = d_ndc_y;
  }
  d_xz += d_ndc_x / c.tanx;
  d_yz += d_ndc_y / c.tany;
  const float d_tz_safe =
      -(d_xz * p.xz + d_yz * p.yz) / p.tz_safe - d_inv_z * (p.inv_z * p.inv_z);
  float dt[3];
  dt[0] = d_xz / p.tz_safe;
  dt[1] = d_yz / p.tz_safe;
  dt[2] = gz + (p.in_front ? d_tz_safe : 0.0f);
  // t = R m + t_w2c
  for (int k = 0; k < 3; ++k)
    d_means[3 * ii + k] = (dt[0] * R[k] + dt[1] * R[3 + k]) + dt[2] * R[6 + k];
}

// Cotangents of mean2d [N, 2], conic [N, 3] and depth [N], each at its own
// row stride (in floats); a null one is zero.
__global__ void __launch_bounds__(kThreads)
project_bwd_kernel(const float* __restrict__ means, const float* __restrict__ cov,
                   const float* __restrict__ Rw, const float* __restrict__ tw,
                   const float* __restrict__ fx, const float* __restrict__ fy,
                   const float* __restrict__ g_mean2d, int s_mean2d,
                   const float* __restrict__ g_conic, int s_conic,
                   const float* __restrict__ g_depth, int s_depth, int n, int width,
                   int height, float* __restrict__ d_means, float* __restrict__ d_cov,
                   float* __restrict__ d_tap) {
  __shared__ float d_cov_rows[kThreads * 9];
  const int base = blockIdx.x * kThreads;
  const int i = base + threadIdx.x;
  if (i < n) project_bwd_splat(means, cov, Rw, tw, fx, fy, g_mean2d, s_mean2d, g_conic,
                               s_conic, g_depth, s_depth, i, width, height, d_means,
                               d_cov_rows + 9 * threadIdx.x, d_tap);
  __syncthreads();
  store_rows9(d_cov_rows, min(kThreads, n - base), d_cov + 9 * static_cast<size_t>(base));
}

// ---------------------------------------------------------------------------
// SH colour (sh.sh_to_rgb): the basis along the normalised view direction,
// contracted with the coefficients, + 0.5, clamped at 0 from below

constexpr float kC0 = 0.28209479177387814f;
constexpr float kC1 = 0.4886025119029199f;
__constant__ float kC2[5] = {1.0925484305920792f, -1.0925484305920792f,
                             0.31539156525252005f, -1.0925484305920792f,
                             0.5462742152960396f};
__constant__ float kC3[7] = {-0.5900435899266435f, 2.890611442640554f,
                             -0.4570457994644658f, 0.3731763325901154f,
                             -0.4570457994644658f, 1.445305721320277f,
                             -0.5900435899266435f};
__constant__ float kC4[9] = {2.5033429417967046f, -1.7701307697799304f,
                             0.9461746957575601f, -0.6690465435572892f,
                             0.10578554691520431f, -0.6690465435572892f,
                             0.47308734787878004f, -1.7701307697799304f,
                             0.6258357354491761f};

template <int DEG>
__device__ __forceinline__ void sh_basis(float x, float y, float z, float* b) {
  b[0] = kC0;
  if (DEG > 0) {
    b[1] = -kC1 * y;
    b[2] = kC1 * z;
    b[3] = -kC1 * x;
  }
  if (DEG > 1) {
    const float xx = x * x, yy = y * y, zz = z * z;
    const float xy = x * y, yz = y * z, xz = x * z;
    b[4] = kC2[0] * xy;
    b[5] = kC2[1] * yz;
    b[6] = kC2[2] * ((2.0f * zz - xx) - yy);
    b[7] = kC2[3] * xz;
    b[8] = kC2[4] * (xx - yy);
    if (DEG > 2) {
      b[9] = kC3[0] * y * (3.0f * xx - yy);
      b[10] = kC3[1] * xy * z;
      b[11] = kC3[2] * y * ((4.0f * zz - xx) - yy);
      b[12] = kC3[3] * z * ((2.0f * zz - 3.0f * xx) - 3.0f * yy);
      b[13] = kC3[4] * x * ((4.0f * zz - xx) - yy);
      b[14] = kC3[5] * z * (xx - yy);
      b[15] = kC3[6] * x * (xx - 3.0f * yy);
    }
    if (DEG > 3) {
      b[16] = kC4[0] * xy * (xx - yy);
      b[17] = kC4[1] * yz * (3.0f * xx - yy);
      b[18] = kC4[2] * xy * (7.0f * zz - 1.0f);
      b[19] = kC4[3] * yz * (7.0f * zz - 3.0f);
      b[20] = kC4[4] * (zz * (35.0f * zz - 30.0f) + 3.0f);
      b[21] = kC4[5] * xz * (7.0f * zz - 3.0f);
      b[22] = kC4[6] * (xx - yy) * (7.0f * zz - 1.0f);
      b[23] = kC4[7] * xz * (xx - 3.0f * yy);
      b[24] = kC4[8] * (xx * (xx - 3.0f * yy) - yy * (3.0f * xx - yy));
    }
  }
}

// (x, y, z) gradient of sum_j db[j] * basis_j(x, y, z)
template <int DEG>
__device__ __forceinline__ void sh_basis_grad(float x, float y, float z,
                                              const float* db, float& gx, float& gy,
                                              float& gz) {
  gx = 0.0f;
  gy = 0.0f;
  gz = 0.0f;
  if (DEG > 0) {
    gy += -kC1 * db[1];
    gz += kC1 * db[2];
    gx += -kC1 * db[3];
  }
  if (DEG > 1) {
    const float xx = x * x, yy = y * y, zz = z * z;
    const float xy = x * y, yz = y * z, xz = x * z;
    gx += kC2[0] * y * db[4];
    gy += kC2[0] * x * db[4];
    gy += kC2[1] * z * db[5];
    gz += kC2[1] * y * db[5];
    gx += -2.0f * kC2[2] * x * db[6];
    gy += -2.0f * kC2[2] * y * db[6];
    gz += 4.0f * kC2[2] * z * db[6];
    gx += kC2[3] * z * db[7];
    gz += kC2[3] * x * db[7];
    gx += 2.0f * kC2[4] * x * db[8];
    gy += -2.0f * kC2[4] * y * db[8];
    if (DEG > 2) {
      gx += kC3[0] * 6.0f * xy * db[9];
      gy += kC3[0] * 3.0f * (xx - yy) * db[9];
      gx += kC3[1] * yz * db[10];
      gy += kC3[1] * xz * db[10];
      gz += kC3[1] * xy * db[10];
      gx += kC3[2] * -2.0f * xy * db[11];
      gy += kC3[2] * (4.0f * zz - xx - 3.0f * yy) * db[11];
      gz += kC3[2] * 8.0f * yz * db[11];
      gx += kC3[3] * -6.0f * xz * db[12];
      gy += kC3[3] * -6.0f * yz * db[12];
      gz += kC3[3] * (6.0f * zz - 3.0f * xx - 3.0f * yy) * db[12];
      gx += kC3[4] * (4.0f * zz - 3.0f * xx - yy) * db[13];
      gy += kC3[4] * -2.0f * xy * db[13];
      gz += kC3[4] * 8.0f * xz * db[13];
      gx += kC3[5] * 2.0f * xz * db[14];
      gy += kC3[5] * -2.0f * yz * db[14];
      gz += kC3[5] * (xx - yy) * db[14];
      gx += kC3[6] * 3.0f * (xx - yy) * db[15];
      gy += kC3[6] * -6.0f * xy * db[15];
    }
    if (DEG > 3) {
      const float z7a = 7.0f * zz - 1.0f, z7b = 7.0f * zz - 3.0f;
      gx += kC4[0] * y * (3.0f * xx - yy) * db[16];
      gy += kC4[0] * x * (xx - 3.0f * yy) * db[16];
      gx += kC4[1] * 6.0f * xy * z * db[17];
      gy += kC4[1] * 3.0f * z * (xx - yy) * db[17];
      gz += kC4[1] * y * (3.0f * xx - yy) * db[17];
      gx += kC4[2] * y * z7a * db[18];
      gy += kC4[2] * x * z7a * db[18];
      gz += kC4[2] * 14.0f * xy * z * db[18];
      gy += kC4[3] * z * z7b * db[19];
      gz += kC4[3] * y * (21.0f * zz - 3.0f) * db[19];
      gz += kC4[4] * z * (140.0f * zz - 60.0f) * db[20];
      gx += kC4[5] * z * z7b * db[21];
      gz += kC4[5] * x * (21.0f * zz - 3.0f) * db[21];
      gx += kC4[6] * 2.0f * x * z7a * db[22];
      gy += kC4[6] * -2.0f * y * z7a * db[22];
      gz += kC4[6] * 14.0f * z * (xx - yy) * db[22];
      gx += kC4[7] * 3.0f * z * (xx - yy) * db[23];
      gy += kC4[7] * -6.0f * xy * z * db[23];
      gz += kC4[7] * x * (xx - 3.0f * yy) * db[23];
      gx += kC4[8] * 4.0f * x * (xx - 3.0f * yy) * db[24];
      gy += kC4[8] * 4.0f * y * (yy - 3.0f * xx) * db[24];
    }
  }
}

// The view direction of splat i: v = mean - centre, dir = v / (|v| + 1e-12).
struct View {
  float v[3], d[3], norm, den;
};

__device__ __forceinline__ void view_dir(const float* __restrict__ means,
                                         const float* __restrict__ center, int i,
                                         View& w) {
  for (int k = 0; k < 3; ++k) w.v[k] = means[3 * i + k] - __ldg(center + k);
  // torch.linalg.norm's order on the card for a row of 3
  w.norm = sqrtf((w.v[0] * w.v[0] + w.v[2] * w.v[2]) + w.v[1] * w.v[1]);
  w.den = w.norm + kEps;
  for (int k = 0; k < 3; ++k) w.d[k] = w.v[k] / w.den;
}

// Channel ch of sum_j b[j] row[3 j + ch], summed as the card's matrix-vector
// product (the plain version's einsum) sums it: chains of fused
// multiply-adds over j < ceil(KD / 2) and over the rest, then their sum.
template <int KD>
__device__ __forceinline__ float sh_dot(const float* b, const float* row, int ch) {
  constexpr int kHalf = (KD + 1) / 2;
  if constexpr (KD == 1) return b[0] * row[ch];
  float lo = b[0] * row[ch];
  for (int j = 1; j < kHalf; ++j) lo = __fmaf_rn(b[j], row[3 * j + ch], lo);
  float hi = b[kHalf] * row[3 * kHalf + ch];
  for (int j = kHalf + 1; j < KD; ++j) hi = __fmaf_rn(b[j], row[3 * j + ch], hi);
  return lo + hi;
}

// Copies the first `used` floats of each of the block's `rows` rows of
// `width` floats into shared memory at row stride `stride`, coalesced.
__device__ __forceinline__ void stage_rows(const float* __restrict__ src, int width,
                                           int used, int rows, int stride,
                                           float* __restrict__ dst) {
  for (int e = threadIdx.x; e < rows * used; e += kThreads) {
    const int r = e / used, k = e - r * used;
    dst[r * stride + k] = src[static_cast<size_t>(r) * width + k];
  }
}

template <int DEG>
__global__ void __launch_bounds__(kThreads)
sh_fwd_kernel(const float* __restrict__ sh, int K, const float* __restrict__ means,
              const float* __restrict__ center, int n, float* __restrict__ rgb) {
  constexpr int kD = (DEG + 1) * (DEG + 1);
  constexpr int kUsed = 3 * kD;
  constexpr int kStride = kUsed | 1;
  __shared__ float rows[kThreads * kStride];
  const int base = blockIdx.x * kThreads;
  const int nrows = min(kThreads, n - base);
  stage_rows(sh + static_cast<size_t>(base) * K * 3, K * 3, kUsed, nrows, kStride, rows);
  __syncthreads();
  const int i = base + threadIdx.x;
  if (i >= n) return;
  View w;
  view_dir(means, center, i, w);
  float b[kD];
  sh_basis<DEG>(w.d[0], w.d[1], w.d[2], b);
  const float* row = rows + threadIdx.x * kStride;
  for (int ch = 0; ch < 3; ++ch) rgb[3 * i + ch] = clamp_min(sh_dot<kD>(b, row, ch) + 0.5f, 0.0f);
}

// Cotangent of rgb [N, 3] at row stride s_rgb. Writes d_sh [N, K, 3] whole
// (zeros past the coefficients in use) and d_means [N, 3].
template <int DEG>
__global__ void __launch_bounds__(kThreads)
sh_bwd_kernel(const float* __restrict__ sh, int K, const float* __restrict__ means,
              const float* __restrict__ center, const float* __restrict__ g_rgb,
              int s_rgb, int n, float* __restrict__ d_sh,
              float* __restrict__ d_means) {
  constexpr int kD = (DEG + 1) * (DEG + 1);
  constexpr int kUsed = 3 * kD;
  constexpr int kStride = kUsed | 1;
  __shared__ float rows[kThreads * kStride];
  const int base = blockIdx.x * kThreads;
  const int nrows = min(kThreads, n - base);
  stage_rows(sh + static_cast<size_t>(base) * K * 3, K * 3, kUsed, nrows, kStride, rows);
  __syncthreads();
  const int i = base + threadIdx.x;
  if (i < n) {
    View w;
    view_dir(means, center, i, w);
    float b[kD];
    sh_basis<DEG>(w.d[0], w.d[1], w.d[2], b);
    float* row = rows + threadIdx.x * kStride;
    float g[3];
    for (int ch = 0; ch < 3; ++ch)  // the clamp at 0 passes it where rgb + 0.5 >= 0
      g[ch] = sh_dot<kD>(b, row, ch) + 0.5f >= 0.0f
                  ? g_rgb[static_cast<size_t>(i) * s_rgb + ch] : 0.0f;
    float db[kD];
    for (int j = 0; j < kD; ++j) {
      db[j] = (row[3 * j] * g[0] + row[3 * j + 1] * g[1]) + row[3 * j + 2] * g[2];
      for (int ch = 0; ch < 3; ++ch) row[3 * j + ch] = b[j] * g[ch];  // d_sh
    }
    float gd[3];
    sh_basis_grad<DEG>(w.d[0], w.d[1], w.d[2], db, gd[0], gd[1], gd[2]);
    // dir = v / (|v| + eps); the norm's gradient is 0 at v = 0
    const float d_den = -(((gd[0] * w.d[0] + gd[1] * w.d[1]) + gd[2] * w.d[2])) / w.den;
    const float d_norm = w.norm == 0.0f ? 0.0f : d_den / w.norm;
    for (int k = 0; k < 3; ++k) d_means[3 * i + k] = gd[k] / w.den + w.v[k] * d_norm;
  }
  __syncthreads();
  // the block's d_sh rows, [nrows, K * 3], in one coalesced pass
  float* out = d_sh + static_cast<size_t>(base) * K * 3;
  const int width = K * 3;
  for (int e = threadIdx.x; e < nrows * width; e += kThreads) {
    const int r = e / width, k = e - r * width;
    out[e] = k < kUsed ? rows[r * kStride + k] : 0.0f;
  }
}

int blocks_for(int n) { return n / kThreads + (n % kThreads != 0); }

}  // namespace

extern "C" {

// cov [n, 9] from scales [n, 3] and quats [n, 4]; returns the first CUDA
// error (0 on success), as every entry here does.
int og_cov3d_fwd(const float* scales, const float* quats, int n, float* cov,
                 void* stream) {
  if (n > 0)
    cov3d_fwd_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        scales, quats, n, cov);
  return static_cast<int>(cudaGetLastError());
}

// d_scales [n, 3], d_quats [n, 4] from d_cov [n, 9].
int og_cov3d_bwd(const float* scales, const float* quats, const float* d_cov, int n,
                 float* d_scales, float* d_quats, void* stream) {
  if (n > 0)
    cov3d_bwd_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        scales, quats, d_cov, n, d_scales, d_quats);
  return static_cast<int>(cudaGetLastError());
}

// The projected fields of means [n, 3] and cov [n, 9] under the camera
// (R [3, 3], t [3], fx, fy in device memory). opac [n] and tap [n, 2] may
// be null.
int og_project_fwd(const float* means, const float* cov, const float* R, const float* t,
                   const float* fx, const float* fy, const float* opac, const float* tap,
                   int n, int width, int height, float* mean2d, float* depth,
                   float* conic, int* radius, float* cull_radius, int* rect_min,
                   int* rect_max, int* num_tiles, bool* valid, void* stream) {
  if (n > 0)
    project_fwd_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        means, cov, R, t, fx, fy, opac, tap, n, width, height, mean2d, depth, conic,
        radius, cull_radius, rect_min, rect_max, num_tiles, valid);
  return static_cast<int>(cudaGetLastError());
}

// d_means [n, 3], d_cov [n, 9] and, unless null, d_tap [n, 2] from the
// cotangents of mean2d, conic and depth (each null or at its row stride).
int og_project_bwd(const float* means, const float* cov, const float* R, const float* t,
                   const float* fx, const float* fy, const float* g_mean2d,
                   int s_mean2d, const float* g_conic, int s_conic, const float* g_depth,
                   int s_depth, int n, int width, int height, float* d_means,
                   float* d_cov, float* d_tap, void* stream) {
  if (n > 0)
    project_bwd_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        means, cov, R, t, fx, fy, g_mean2d, s_mean2d, g_conic, s_conic, g_depth, s_depth,
        n, width, height, d_means, d_cov, d_tap);
  return static_cast<int>(cudaGetLastError());
}

// rgb [n, 3] from sh [n, K, 3] at degree deg (0-4; K >= (deg+1)^2), means
// [n, 3] and the camera centre [3].
int og_sh_fwd(int deg, const float* sh, int K, const float* means, const float* center,
              int n, float* rgb, void* stream) {
  if (n > 0) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int g = blocks_for(n);
    switch (deg) {
      case 0: sh_fwd_kernel<0><<<g, kThreads, 0, s>>>(sh, K, means, center, n, rgb); break;
      case 1: sh_fwd_kernel<1><<<g, kThreads, 0, s>>>(sh, K, means, center, n, rgb); break;
      case 2: sh_fwd_kernel<2><<<g, kThreads, 0, s>>>(sh, K, means, center, n, rgb); break;
      case 3: sh_fwd_kernel<3><<<g, kThreads, 0, s>>>(sh, K, means, center, n, rgb); break;
      case 4: sh_fwd_kernel<4><<<g, kThreads, 0, s>>>(sh, K, means, center, n, rgb); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// d_sh [n, K, 3] and d_means [n, 3] from the cotangent of rgb at row stride
// s_rgb.
int og_sh_bwd(int deg, const float* sh, int K, const float* means, const float* center,
              const float* g_rgb, int s_rgb, int n, float* d_sh, float* d_means,
              void* stream) {
  if (n > 0) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int g = blocks_for(n);
    switch (deg) {
#define OG_SH_BWD(D)                                                                 \
  case D:                                                                            \
    sh_bwd_kernel<D><<<g, kThreads, 0, s>>>(sh, K, means, center, g_rgb, s_rgb, n, \
                                            d_sh, d_means);                          \
    break;
      OG_SH_BWD(0)
      OG_SH_BWD(1)
      OG_SH_BWD(2)
      OG_SH_BWD(3)
      OG_SH_BWD(4)
#undef OG_SH_BWD
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
