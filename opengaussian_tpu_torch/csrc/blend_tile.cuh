// One tile's depth-ordered blend and its backward replay, shared by the
// stream kernels (blend_stream_fwd.cu K1, blend_stream_bwd.cu K2) and the
// dense-block kernels (blend_tiles_fwd.cu K5, blend_tiles_bwd.cu K6).
//
// A tile's run is `cnt` consecutive rows of n_fields floats: mean2d x/y,
// conic a/b/c, opacity, payload (C = n_fields - 6). In the stream layout it
// starts at tstart[t] of the sorted slot stream; in the dense layout at
// t * K of the [T, K, n_fields] block. Either way the caller hands these
// functions a pointer to the run's first row, so both layouts run the same
// arithmetic and round alike.
//
// Semantics (opengaussian_tpu/ops/blend.py): per pixel, walk the run front to
// back; alpha = min(0.99, o * exp(power)) with alpha = 0 where power > 0;
// skip alpha < 1/255; a slot composites only while the transmittance after it
// stays >= 1e-4, and the first slot that would take it below stops the pixel
// for good.
//
// Both are called by every thread of a CTA of kPix threads, one per pixel,
// with dynamic shared memory of chunk * n_fields floats (forward) or
// (1 + kWarps) * chunk * n_fields floats (backward). Pointer offsets are
// 64-bit: a dense block's (t * K + k) * n_fields passes 2^31 at full width.

#pragma once

#include <cuda_runtime.h>

namespace og_blend {

constexpr int kTile = 16;
constexpr int kPix = kTile * kTile;  // threads per CTA: one per pixel
constexpr int kWarps = kPix / 32;
constexpr int kMaxC = 16;  // payload channels one thread holds (MAX_C)
constexpr int kMaxF = 6 + kMaxC;
constexpr unsigned kFull = 0xffffffffu;

// opengaussian_tpu/ops/blend.py, rounded to float as the JAX package does
constexpr float kAlphaMin = static_cast<float>(1.0 / 255.0);
constexpr float kAlphaMax = 0.99f;
constexpr float kTEps = 1e-4f;
constexpr float kMinOneMinusA = static_cast<float>(1.0 - 0.99);

// Forward blend of one run. tile: the image tile whose pixels this CTA
// shades. accum: this tile's [C, 256] block; t_final: its [256] row.
__device__ __forceinline__ void blend_run_fwd(
    const float* __restrict__ run, int n_fields, int cnt, int tile,
    int grid_x, int chunk, float* __restrict__ accum,
    float* __restrict__ t_final) {
  extern __shared__ float srow[];  // [chunk, n_fields]
  const int lane = threadIdx.x;
  const int C = n_fields - 6;
  // integer pixel coordinates (rasterize_pallas.py:_pixels), not +0.5
  const float px = static_cast<float>((tile % grid_x) * kTile + lane % kTile);
  const float py = static_cast<float>((tile / grid_x) * kTile + lane / kTile);

  float T = 1.0f;
  int done = 0;
  float acc[kMaxC];
#pragma unroll
  for (int c = 0; c < kMaxC; ++c) acc[c] = 0.0f;

  for (int base = 0; base < cnt; base += chunk) {
    // Every pixel stopped: the tile is finished. This is also the barrier
    // that keeps the staging below from overwriting rows still being read.
    if (__syncthreads_and(done)) break;
    const int n = min(chunk, cnt - base);
    const float* src = run + static_cast<long long>(base) * n_fields;
    for (int i = lane; i < n * n_fields; i += kPix) srow[i] = src[i];
    __syncthreads();
    if (done) continue;
    for (int k = 0; k < n; ++k) {
      const float* g = srow + k * n_fields;
      const float dx = g[0] - px;
      const float dy = g[1] - py;
      const float power =
          -0.5f * (g[2] * dx * dx + g[4] * dy * dy) - g[3] * dx * dy;
      const float gauss = expf(fminf(power, 0.0f));
      const float araw = power <= 0.0f ? g[5] * gauss : 0.0f;
      const float a = fminf(araw, kAlphaMax);
      if (!(a >= kAlphaMin)) continue;
      const float t_next = T * (1.0f - a);
      if (t_next < kTEps) {
        done = 1;
        break;
      }
      const float w = a * T;
#pragma unroll
      for (int c = 0; c < kMaxC; ++c)
        if (c < C) acc[c] += g[6 + c] * w;
      T = t_next;
    }
  }

#pragma unroll
  for (int c = 0; c < kMaxC; ++c)
    if (c < C) accum[c * kPix + lane] = acc[c];
  t_final[lane] = T;
}

// Backward replay of one run: the forward's walk again, with the suffix form
// of the blend's derivative, which needs no back-to-front pass and no stored
// per-slot state:
//   ga_total = sum_c g_accum[c] * accum[c]            (per pixel, once)
//   gc       = sum_c g_accum[c] * payload[c]          (per slot and pixel)
//   b_inc   += w * gc                                 (inclusive running sum)
//   d_alpha  = T_prev * gc - (ga_total - b_inc) / (1 - a)
//              - g_t * t_final / (1 - a)              (1 - a floored at 0.01)
// d_alpha is zero where alpha was clamped at 0.99 and for pixels that had
// stopped. From it: d_power = a * d_alpha, the conic and mean2d gradients of
// the quadratic form, d_opacity = d_alpha * exp(power), d_payload =
// w * g_accum. Row k of d_run gets the sum of the 256 pixels' terms for slot
// k: a warp shuffle tree, then the 8 warps' partials in warp order through
// shared memory, so the rows repeat bit for bit. Rows the walk does not
// reach (after every pixel stopped) are left as the caller zeroed them.
// accum/g_accum: this tile's [C, 256] blocks; t_final/g_t: its [256] rows.
__device__ __forceinline__ void blend_run_bwd(
    const float* __restrict__ run, int n_fields, int cnt, int tile,
    int grid_x, int chunk, const float* __restrict__ accum,
    const float* __restrict__ t_final, const float* __restrict__ g_accum,
    const float* __restrict__ g_t, float* __restrict__ d_run) {
  extern __shared__ float smem[];
  float* srow = smem;                     // [chunk, n_fields]
  float* part = smem + chunk * n_fields;  // [kWarps, chunk, n_fields]
  const int lane = threadIdx.x;
  const int warp = lane / 32;
  const int wl = lane % 32;
  const int C = n_fields - 6;
  // integer pixel coordinates (rasterize_pallas.py:_pixels), not +0.5
  const float px = static_cast<float>((tile % grid_x) * kTile + lane % kTile);
  const float py = static_cast<float>((tile / grid_x) * kTile + lane / kTile);

  float gacc[kMaxC];
  float ga_total = 0.0f;
#pragma unroll
  for (int c = 0; c < kMaxC; ++c) {
    gacc[c] = 0.0f;
    if (c < C) {
      gacc[c] = g_accum[c * kPix + lane];
      const float term = gacc[c] * accum[c * kPix + lane];
      ga_total = c == 0 ? term : ga_total + term;
    }
  }
  const float gtt = g_t[lane] * t_final[lane];

  float T = 1.0f;
  float bacc = 0.0f;
  int done = 0;
  for (int base = 0; base < cnt; base += chunk) {
    // Every pixel stopped: the rest of the run gets no gradient. This is
    // also the barrier that keeps the staging below from overwriting rows
    // and partials the previous chunk is still reading.
    if (__syncthreads_and(done)) break;
    const int n = min(chunk, cnt - base);
    const float* src = run + static_cast<long long>(base) * n_fields;
    for (int i = lane; i < n * n_fields; i += kPix) srow[i] = src[i];
    __syncthreads();
    for (int k = 0; k < n; ++k) {
      const float* g = srow + k * n_fields;
      float v[kMaxF];
#pragma unroll
      for (int f = 0; f < kMaxF; ++f) v[f] = 0.0f;
      bool contrib = false;
      if (!done) {
        const float dx = g[0] - px;
        const float dy = g[1] - py;
        const float power =
            -0.5f * (g[2] * dx * dx + g[4] * dy * dy) - g[3] * dx * dy;
        const float gauss = expf(fminf(power, 0.0f));
        const float araw = power <= 0.0f ? g[5] * gauss : 0.0f;
        const float a = fminf(araw, kAlphaMax);
        if (a >= kAlphaMin) {
          const float t_next = T * (1.0f - a);
          if (t_next < kTEps) {
            done = 1;
          } else {
            contrib = true;
            const float w = a * T;
            float gc = 0.0f;
#pragma unroll
            for (int c = 0; c < kMaxC; ++c) {
              if (c < C) {
                const float term = g[6 + c] * gacc[c];
                gc = c == 0 ? term : gc + term;
              }
            }
            bacc = bacc + w * gc;
            const float one_m_a = fmaxf(1.0f - a, kMinOneMinusA);
            float d_alpha =
                T * gc - (ga_total - bacc) / one_m_a - gtt / one_m_a;
            // min(0.99, .) has no gradient where it clamped
            if (!(araw < kAlphaMax)) d_alpha = 0.0f;
            const float d_power = a * d_alpha;
            const float ca = g[2], cb = g[3], cc = g[4];
            v[0] = d_power * -(ca * dx + cb * dy);
            v[1] = d_power * -(cc * dy + cb * dx);
            v[2] = d_power * (-0.5f * dx * dx);
            v[3] = d_power * (-dx * dy);
            v[4] = d_power * (-0.5f * dy * dy);
            v[5] = d_alpha * gauss;
#pragma unroll
            for (int c = 0; c < kMaxC; ++c)
              if (c < C) v[6 + c] = w * gacc[c];
            T = t_next;
          }
        }
      }
      float* out = part + (warp * chunk + k) * n_fields;
      if (__any_sync(kFull, contrib)) {
#pragma unroll
        for (int f = 0; f < kMaxF; ++f) {
          if (f < n_fields) {
            float x = v[f];
#pragma unroll
            for (int off = 16; off > 0; off /= 2)
              x = x + __shfl_down_sync(kFull, x, off);
            if (wl == 0) out[f] = x;
          }
        }
      } else if (wl == 0) {
        for (int f = 0; f < n_fields; ++f) out[f] = 0.0f;
      }
    }
    __syncthreads();
    // each (slot, field): the 8 warps' partials in warp order
    float* dst = d_run + static_cast<long long>(base) * n_fields;
    for (int i = lane; i < n * n_fields; i += kPix) {
      float s = part[i];
      for (int w = 1; w < kWarps; ++w) s = s + part[w * chunk * n_fields + i];
      dst[i] = s;
    }
  }
}

// Dynamic shared memory of blend_run_bwd, in bytes.
inline size_t bwd_smem_bytes(int chunk, int n_fields) {
  return static_cast<size_t>(1 + kWarps) * chunk * n_fields * sizeof(float);
}

}  // namespace og_blend
