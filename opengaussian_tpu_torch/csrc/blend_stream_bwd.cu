// Backward of the stream blend: per-slot gradient rows by front-to-back replay.
//
// Replaces: opengaussian_tpu/ops/rasterize_pallas.py:blend_stream_pallas_bwd
// (the Pallas call at line 670; kernel _bwd_stream_kernel, math
// _chunk_blend_math + _chunk_grad_rows). Given the forward's accum and
// t_final and the cotangents g_accum and g_t, every pixel walks its tile's
// run again in the forward's order (same alpha, skip and early-stop rules as
// csrc/blend_stream_fwd.cu) and uses the suffix form of the blend's
// derivative, which needs no back-to-front pass and no stored per-slot state:
//   ga_total = sum_c g_accum[c] * accum[c]            (per pixel, once)
//   gc       = sum_c g_accum[c] * payload[c]          (per slot and pixel)
//   b_inc   += w * gc                                 (inclusive running sum)
//   d_alpha  = T_prev * gc - (ga_total - b_inc) / (1 - a)
//              - g_t * t_final / (1 - a)              (1 - a floored at 0.01)
// d_alpha is zero where alpha was clamped at 0.99 and for pixels that had
// stopped. From it: d_power = a * d_alpha, the conic and mean2d gradients of
// the quadratic form, d_opacity = d_alpha * exp(power), d_payload = w * g_accum.
// Each slot's row is the sum of its 256 pixels' contributions, written at the
// slot's position in the stream: d_rows [P, 6 + C] (dmean2d 2, dconic 3,
// dopacity 1, dpayload C). Rows no tile walks (past counts[t], past the last
// tile, or after a CTA stopped early) are left as the caller zeroed them.
//
// Bound on an H100: operations. A (slot, pixel) pair costs the forward's ~24
// fp32 operations to evaluate again (+3 past the 1/255 test); a pair that
// composites adds ~4C + 36 (its gradient terms and their share of the sum
// over pixels; chip_smoke.py:ops_grad). Per slot the kernel reads one row of
// 4(6 + C) bytes and writes one, so the fp32 issue rate, not HBM, is the
// floor (chip_smoke.py computes it from this frame's pair counts; PERF.md
// has the numbers).
// What the design does about that bound:
//   * one CTA per 16x16 tile, one thread per pixel, the run staged chunk by
//     chunk into shared memory as in the forward, so each pair is replayed
//     exactly once and device memory sees each slot row once;
//   * the reduction over pixels is a warp shuffle tree, then a fixed-order sum
//     of the 8 warps' partials through shared memory: no atomics, so the rows
//     are the same from run to run;
//   * a warp none of whose pixels composites a slot skips that slot's
//     reduction (__any_sync): most evaluated pairs fail the 1/255 test;
//   * the CTA stops when every pixel has stopped, as the forward does.
// No sentinels and no non-finite clamps: rows the kernel does not walk stay
// zero because the wrapper allocates d_rows with torch.zeros.
// Left for later work: the per-field shuffles of a slot could be packed, and
// deep tiles could be split across CTAs.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false -shared.
// No --use_fast_math and no fused multiply-adds, as for the forward: the
// replay must take the forward's branches at the 1/255 and 1e-4 thresholds.

#include <cuda_runtime.h>

namespace {

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

// rows: [P, n_fields] f32 = mean2d x/y, conic a/b/c, opacity, payload (C).
// counts/tstart/toff: [T] int32. accum/g_accum: [T, C, 256];
// t_final/g_t: [T, 256]. d_rows: [P, n_fields], zeroed by the caller.
__global__ void __launch_bounds__(kPix)
blend_stream_bwd_kernel(const float* __restrict__ rows, int n_fields,
                        const int* __restrict__ counts,
                        const int* __restrict__ tstart,
                        const int* __restrict__ toff, int grid_x, int chunk,
                        const float* __restrict__ accum,
                        const float* __restrict__ t_final,
                        const float* __restrict__ g_accum,
                        const float* __restrict__ g_t,
                        float* __restrict__ d_rows) {
  extern __shared__ float smem[];
  float* srow = smem;                       // [chunk, n_fields]
  float* part = smem + chunk * n_fields;    // [kWarps, chunk, n_fields]
  const int t = blockIdx.x;
  const int lane = threadIdx.x;
  const int warp = lane / 32;
  const int wl = lane % 32;
  const int C = n_fields - 6;
  const int cnt = counts[t];
  const long long start = tstart[t];
  const int tile = toff[t];
  // integer pixel coordinates (rasterize_pallas.py:_pixels), not +0.5
  const float px = static_cast<float>((tile % grid_x) * kTile + lane % kTile);
  const float py = static_cast<float>((tile / grid_x) * kTile + lane / kTile);

  const long long pix = static_cast<long long>(t) * kPix + lane;
  const long long cbase = static_cast<long long>(t) * C * kPix + lane;
  float gacc[kMaxC];
  float ga_total = 0.0f;
#pragma unroll
  for (int c = 0; c < kMaxC; ++c) {
    gacc[c] = 0.0f;
    if (c < C) {
      gacc[c] = g_accum[cbase + c * kPix];
      const float term = gacc[c] * accum[cbase + c * kPix];
      ga_total = c == 0 ? term : ga_total + term;
    }
  }
  const float gtt = g_t[pix] * t_final[pix];

  float T = 1.0f;
  float bacc = 0.0f;
  int done = 0;
  for (int base = 0; base < cnt; base += chunk) {
    // Every pixel stopped: the rest of the run gets no gradient. This is
    // also the barrier that keeps the staging below from overwriting rows
    // and partials the previous chunk is still reading.
    if (__syncthreads_and(done)) break;
    const int n = min(chunk, cnt - base);
    const float* src = rows + (start + base) * n_fields;
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
    float* dst = d_rows + (start + base) * n_fields;
    for (int i = lane; i < n * n_fields; i += kPix) {
      float s = part[i];
      for (int w = 1; w < kWarps; ++w) s = s + part[w * chunk * n_fields + i];
      dst[i] = s;
    }
  }
}

}  // namespace

extern "C" {

// Launches on `stream` and returns the first CUDA error (0 on success).
int og_blend_stream_bwd(const float* rows, int n_fields, const int* counts,
                        const int* tstart, const int* toff, int n_tiles,
                        int grid_x, int chunk, const float* accum,
                        const float* t_final, const float* g_accum,
                        const float* g_t, float* d_rows, void* stream) {
  if (n_tiles > 0) {
    const size_t smem =
        static_cast<size_t>(1 + kWarps) * chunk * n_fields * sizeof(float);
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          blend_stream_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    blend_stream_bwd_kernel<<<n_tiles, kPix, smem,
                              static_cast<cudaStream_t>(stream)>>>(
        rows, n_fields, counts, tstart, toff, grid_x, chunk, accum, t_final,
        g_accum, g_t, d_rows);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
