// Forward alpha blend over the (tile, depth)-sorted slot stream.
//
// Replaces: opengaussian_tpu/ops/rasterize_pallas.py:blend_stream_pallas_fwd
// (the Pallas call at line 562; kernel _fwd_stream_kernel, math
// _chunk_blend_math). Same semantics (ops/blend.py): per pixel, walk the
// tile's run front to back; alpha = min(0.99, o * exp(power)) with alpha = 0
// where power > 0; skip alpha < 1/255; a slot composites only while the
// transmittance after it stays >= 1e-4, and the first slot that would take
// it below stops the pixel for good.
//
// Bound on an H100: operations. A (slot, pixel) pair costs ~24 fp32
// operations to evaluate (the quadratic form, one expf, the threshold
// tests); a pair that passes 1/255 adds 3 (the transmittance test) and one
// that composites 1 + 2C more. Against ~44 bytes read per slot for a whole
// 256-pixel tile, the fp32 issue rate, not the 3.35 TB/s of HBM, is the
// floor. On the 1296x968 frame with 200k splats a pass evaluates 102M pairs,
// of which 11M pass 1/255 and composite: 0.039 ms per launch at 67 TFLOP/s
// fp32 (H100 SXM, 700 W). This kernel takes 0.27 ms there, 14% of that
// bound (chip_smoke.py; PERF.md). The design does about that bound:
//   * one CTA per 16x16 tile and one thread per pixel, so every live pair is
//     evaluated exactly once and nothing is recomputed;
//   * the tile's run is staged chunk by chunk into shared memory with
//     coalesced loads; each staged row is then read by all 256 threads as a
//     shared-memory broadcast, so device memory sees each slot once;
//   * the CTA stops as soon as every pixel has stopped (__syncthreads_and on
//     the done flags), or when the run ends: it walks counts[t] slots, never
//     a fixed padded window.
// Left for later work: warp-level culling of slots no pixel of the warp
// touches, and load balance for very deep tiles.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false -shared.
// No --use_fast_math: expf near the 1/255 and 1e-4 thresholds must round as
// in the plain PyTorch version, and -fmad=false keeps every multiply and add
// rounded separately, as PyTorch's elementwise operations round them.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;
constexpr int kPix = kTile * kTile;  // threads per CTA: one per pixel
constexpr int kMaxC = 16;  // payload channels one thread accumulates (MAX_C)

// opengaussian_tpu/ops/blend.py, rounded to float as the JAX package does
constexpr float kAlphaMin = static_cast<float>(1.0 / 255.0);
constexpr float kAlphaMax = 0.99f;
constexpr float kTEps = 1e-4f;

// rows: [P, n_fields] f32 = mean2d x/y, conic a/b/c, opacity, payload (C).
// counts/tstart/toff: [T] int32. accum: [T, C, 256], t_final: [T, 256].
__global__ void __launch_bounds__(kPix)
blend_stream_fwd_kernel(const float* __restrict__ rows, int n_fields,
                        const int* __restrict__ counts,
                        const int* __restrict__ tstart,
                        const int* __restrict__ toff, int grid_x, int chunk,
                        float* __restrict__ accum,
                        float* __restrict__ t_final) {
  extern __shared__ float srow[];  // [chunk, n_fields]
  const int t = blockIdx.x;
  const int lane = threadIdx.x;
  const int C = n_fields - 6;
  const int cnt = counts[t];
  const long long start = tstart[t];
  const int tile = toff[t];
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
    const float* src = rows + (start + base) * n_fields;
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

  float* out = accum + static_cast<long long>(t) * C * kPix + lane;
#pragma unroll
  for (int c = 0; c < kMaxC; ++c)
    if (c < C) out[c * kPix] = acc[c];
  t_final[static_cast<long long>(t) * kPix + lane] = T;
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 on success).
int og_blend_stream_fwd(const float* rows, int n_fields, const int* counts,
                        const int* tstart, const int* toff, int n_tiles,
                        int grid_x, int chunk, float* accum, float* t_final,
                        void* stream) {
  if (n_tiles > 0) {
    const size_t smem = static_cast<size_t>(chunk) * n_fields * sizeof(float);
    blend_stream_fwd_kernel<<<n_tiles, kPix, smem,
                              static_cast<cudaStream_t>(stream)>>>(
        rows, n_fields, counts, tstart, toff, grid_x, chunk, accum, t_final);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
