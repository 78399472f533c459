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
// The walk itself is blend_tile.cuh:blend_run_fwd, which the dense-block
// forward (blend_tiles_fwd.cu, K5) shares.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false -shared.
// No --use_fast_math: expf near the 1/255 and 1e-4 thresholds must round as
// in the plain PyTorch version, and -fmad=false keeps every multiply and add
// rounded separately, as PyTorch's elementwise operations round them.

#include <cuda_runtime.h>

#include "blend_tile.cuh"

namespace {

using og_blend::kPix;

// rows: [P, n_fields] f32 = mean2d x/y, conic a/b/c, opacity, payload (C).
// counts/tstart/toff: [T] int32. accum: [T, C, 256], t_final: [T, 256].
__global__ void __launch_bounds__(kPix)
blend_stream_fwd_kernel(const float* __restrict__ rows, int n_fields,
                        const int* __restrict__ counts,
                        const int* __restrict__ tstart,
                        const int* __restrict__ toff, int grid_x, int chunk,
                        float* __restrict__ accum,
                        float* __restrict__ t_final) {
  const long long t = blockIdx.x;
  const long long C = n_fields - 6;
  og_blend::blend_run_fwd(rows + tstart[t] * static_cast<long long>(n_fields),
                          n_fields, counts[t], toff[t], grid_x, chunk,
                          accum + t * C * kPix, t_final + t * kPix);
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
