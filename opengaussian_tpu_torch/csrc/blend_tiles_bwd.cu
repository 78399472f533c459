// Backward of the dense-block blend: per-slot gradient rows by front-to-back
// replay, d_slot [T, K, 6 + C].
//
// Replaces: opengaussian_tpu/ops/rasterize_pallas.py:blend_tiles_pallas_bwd
// (the Pallas call at line 413; kernel _bwd_kernel/_bwd_tile, math
// _chunk_blend_math + _chunk_grad_rows). Tile t replays its run, rows
// [t * K, t * K + counts[t]) of the block, with the stream backward's
// suffix form (blend_tile.cuh:blend_run_bwd, shared with K2,
// blend_stream_bwd.cu), and writes slot k's gradient row (dmean2d 2, dconic
// 3, dopacity 1, dpayload C) at d_slot[t, k]. Rows past counts[t], and rows
// after every pixel of the tile stopped, stay as the caller zeroed them, so
// the per-splat reduce sums exact zeros there. Pixels are those of image tile
// t + tile_offset.
//
// Bound on an H100: as for K2: ~24 fp32 operations per (slot, pixel) pair in
// the slot's cull box, +3 past 1/255 and ~4C + 36 per pair that composites
// (chip_smoke.py:ops_grad), against one live row read and one written. What
// the design does about that bound: one CTA per tile, one thread per pixel,
// each chunk staged once in shared memory with a cull box per slot, so a
// warp whose pixels all lie outside a slot's box skips it; per slot a
// reduce-scatter butterfly over its fields and then the 8 warps' partials
// in fixed order (no atomics, so the rows repeat bit for bit and match the
// plain version's order); a warp in which no pixel composites a slot skips
// the butterfly; the CTA stops when every pixel has (the walk K2 shares,
// blend_tile.cuh:blend_run_bwd). The TPU kernel's GROUP unroll and lane
// padding are not carried over.
// Left for later work: TMA bulk copies of the fixed-stride chunks, and a d_slot that holds only the live rows
// (the zero fill of the whole block costs a write of T * K * F floats per
// step; PERF.md).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false -shared
// (no --use_fast_math and no fused multiply-adds: the replay must take the
// forward's branches at the 1/255 and 1e-4 thresholds).

#include <cuda_runtime.h>

#include "blend_tile.cuh"

namespace {

using og_blend::kPix;

// gdata: [T, K, n_fields] f32. counts: [T] int32, clamped at K here.
// accum/g_accum: [T, C, 256]; t_final/g_t: [T, 256].
// d_slot: [T, K, n_fields], zeroed by the caller.
template <int NV>
__global__ void __launch_bounds__(kPix, og_blend::bwd_min_blocks(NV))
blend_tiles_bwd_kernel(const float* __restrict__ gdata, int K, int n_fields,
                       const int* __restrict__ counts, int tile_offset,
                       int grid_x, int chunk, const float* __restrict__ accum,
                       const float* __restrict__ t_final,
                       const float* __restrict__ g_accum,
                       const float* __restrict__ g_t,
                       float* __restrict__ d_slot) {
  const long long t = blockIdx.x;
  const long long C = n_fields - 6;
  const long long start = t * K * n_fields;
  const int cnt = min(counts[t], K);
  og_blend::blend_run_bwd<NV>(gdata + start, n_fields, cnt,
                              static_cast<int>(t) + tile_offset, grid_x, chunk,
                              accum + t * C * kPix, t_final + t * kPix,
                              g_accum + t * C * kPix, g_t + t * kPix,
                              d_slot + start);
}

template <int NV>
cudaError_t launch(const float* gdata, int n_tiles, int K, int n_fields,
                   const int* counts, int tile_offset, int grid_x, int chunk,
                   const float* accum, const float* t_final,
                   const float* g_accum, const float* g_t, float* d_slot,
                   cudaStream_t stream) {
  const size_t smem = og_blend::bwd_smem_bytes(chunk, n_fields);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        blend_tiles_bwd_kernel<NV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  blend_tiles_bwd_kernel<NV><<<n_tiles, kPix, smem, stream>>>(
      gdata, K, n_fields, counts, tile_offset, grid_x, chunk, accum, t_final,
      g_accum, g_t, d_slot);
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Launches on `stream` and returns the first CUDA error (0 on success).
int og_blend_tiles_bwd(const float* gdata, int n_tiles, int K, int n_fields,
                       const int* counts, int tile_offset, int grid_x,
                       int chunk, const float* accum, const float* t_final,
                       const float* g_accum, const float* g_t, float* d_slot,
                       void* stream) {
  if (n_tiles > 0) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const cudaError_t err =
        n_fields <= 16
            ? launch<16>(gdata, n_tiles, K, n_fields, counts, tile_offset,
                         grid_x, chunk, accum, t_final, g_accum, g_t, d_slot, s)
            : launch<32>(gdata, n_tiles, K, n_fields, counts, tile_offset,
                         grid_x, chunk, accum, t_final, g_accum, g_t, d_slot,
                         s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
