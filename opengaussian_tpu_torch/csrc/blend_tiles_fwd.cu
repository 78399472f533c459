// Forward alpha blend over a dense [T, K, 6 + C] block of gathered rows.
//
// Replaces: opengaussian_tpu/ops/rasterize_pallas.py:blend_tiles_pallas_fwd
// (the Pallas call at line 322; kernel _fwd_kernel, math _chunk_blend_math).
// The dense input layout (RasterizeConfig.pallas_input="dense") gathers each
// tile's depth-ordered run into row t of a [T, K, F] block: row k < counts[t]
// holds the k-th slot's splat; rows past counts[t] hold splat 0 (the index
// matrix is 0 there) and are never read. A dense block is a stream whose tile
// t starts at t * K, so this kernel runs the walk of the stream forward (K1,
// blend_stream_fwd.cu) through the same blend_tile.cuh:blend_run_fwd: the two
// agree bit for bit on the same rows. Pixels are those of image tile
// t + tile_offset.
//
// Bound on an H100: operations, as for K1. A (slot, pixel) pair costs ~24
// fp32 operations to evaluate, +3 past the 1/255 test and 1 + 2C to
// composite, against ~4(6 + C) bytes per live row read once; the block's
// dead rows are never read. chip_smoke.py counts the pairs of the frame's
// data and PERF.md has the numbers. What the design does about that bound:
// one CTA per tile and one thread per pixel, each chunk of rows staged once
// into shared memory and read by all 256 threads as a broadcast, and the CTA
// stops as soon as every pixel has stopped or the run ends (counts[t], not
// K). Nothing of the TPU kernel's layout is kept: no GROUP of tiles per grid
// step and no 128-lane padding.
// Left for later work: the fixed stride of the block lets a chunk's
// chunk * F * 4 contiguous bytes arrive by one TMA bulk copy.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false -shared
// (no --use_fast_math; see blend_stream_fwd.cu).

#include <cuda_runtime.h>

#include "blend_tile.cuh"

namespace {

using og_blend::kPix;

// gdata: [T, K, n_fields] f32. counts: [T] int32, clamped at K here.
// accum: [T, C, 256], t_final: [T, 256].
__global__ void __launch_bounds__(kPix)
blend_tiles_fwd_kernel(const float* __restrict__ gdata, int K, int n_fields,
                       const int* __restrict__ counts, int tile_offset,
                       int grid_x, int chunk, float* __restrict__ accum,
                       float* __restrict__ t_final) {
  const long long t = blockIdx.x;
  const long long C = n_fields - 6;
  og_blend::blend_run_fwd(gdata + t * K * n_fields, n_fields,
                          min(counts[t], K), static_cast<int>(t) + tile_offset,
                          grid_x, chunk, accum + t * C * kPix,
                          t_final + t * kPix);
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 on success).
int og_blend_tiles_fwd(const float* gdata, int n_tiles, int K, int n_fields,
                       const int* counts, int tile_offset, int grid_x,
                       int chunk, float* accum, float* t_final, void* stream) {
  if (n_tiles > 0) {
    const size_t smem = static_cast<size_t>(chunk) * n_fields * sizeof(float);
    blend_tiles_fwd_kernel<<<n_tiles, kPix, smem,
                             static_cast<cudaStream_t>(stream)>>>(
        gdata, K, n_fields, counts, tile_offset, grid_x, chunk, accum,
        t_final);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
