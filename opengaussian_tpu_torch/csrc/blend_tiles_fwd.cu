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
// Bound on an H100: operations or bytes, as for K1: ~24 fp32 operations per
// (slot, pixel) pair whose warp meets the slot's cull box, +3 past the 1/255
// test and 1 + 2C to composite, a box per staged slot and a box test per
// warp, against 4(6 + C) bytes per live row read once; the block's dead
// rows are never read. On the [4941, 1024, 13] feature-pass block of the
// 1296x968 render frame the bound is 0.0183 ms (bytes), and the kernel
// without the cull and the bulk copies took 0.2676 ms ("NVIDIA H100 80GB
// HBM3, 700.00 W"; chip_smoke.py counts the pairs of the frame's data and
// PERF.md has the numbers). What the design does about that bound: K1's
// (blend_stream_fwd.cu): one CTA per tile and one thread per pixel, the warp
// cull, accumulators by channel count, two staging buffers and the early
// stop. The block's fixed stride makes chunk `base` of tile t the
// chunk * F * 4 contiguous bytes at (t K + base) F * 4, 16-byte aligned when
// chunk % 4 == 0 and gdata is: such a chunk arrives by one bulk copy (the
// TMA's 1-D form, cp.async.bulk, completing on an mbarrier per buffer),
// issued by one thread while the CTA walks the previous chunk. A block that
// is not aligned, or a chunk that is not a multiple of 4, takes the
// element-wise cp.async path of the stream kernel, inside this kernel.
// Nothing of the TPU kernel's layout is kept: no GROUP of tiles per grid
// step and no 128-lane padding.
//
// The group entry (og_blend_tiles_fwd_groups) blends the same block once
// per group of a [G, N] opacity table: the group is a second grid axis, and
// CTA (t, g) walks tile t's rows with each staged row's opacity replaced by
// opac_g[g, gauss_idx[t, k]], read by splat id while the chunk is culled
// (blend_tile.cuh:cull_chunk), so the cull boxes too are the group's. It
// computes, bit for bit, K5 on the block whose opacity column is the
// group's (the JAX package's rasterize_groups vmaps the dense blend over
// the groups' opacities in the same way), without a [G, T, K] opacity
// block. -> accum [G, T, C, 256], t_final [G, T, 256].
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false -shared
// (no --use_fast_math; see blend_stream_fwd.cu).

#include <cuda_runtime.h>

#include "blend_tile.cuh"

namespace {

using og_blend::kPix;

// gdata: [T, K, n_fields] f32. counts: [T] int32, clamped at K here.
// accum: [T, C, 256], t_final: [T, 256].
template <int KC, bool kBulk>
__global__ void __launch_bounds__(kPix, og_blend::fwd_min_blocks(KC))
blend_tiles_fwd_kernel(const float* __restrict__ gdata, int K, int n_fields,
                       const int* __restrict__ counts, int tile_offset,
                       int grid_x, int chunk, float* __restrict__ accum,
                       float* __restrict__ t_final) {
  const long long t = blockIdx.x;
  const long long C = n_fields - 6;
  og_blend::blend_run_fwd<KC, kBulk>(
      gdata + t * K * n_fields, n_fields, min(counts[t], K),
      static_cast<int>(t) + tile_offset, grid_x, chunk, accum + t * C * kPix,
      t_final + t * kPix);
}

// The group entry's kernel: blockIdx.y is the group. gauss_idx: [T, K]
// int32 splat ids of the block's rows; opac_g: [G, n_splats] f32.
template <int KC, bool kBulk>
__global__ void __launch_bounds__(kPix, og_blend::fwd_min_blocks(KC))
blend_tiles_fwd_groups_kernel(const float* __restrict__ gdata, int K,
                              int n_fields, const int* __restrict__ counts,
                              const int* __restrict__ gauss_idx,
                              const float* __restrict__ opac_g, int n_splats,
                              int tile_offset, int grid_x, int chunk,
                              float* __restrict__ accum,
                              float* __restrict__ t_final) {
  const long long t = blockIdx.x;
  const long long gt = static_cast<long long>(blockIdx.y) * gridDim.x + t;
  const long long C = n_fields - 6;
  og_blend::blend_run_fwd<KC, kBulk, true>(
      gdata + t * K * n_fields, n_fields, min(counts[t], K),
      static_cast<int>(t) + tile_offset, grid_x, chunk, accum + gt * C * kPix,
      t_final + gt * kPix, gauss_idx + t * K,
      opac_g + static_cast<long long>(blockIdx.y) * n_splats);
}

template <int KC, bool kBulk>
cudaError_t launch(const float* gdata, int n_tiles, int K, int n_fields,
                   const int* counts, int tile_offset, int grid_x, int chunk,
                   float* accum, float* t_final, cudaStream_t stream) {
  const size_t smem = og_blend::fwd_smem_bytes(chunk, n_fields);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        blend_tiles_fwd_kernel<KC, kBulk>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  blend_tiles_fwd_kernel<KC, kBulk><<<n_tiles, kPix, smem, stream>>>(
      gdata, K, n_fields, counts, tile_offset, grid_x, chunk, accum, t_final);
  return cudaSuccess;
}

template <bool kBulk>
cudaError_t launch_by_channels(const float* gdata, int n_tiles, int K,
                               int n_fields, const int* counts,
                               int tile_offset, int grid_x, int chunk,
                               float* accum, float* t_final,
                               cudaStream_t stream) {
  switch (og_blend::fwd_channels(n_fields - 6)) {
    case 4:
      return launch<4, kBulk>(gdata, n_tiles, K, n_fields, counts, tile_offset,
                              grid_x, chunk, accum, t_final, stream);
    case 8:
      return launch<8, kBulk>(gdata, n_tiles, K, n_fields, counts, tile_offset,
                              grid_x, chunk, accum, t_final, stream);
    default:
      return launch<og_blend::kMaxC, kBulk>(gdata, n_tiles, K, n_fields,
                                            counts, tile_offset, grid_x, chunk,
                                            accum, t_final, stream);
  }
}

template <int KC, bool kBulk>
cudaError_t launch_groups(const float* gdata, int n_tiles, int K, int n_fields,
                          const int* counts, const int* gauss_idx,
                          const float* opac_g, int n_groups, int n_splats,
                          int tile_offset, int grid_x, int chunk, float* accum,
                          float* t_final, cudaStream_t stream) {
  const size_t smem = og_blend::fwd_smem_bytes(chunk, n_fields);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        blend_tiles_fwd_groups_kernel<KC, kBulk>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  blend_tiles_fwd_groups_kernel<KC, kBulk>
      <<<dim3(n_tiles, n_groups), kPix, smem, stream>>>(
          gdata, K, n_fields, counts, gauss_idx, opac_g, n_splats, tile_offset,
          grid_x, chunk, accum, t_final);
  return cudaSuccess;
}

template <bool kBulk>
cudaError_t launch_groups_by_channels(const float* gdata, int n_tiles, int K,
                                      int n_fields, const int* counts,
                                      const int* gauss_idx, const float* opac_g,
                                      int n_groups, int n_splats,
                                      int tile_offset, int grid_x, int chunk,
                                      float* accum, float* t_final,
                                      cudaStream_t stream) {
  switch (og_blend::fwd_channels(n_fields - 6)) {
    case 4:
      return launch_groups<4, kBulk>(gdata, n_tiles, K, n_fields, counts,
                                     gauss_idx, opac_g, n_groups, n_splats,
                                     tile_offset, grid_x, chunk, accum,
                                     t_final, stream);
    case 8:
      return launch_groups<8, kBulk>(gdata, n_tiles, K, n_fields, counts,
                                     gauss_idx, opac_g, n_groups, n_splats,
                                     tile_offset, grid_x, chunk, accum,
                                     t_final, stream);
    default:
      return launch_groups<og_blend::kMaxC, kBulk>(
          gdata, n_tiles, K, n_fields, counts, gauss_idx, opac_g, n_groups,
          n_splats, tile_offset, grid_x, chunk, accum, t_final, stream);
  }
}

// Whether the block's chunks can arrive by bulk copy: with chunk % 4 == 0
// (K is a multiple of chunk) every chunk starts and, rounded up to 4 rows,
// ends on a 16-byte boundary when gdata does.
bool bulk_ok(const float* gdata, int chunk) {
  return chunk % 4 == 0 && reinterpret_cast<size_t>(gdata) % 16 == 0;
}

}  // namespace

extern "C" {

// Launches on `stream` and returns the first CUDA error (0 on success).
int og_blend_tiles_fwd(const float* gdata, int n_tiles, int K, int n_fields,
                       const int* counts, int tile_offset, int grid_x,
                       int chunk, float* accum, float* t_final, void* stream) {
  if (n_tiles > 0) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const cudaError_t err =
        bulk_ok(gdata, chunk)
            ? launch_by_channels<true>(gdata, n_tiles, K, n_fields, counts,
                                       tile_offset, grid_x, chunk, accum,
                                       t_final, s)
            : launch_by_channels<false>(gdata, n_tiles, K, n_fields, counts,
                                        tile_offset, grid_x, chunk, accum,
                                        t_final, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

// The group entry: accum [G, T, C, 256], t_final [G, T, 256]. Launches on
// `stream` and returns the first CUDA error (0 on success).
int og_blend_tiles_fwd_groups(const float* gdata, int n_tiles, int K,
                              int n_fields, const int* counts,
                              const int* gauss_idx, const float* opac_g,
                              int n_groups, int n_splats, int tile_offset,
                              int grid_x, int chunk, float* accum,
                              float* t_final, void* stream) {
  if (n_tiles > 0 && n_groups > 0) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const cudaError_t err =
        bulk_ok(gdata, chunk)
            ? launch_groups_by_channels<true>(
                  gdata, n_tiles, K, n_fields, counts, gauss_idx, opac_g,
                  n_groups, n_splats, tile_offset, grid_x, chunk, accum,
                  t_final, s)
            : launch_groups_by_channels<false>(
                  gdata, n_tiles, K, n_fields, counts, gauss_idx, opac_g,
                  n_groups, n_splats, tile_offset, grid_x, chunk, accum,
                  t_final, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
