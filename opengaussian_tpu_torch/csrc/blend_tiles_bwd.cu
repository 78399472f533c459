// Backward of the dense-block blend: per-slot gradient rows by front-to-back
// replay, written at the slots' positions in the sorted slot stream.
//
// Replaces: opengaussian_tpu/ops/rasterize_pallas.py:blend_tiles_pallas_bwd
// (the Pallas call at line 413; kernel _bwd_kernel/_bwd_tile, math
// _chunk_blend_math + _chunk_grad_rows). Tile t replays its run, rows
// [t * K, t * K + counts[t]) of the block, with the stream backward's
// suffix form (blend_tile.cuh:blend_run_bwd, shared with K2,
// blend_stream_bwd.cu), and writes slot k's gradient row (dmean2d 2, dconic
// 3, dopacity 1, dpayload C) at row tstart[t] + k of d_rows [P, 6 + C]: the
// stream position the dense layout gathered the slot from, which is K2's
// output on the same frame, bit for bit. The TPU kernel writes a
// [T, K, 6 + C] block; its rows past counts[t] are zero and only the live
// rows reach the per-splat sum, so this kernel writes the live rows alone
// and the per-splat reduce (segment_reduce.cu, K3) reads P rows with the
// stream's ids, not T * K. Rows no walk reaches (past counts[t], past the
// last tile, after every pixel of a tile stopped) stay as the caller zeroed
// them. Pixels are those of image tile t + tile_offset.
//
// Bound on an H100: as for K2: ~24 fp32 operations per (slot, pixel) pair in
// the slot's cull box, +3 past 1/255 and ~4C + 36 per pair that composites
// (chip_smoke.py:ops_grad), against one live row read and one written. What
// the design does about that bound: K2's walk (blend_tile.cuh:blend_run_bwd):
// one CTA per tile, one thread per pixel, the warp cull (one bit per warp
// and slot from ballots on the staged slots' boxes; a warp walks only its
// set bits), a reduce-scatter butterfly per slot and the set warps'
// partials in fixed order (no atomics, so the rows repeat bit for bit and
// match the plain version's order), the early stop. The block's fixed
// stride makes chunk `base` of tile t the chunk * F * 4 contiguous bytes at
// (t K + base) F * 4, 16-byte aligned when chunk % 4 == 0 and gdata is:
// such a chunk arrives by one bulk copy (cp.async.bulk on an mbarrier per
// buffer), issued by one thread while the CTA walks the previous chunk. A
// block that is not aligned, or a chunk that is not a multiple of 4, takes
// the 4-byte cp.async path of the stream kernels, inside this kernel. The
// TPU kernel's GROUP unroll and lane padding are not carried over.
// Left for later work: the reduce fused into the walk's epilogue.
//
// The group entry (og_blend_tiles_bwd_groups) replays the group entry of
// the forward (blend_tiles_fwd.cu): CTA (t, g) walks tile t's rows with the
// opacity of group g, opac_g[g, gauss_idx[t, k]], and writes slot k's row
// at row g P + tstart[t] + k of d_rows [G, P, 6 + C]: K6's output on the
// block whose opacity column is the group's, one [P, 6 + C] slab per group.
// The caller reduces the G P rows with ids g n + sorted_gauss, so the
// opacity gradient stays per group and the others sum over the groups.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false -shared
// (no --use_fast_math and no fused multiply-adds: the replay must take the
// forward's branches at the 1/255 and 1e-4 thresholds).

#include <cuda_runtime.h>

#include "blend_tile.cuh"

namespace {

using og_blend::kPix;

// gdata: [T, K, n_fields] f32. counts: [T] int32, clamped at K here.
// tstart: [T] int32, the stream position of each tile's first slot.
// accum/g_accum: [T, C, 256]; t_final/g_t: [T, 256].
// d_rows: [P, n_fields], zeroed by the caller.
template <int KC, bool kBulk>
__global__ void __launch_bounds__(kPix, og_blend::bwd_min_blocks(KC))
blend_tiles_bwd_kernel(const float* __restrict__ gdata, int K, int n_fields,
                       const int* __restrict__ counts,
                       const int* __restrict__ tstart, int tile_offset,
                       int grid_x, int chunk, const float* __restrict__ accum,
                       const float* __restrict__ t_final,
                       const float* __restrict__ g_accum,
                       const float* __restrict__ g_t,
                       float* __restrict__ d_rows) {
  const long long t = blockIdx.x;
  const long long C = n_fields - 6;
  og_blend::blend_run_bwd<KC, kBulk>(
      gdata + t * K * n_fields, n_fields, min(counts[t], K),
      static_cast<int>(t) + tile_offset, grid_x, chunk, accum + t * C * kPix,
      t_final + t * kPix, g_accum + t * C * kPix, g_t + t * kPix,
      d_rows + static_cast<long long>(tstart[t]) * n_fields);
}

// The group entry's kernel: blockIdx.y is the group. gauss_idx: [T, K]
// int32 splat ids of the block's rows; opac_g: [G, n_splats] f32; d_rows:
// [G, n_rows, n_fields], zeroed by the caller.
template <int KC, bool kBulk>
__global__ void __launch_bounds__(kPix, og_blend::bwd_min_blocks(KC))
blend_tiles_bwd_groups_kernel(
    const float* __restrict__ gdata, int K, int n_fields,
    const int* __restrict__ counts, const int* __restrict__ tstart,
    const int* __restrict__ gauss_idx, const float* __restrict__ opac_g,
    int n_splats, int n_rows, int tile_offset, int grid_x, int chunk,
    const float* __restrict__ accum, const float* __restrict__ t_final,
    const float* __restrict__ g_accum, const float* __restrict__ g_t,
    float* __restrict__ d_rows) {
  const long long t = blockIdx.x;
  const long long g = blockIdx.y;
  const long long gt = g * gridDim.x + t;
  const long long C = n_fields - 6;
  og_blend::blend_run_bwd<KC, kBulk, true>(
      gdata + t * K * n_fields, n_fields, min(counts[t], K),
      static_cast<int>(t) + tile_offset, grid_x, chunk, accum + gt * C * kPix,
      t_final + gt * kPix, g_accum + gt * C * kPix, g_t + gt * kPix,
      d_rows + (g * n_rows + tstart[t]) * n_fields, gauss_idx + t * K,
      opac_g + g * n_splats);
}

template <int KC, bool kBulk>
cudaError_t launch(const float* gdata, int n_tiles, int K, int n_fields,
                   const int* counts, const int* tstart, int tile_offset,
                   int grid_x, int chunk, const float* accum,
                   const float* t_final, const float* g_accum, const float* g_t,
                   float* d_rows, cudaStream_t stream) {
  const size_t smem = og_blend::bwd_smem_bytes(chunk, n_fields);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        blend_tiles_bwd_kernel<KC, kBulk>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  blend_tiles_bwd_kernel<KC, kBulk><<<n_tiles, kPix, smem, stream>>>(
      gdata, K, n_fields, counts, tstart, tile_offset, grid_x, chunk, accum,
      t_final, g_accum, g_t, d_rows);
  return cudaSuccess;
}

template <bool kBulk>
cudaError_t launch_by_channels(const float* gdata, int n_tiles, int K,
                               int n_fields, const int* counts,
                               const int* tstart, int tile_offset, int grid_x,
                               int chunk, const float* accum,
                               const float* t_final, const float* g_accum,
                               const float* g_t, float* d_rows,
                               cudaStream_t stream) {
  switch (og_blend::bwd_channels(n_fields - 6)) {
    case 4:
      return launch<4, kBulk>(gdata, n_tiles, K, n_fields, counts, tstart,
                              tile_offset, grid_x, chunk, accum, t_final,
                              g_accum, g_t, d_rows, stream);
    case 8:
      return launch<8, kBulk>(gdata, n_tiles, K, n_fields, counts, tstart,
                              tile_offset, grid_x, chunk, accum, t_final,
                              g_accum, g_t, d_rows, stream);
    case 10:
      return launch<10, kBulk>(gdata, n_tiles, K, n_fields, counts, tstart,
                               tile_offset, grid_x, chunk, accum, t_final,
                               g_accum, g_t, d_rows, stream);
    default:
      return launch<og_blend::kMaxC, kBulk>(gdata, n_tiles, K, n_fields,
                                            counts, tstart, tile_offset,
                                            grid_x, chunk, accum, t_final,
                                            g_accum, g_t, d_rows, stream);
  }
}

template <int KC, bool kBulk>
cudaError_t launch_groups(const float* gdata, int n_tiles, int K, int n_fields,
                          const int* counts, const int* tstart,
                          const int* gauss_idx, const float* opac_g,
                          int n_groups, int n_splats, int n_rows,
                          int tile_offset, int grid_x, int chunk,
                          const float* accum, const float* t_final,
                          const float* g_accum, const float* g_t,
                          float* d_rows, cudaStream_t stream) {
  const size_t smem = og_blend::bwd_smem_bytes(chunk, n_fields);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        blend_tiles_bwd_groups_kernel<KC, kBulk>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  blend_tiles_bwd_groups_kernel<KC, kBulk>
      <<<dim3(n_tiles, n_groups), kPix, smem, stream>>>(
          gdata, K, n_fields, counts, tstart, gauss_idx, opac_g, n_splats,
          n_rows, tile_offset, grid_x, chunk, accum, t_final, g_accum, g_t,
          d_rows);
  return cudaSuccess;
}

template <bool kBulk>
cudaError_t launch_groups_by_channels(
    const float* gdata, int n_tiles, int K, int n_fields, const int* counts,
    const int* tstart, const int* gauss_idx, const float* opac_g,
    int n_groups, int n_splats, int n_rows, int tile_offset, int grid_x,
    int chunk, const float* accum, const float* t_final, const float* g_accum,
    const float* g_t, float* d_rows, cudaStream_t stream) {
#define OG_GROUPS_ARGS                                                      \
  gdata, n_tiles, K, n_fields, counts, tstart, gauss_idx, opac_g, n_groups, \
      n_splats, n_rows, tile_offset, grid_x, chunk, accum, t_final, g_accum, \
      g_t, d_rows, stream
  switch (og_blend::bwd_channels(n_fields - 6)) {
    case 4:
      return launch_groups<4, kBulk>(OG_GROUPS_ARGS);
    case 8:
      return launch_groups<8, kBulk>(OG_GROUPS_ARGS);
    case 10:
      return launch_groups<10, kBulk>(OG_GROUPS_ARGS);
    default:
      return launch_groups<og_blend::kMaxC, kBulk>(OG_GROUPS_ARGS);
  }
#undef OG_GROUPS_ARGS
}

// Whether the block's chunks can arrive by bulk copy (as in
// blend_tiles_fwd.cu): with chunk % 4 == 0 (K is a multiple of chunk) every
// chunk starts and, rounded up to 4 rows, ends on a 16-byte boundary when
// gdata does.
bool bulk_ok(const float* gdata, int chunk) {
  return chunk % 4 == 0 && reinterpret_cast<size_t>(gdata) % 16 == 0;
}

}  // namespace

extern "C" {

// Launches on `stream` and returns the first CUDA error (0 on success).
int og_blend_tiles_bwd(const float* gdata, int n_tiles, int K, int n_fields,
                       const int* counts, const int* tstart, int tile_offset,
                       int grid_x, int chunk, const float* accum,
                       const float* t_final, const float* g_accum,
                       const float* g_t, float* d_rows, void* stream) {
  if (n_tiles > 0) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const cudaError_t err =
        bulk_ok(gdata, chunk)
            ? launch_by_channels<true>(gdata, n_tiles, K, n_fields, counts,
                                       tstart, tile_offset, grid_x, chunk,
                                       accum, t_final, g_accum, g_t, d_rows, s)
            : launch_by_channels<false>(gdata, n_tiles, K, n_fields, counts,
                                        tstart, tile_offset, grid_x, chunk,
                                        accum, t_final, g_accum, g_t, d_rows,
                                        s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

// The group entry: d_rows [G, n_rows, n_fields], zeroed by the caller.
// Launches on `stream` and returns the first CUDA error (0 on success).
int og_blend_tiles_bwd_groups(const float* gdata, int n_tiles, int K,
                              int n_fields, const int* counts,
                              const int* tstart, const int* gauss_idx,
                              const float* opac_g, int n_groups, int n_splats,
                              int n_rows, int tile_offset, int grid_x,
                              int chunk, const float* accum,
                              const float* t_final, const float* g_accum,
                              const float* g_t, float* d_rows, void* stream) {
  if (n_tiles > 0 && n_groups > 0) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const cudaError_t err =
        bulk_ok(gdata, chunk)
            ? launch_groups_by_channels<true>(
                  gdata, n_tiles, K, n_fields, counts, tstart, gauss_idx,
                  opac_g, n_groups, n_splats, n_rows, tile_offset, grid_x,
                  chunk, accum, t_final, g_accum, g_t, d_rows, s)
            : launch_groups_by_channels<false>(
                  gdata, n_tiles, K, n_fields, counts, tstart, gauss_idx,
                  opac_g, n_groups, n_splats, n_rows, tile_offset, grid_x,
                  chunk, accum, t_final, g_accum, g_t, d_rows, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
