// Backward of the stream blend into chunk-compacted rows, with the splat ids.
//
// Replaces: opengaussian_tpu/ops/rasterize_pallas.py:blend_stream_pallas_bwd_compact
// (the Pallas call at line 841; kernel _bwd_stream_compact_kernel 696, math
// _chunk_blend_math + _chunk_grad_rows). Tile t owns ceil(counts[t] / chunk)
// chunks of the output, starting at chunk cstart[t] (the exclusive cumsum of
// those chunk counts, so the tiles' ranges are disjoint and cover the output
// with no gap). Its replay is K2's (blend_tile.cuh:blend_run_bwd, shared
// with blend_stream_bwd.cu and blend_tiles_bwd.cu), so row k of the tile's
// range is bit for bit K2's row for the tile's k-th slot. Every row the
// tile owns is written:
//   * d_rows: the walk's rows as in K2; zeros for the live rows after every
//     pixel of the tile stopped (their gradient is exactly zero, as the JAX
//     kernel's zero-write at rasterize_pallas.py:780-790 says) and for the
//     tail k >= counts[t] of the last chunk;
//   * ids: sorted_gauss[tstart[t] + k] for k < counts[t], else n_splats,
//     which the per-splat reduce (segment_reduce.cu, K3) drops.
// So the wrapper allocates both with torch.empty, and the output holds no
// rows of tiles that are past the last tile or truncated: no budget tail,
// no f32 id column, no 2^24 limit.
//
// Bound on an H100: operations, as for K2 (~24 fp32 operations per
// evaluated (slot, pixel) pair, +3 past 1/255 and ~4C + 36 per pair that
// composites; chip_smoke.py:ops_grad), against one live row read and one
// row and one id written per owned slot. What the design does about that
// bound: one CTA per tile, one thread per pixel, each chunk staged once in
// shared memory; per slot a warp shuffle tree, then the 8 warps' partials
// in fixed order (no atomics, rows repeat bit for bit); a warp in which no
// pixel composites a slot skips its shuffles; the CTA stops when every
// pixel has. The id and zero writes are coalesced strided loops over the
// tile's own range: the ids and the last chunk's tail before the walk, the
// rows past the early stop after it. The TPU kernel's double-buffered write
// DMAs and lane padding are not carried over: the walk's epilogue writes
// each chunk's rows straight to their compacted place.
// Left for later work: what K2 leaves (packed per-slot shuffles, splitting
// deep tiles across CTAs), and the reduce fused into the epilogue.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false -shared
// (no --use_fast_math and no fused multiply-adds: the replay must take the
// forward's branches at the 1/255 and 1e-4 thresholds).

#include <cuda_runtime.h>

#include "blend_tile.cuh"

namespace {

using og_blend::kPix;

// rows: [P, n_fields] f32 = mean2d x/y, conic a/b/c, opacity, payload (C).
// counts/tstart/toff/cstart: [T] int32; sorted_gauss: [P] int32.
// accum/g_accum: [T, C, 256]; t_final/g_t: [T, 256].
// d_rows: [NC * chunk, n_fields]; ids: [NC * chunk], NC = sum of the chunks.
__global__ void __launch_bounds__(kPix)
blend_stream_bwd_compact_kernel(const float* __restrict__ rows, int n_fields,
                                const int* __restrict__ counts,
                                const int* __restrict__ tstart,
                                const int* __restrict__ toff,
                                const int* __restrict__ cstart,
                                const int* __restrict__ sorted_gauss,
                                int grid_x, int chunk, int n_splats,
                                const float* __restrict__ accum,
                                const float* __restrict__ t_final,
                                const float* __restrict__ g_accum,
                                const float* __restrict__ g_t,
                                float* __restrict__ d_rows,
                                int* __restrict__ ids) {
  const long long t = blockIdx.x;
  const long long C = n_fields - 6;
  const int cnt = counts[t];
  const long long dst = static_cast<long long>(cstart[t]) * chunk;
  float* out = d_rows + dst * n_fields;
  {
    // the ids and the last chunk's tail first: they do not depend on the
    // walk, and nothing of them stays live across it (K2's registers)
    const int owned = (cnt + chunk - 1) / chunk * chunk;
    const int* gauss = sorted_gauss + tstart[t];
    for (int k = threadIdx.x; k < owned; k += kPix)
      ids[dst + k] = k < cnt ? gauss[k] : n_splats;
    for (int i = cnt * n_fields + threadIdx.x; i < owned * n_fields; i += kPix)
      out[i] = 0.0f;
  }
  const int walked = og_blend::blend_run_bwd(
      rows + static_cast<long long>(tstart[t]) * n_fields, n_fields, cnt, toff[t],
      grid_x, chunk, accum + t * C * kPix, t_final + t * kPix,
      g_accum + t * C * kPix, g_t + t * kPix, out);
  // the live rows after every pixel stopped: their gradient is zero
  for (int i = walked * n_fields + threadIdx.x; i < cnt * n_fields; i += kPix)
    out[i] = 0.0f;
}

}  // namespace

extern "C" {

// Launches on `stream` and returns the first CUDA error (0 on success).
int og_blend_stream_bwd_compact(const float* rows, int n_fields,
                                const int* counts, const int* tstart,
                                const int* toff, const int* cstart,
                                const int* sorted_gauss, int n_tiles,
                                int grid_x, int chunk, int n_splats,
                                const float* accum, const float* t_final,
                                const float* g_accum, const float* g_t,
                                float* d_rows, int* ids, void* stream) {
  if (n_tiles > 0) {
    const size_t smem = og_blend::bwd_smem_bytes(chunk, n_fields);
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          blend_stream_bwd_compact_kernel,
          cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    blend_stream_bwd_compact_kernel<<<n_tiles, kPix, smem,
                                      static_cast<cudaStream_t>(stream)>>>(
        rows, n_fields, counts, tstart, toff, cstart, sorted_gauss, grid_x,
        chunk, n_splats, accum, t_final, g_accum, g_t, d_rows, ids);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
