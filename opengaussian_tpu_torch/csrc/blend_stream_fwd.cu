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
// Bound on an H100: operations or bytes, by the frame. A (slot, pixel) pair
// that must be evaluated (its warp's pixels meet the slot's cull box) costs
// ~24 fp32 operations (the quadratic form, one expf, the threshold tests); a
// pair that passes 1/255 adds 3 (the transmittance test) and one that
// composites 1 + 2C more; each staged slot its box and a box test per warp.
// The kernel reads each live row of 4(6 + C) bytes once and writes accum and
// t_final. On the 1296x968 render frame with 200k splats (102M pairs
// evaluated without the cull, 38M in a box, 11M composited) the bound is
// 0.0162 / 0.0183 ms at C = 4 / 7 (operations / bytes), and the kernel
// without the cull and the asynchronous staging took 0.2711 / 0.2730 ms
// there ("NVIDIA H100 80GB HBM3, 700.00 W"; chip_smoke.py computes the
// bounds from the frame's work counts; PERF.md has the numbers).
// What the design does about that bound (blend_tile.cuh:blend_run_fwd):
//   * one CTA per 16x16 tile and one thread per pixel, so every live pair is
//     evaluated at most once and nothing is recomputed;
//   * a warp cull: each staged slot gets its cull box (slot_box), which
//     ballots turn into one bit per warp, and a warp walks only the slots
//     whose box meets its 16x2 pixels, so the ~63% of a render frame's
//     pairs that cannot pass 1/255 cost it neither an evaluation nor a
//     test; the outputs are bit for bit those of the walk without it;
//   * the run arrives in chunks through two shared-memory buffers by
//     asynchronous copies (4-byte cp.async: a run starts at tstart[t] *
//     (6 + C) floats, 16-byte aligned only by chance), chunk i + 1 in flight
//     while the walk evaluates chunk i; each staged row is read by all 256
//     threads as a shared-memory broadcast, so device memory sees each slot
//     once;
//   * the accumulators a thread holds follow C (4, 8 or 16), so the C = 4
//     color pass keeps 4 in registers, not 16, and more CTAs fit on an SM;
//   * a pixel that stops leaves the walk, and the CTA stops as soon as every
//     pixel has stopped (__syncthreads_and on the done flags), or when the
//     run ends: it walks counts[t] slots, never a fixed padded window.
// A tile's run is not split across CTAs (a split of the backward's deep
// tiles was measured and gave no gain on any frame the port runs; PERF.md).
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
template <int KC>
__global__ void __launch_bounds__(kPix, og_blend::fwd_min_blocks(KC))
blend_stream_fwd_kernel(const float* __restrict__ rows, int n_fields,
                        const int* __restrict__ counts,
                        const int* __restrict__ tstart,
                        const int* __restrict__ toff, int grid_x, int chunk,
                        float* __restrict__ accum,
                        float* __restrict__ t_final) {
  const long long t = blockIdx.x;
  const long long C = n_fields - 6;
  og_blend::blend_run_fwd<KC, false>(
      rows + tstart[t] * static_cast<long long>(n_fields), n_fields, counts[t],
      toff[t], grid_x, chunk, accum + t * C * kPix, t_final + t * kPix);
}

template <int KC>
cudaError_t launch(const float* rows, int n_fields, const int* counts,
                   const int* tstart, const int* toff, int n_tiles, int grid_x,
                   int chunk, float* accum, float* t_final,
                   cudaStream_t stream) {
  const size_t smem = og_blend::fwd_smem_bytes(chunk, n_fields);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        blend_stream_fwd_kernel<KC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  blend_stream_fwd_kernel<KC><<<n_tiles, kPix, smem, stream>>>(
      rows, n_fields, counts, tstart, toff, grid_x, chunk, accum, t_final);
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Launches on `stream` and returns the first CUDA error (0 on success).
int og_blend_stream_fwd(const float* rows, int n_fields, const int* counts,
                        const int* tstart, const int* toff, int n_tiles,
                        int grid_x, int chunk, float* accum, float* t_final,
                        void* stream) {
  if (n_tiles > 0) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    switch (og_blend::fwd_channels(n_fields - 6)) {
      case 4:
        err = launch<4>(rows, n_fields, counts, tstart, toff, n_tiles, grid_x,
                        chunk, accum, t_final, s);
        break;
      case 8:
        err = launch<8>(rows, n_fields, counts, tstart, toff, n_tiles, grid_x,
                        chunk, accum, t_final, s);
        break;
      default:
        err = launch<og_blend::kMaxC>(rows, n_fields, counts, tstart, toff,
                                      n_tiles, grid_x, chunk, accum, t_final,
                                      s);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
