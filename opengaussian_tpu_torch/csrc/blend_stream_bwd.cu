// Backward of the stream blend: per-slot gradient rows by front-to-back replay.
//
// Replaces: opengaussian_tpu/ops/rasterize_pallas.py:blend_stream_pallas_bwd
// (the Pallas call at line 670; kernel _bwd_stream_kernel, math
// _chunk_blend_math + _chunk_grad_rows). Given the forward's accum and
// t_final and the cotangents g_accum and g_t, every pixel walks its tile's
// run again in the forward's order and takes the suffix form of the blend's
// derivative (blend_tile.cuh:blend_run_bwd, which blend_stream_bwd_compact.cu,
// K4, and the dense-block backward blend_tiles_bwd.cu, K6, share). Each
// slot's row is the sum of its 256 pixels' contributions, written at the
// slot's position in the stream: d_rows [P, 6 + C] (dmean2d 2, dconic 3,
// dopacity 1, dpayload C). Rows no tile walks (past counts[t], past the last
// tile, or after every pixel of a tile stopped) are left as the caller
// zeroed them.
//
// Bound on an H100: operations or bytes, by the frame. A (slot, pixel) pair
// that must be evaluated (its warp's pixels meet the slot's cull box) costs
// the forward's ~24 fp32 operations again (+3 past the 1/255 test); a pair
// that composites adds ~4C + 36 (its gradient terms and their share of the
// sum over pixels; chip_smoke.py:ops_grad); each staged slot its box and a
// box test per warp. Per slot the kernel reads one row of 4(6 + C) bytes
// and writes one, per pixel it reads accum, t_final and their cotangents.
// On a trained scene's frame, where half the evaluated pairs composite, the
// operations are the floor; on a sparse render frame both are close
// (chip_smoke.py computes both from the frame's work counts; PERF.md has
// the numbers).
// What the design does about that bound (blend_tile.cuh:blend_run_bwd):
//   * one CTA per 16x16 tile, one thread per pixel, the run arriving chunk
//     by chunk through two shared-memory buffers by 4-byte cp.async (a run
//     starts at tstart[t] * (6 + C) floats, 16-byte aligned only by
//     chance), chunk i + 1 in flight while chunk i is walked;
//   * a warp cull: ballots on the staged slots' cull boxes
//     (blend_tile.cuh:slot_box) give one bit per warp and slot, and a warp
//     walks only its set bits, so the ~90% of pairs that fall below 1/255
//     cost it nothing past the box test;
//   * the sum over pixels is a reduce-scatter butterfly over a slot's
//     6 + C fields (16 shuffles for up to 16 fields, where a shuffle tree per
//     field takes 5 (6 + C)), then a fixed-order sum through shared memory
//     of the partials of the warps whose bit is set (a warp in which no
//     pixel composites clears its bit and writes nothing): no atomics, and
//     the sums are bit for bit those of the shuffle tree over all 256 pixels
//     that the plain version models;
//   * the payload terms a thread computes follow C (4, 8, 10 or 16 channels
//     held), so the C = 4 color pass spends no issue slots on channels it
//     does not have;
//   * the CTA stops when every pixel has stopped, as the forward does.
// A tile's run is not split across CTAs: on a trained scene's frame every
// tile is deep and the launch is throughput-bound, and on the sparse frames
// of the later stages no tile walks long enough for a split to pay (a
// split with a forward-only replay of the earlier segments was measured
// and gave no gain there; PERF.md).
// No sentinels and no non-finite clamps: rows the kernel does not walk stay
// zero because the wrapper allocates d_rows with torch.zeros.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false -shared.
// No --use_fast_math and no fused multiply-adds, as for the forward: the
// replay must take the forward's branches at the 1/255 and 1e-4 thresholds.

#include <cuda_runtime.h>

#include "blend_tile.cuh"

namespace {

using og_blend::kPix;

// rows: [P, n_fields] f32 = mean2d x/y, conic a/b/c, opacity, payload (C).
// counts/tstart/toff: [T] int32. accum/g_accum: [T, C, 256];
// t_final/g_t: [T, 256]. d_rows: [P, n_fields], zeroed by the caller.
template <int KC>
__global__ void __launch_bounds__(kPix, og_blend::bwd_min_blocks(KC))
blend_stream_bwd_kernel(const float* __restrict__ rows, int n_fields,
                        const int* __restrict__ counts,
                        const int* __restrict__ tstart,
                        const int* __restrict__ toff, int grid_x, int chunk,
                        const float* __restrict__ accum,
                        const float* __restrict__ t_final,
                        const float* __restrict__ g_accum,
                        const float* __restrict__ g_t,
                        float* __restrict__ d_rows) {
  const long long t = blockIdx.x;
  const long long C = n_fields - 6;
  const long long start = tstart[t] * static_cast<long long>(n_fields);
  og_blend::blend_run_bwd<KC, false>(rows + start, n_fields, counts[t],
                                     toff[t], grid_x, chunk,
                                     accum + t * C * kPix, t_final + t * kPix,
                                     g_accum + t * C * kPix, g_t + t * kPix,
                                     d_rows + start);
}

template <int KC>
cudaError_t launch(const float* rows, int n_fields, const int* counts,
                   const int* tstart, const int* toff, int n_tiles, int grid_x,
                   int chunk, const float* accum, const float* t_final,
                   const float* g_accum, const float* g_t, float* d_rows,
                   cudaStream_t stream) {
  const size_t smem = og_blend::bwd_smem_bytes(chunk, n_fields);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        blend_stream_bwd_kernel<KC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  blend_stream_bwd_kernel<KC><<<n_tiles, kPix, smem, stream>>>(
      rows, n_fields, counts, tstart, toff, grid_x, chunk, accum, t_final,
      g_accum, g_t, d_rows);
  return cudaSuccess;
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
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    switch (og_blend::bwd_channels(n_fields - 6)) {
      case 4:
        err = launch<4>(rows, n_fields, counts, tstart, toff, n_tiles, grid_x,
                        chunk, accum, t_final, g_accum, g_t, d_rows, s);
        break;
      case 8:
        err = launch<8>(rows, n_fields, counts, tstart, toff, n_tiles, grid_x,
                        chunk, accum, t_final, g_accum, g_t, d_rows, s);
        break;
      case 10:
        err = launch<10>(rows, n_fields, counts, tstart, toff, n_tiles, grid_x,
                         chunk, accum, t_final, g_accum, g_t, d_rows, s);
        break;
      default:
        err = launch<og_blend::kMaxC>(rows, n_fields, counts, tstart, toff,
                                      n_tiles, grid_x, chunk, accum, t_final,
                                      g_accum, g_t, d_rows, s);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
