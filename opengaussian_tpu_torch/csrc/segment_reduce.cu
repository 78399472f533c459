// Per-splat sum of per-slot gradient rows: out[ids[r]] += rows[r].
//
// Replaces: opengaussian_tpu/ops/rasterize_pallas.py:sorted_segment_reduce
// (the Pallas call at line 1196; kernel _reduce_kernel). The TPU has no
// atomics, so the JAX package sorts the rows by splat id and contracts each
// window of 512 ids with a one-hot matrix on the MXU, carrying the ids as
// exact f32 (hence its 2^24 limit). Hopper has fast float atomics in L2, so
// this kernel needs neither the sort nor the one-hot: each row is added into
// out[ids[r]] with atomic adds. Ids are int32 with no width limit below
// 2^31; rows whose id is outside [0, n) are dropped, as the JAX package
// drops them.
//
// Bound on an H100: bytes. Each row and its id are read once and out is
// written once, so the floor is rows (R*F*4) + ids (R*4) + out (n*F*4) over
// 3.35 TB/s; the atomics resolve in L2, which is larger than the output at
// these sizes. What the design does about that bound:
//   * the zero fill of out is a cudaMemsetAsync on the same stream, ahead of
//     the kernel: no separate fill kernel from the caller;
//   * one thread per row with 32-bit row indices and a bounded grid-stride
//     loop: the thread reads the row's id first and drops the row unread
//     when the id is outside [0, n) (the dense layout's dead slots), so no
//     division or per-element id load is left;
//   * the row is read with 8-byte vector loads where F is even and the
//     pointers 8-byte aligned (the stream's F = 10), and added with Hopper's
//     vector atomics (compute capability 9.x, global memory):
//     atomicAdd(float4*, float4) on the 16-byte aligned quads of the output
//     row, atomicAdd(float2*, float2) on a pair left at either end, so a row
//     of F = 10 takes 3 atomics where scalar ones take 10; odd F (the dense
//     block's F = 13) takes scalar loads and atomics. A quad, pair or
//     element that is zero adds nothing and is skipped, so the all-zero rows
//     of slots that no pixel composited cost their read and no atomic.
// Atomic order changes from run to run, so the sums agree with the plain
// version (index_add_) to rounding, not bit for bit.
// Left for later work: a warp-level pre-sum of neighbouring rows that share
// an id (the stream keeps a splat's slots of one tile apart, so few do).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false -shared.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 4096;  // the grid-stride loop covers the rest
constexpr int kPiece = 16;        // fields a thread holds at once

__device__ __forceinline__ bool nonzero(float2 a) {
  return a.x != 0.0f || a.y != 0.0f;
}

// Adds pairs a and b at dst (16-byte aligned) as one float4, or a alone as a
// float2 when b lies past the row.
__device__ __forceinline__ void add_quad(float* dst, float2 a, float2 b,
                                         bool has_b) {
  if (has_b) {
    if (nonzero(a) || nonzero(b))
      atomicAdd(reinterpret_cast<float4*>(dst), make_float4(a.x, a.y, b.x, b.y));
  } else if (nonzero(a)) {
    atomicAdd(reinterpret_cast<float2*>(dst), a);
  }
}

// Even F, rows and out 8-byte aligned: each row read as float2 pairs and
// added as float4 quads where the output row is 16-byte aligned (an output
// row at 8 mod 16 first adds its leading pair alone), so a row of F = 10
// takes 3 atomics, not 5.
__global__ void __launch_bounds__(kThreads)
segment_reduce_vec(const float* __restrict__ rows, const int* __restrict__ ids,
                   int n_rows, int n_fields, int n, float* __restrict__ out) {
  constexpr int kPairs = kPiece / 2;
  const int pairs = n_fields / 2;
  // unsigned: r + the stride stays below 2^32 for any n_rows < 2^31
  for (unsigned r = blockIdx.x * kThreads + threadIdx.x;
       r < static_cast<unsigned>(n_rows); r += gridDim.x * kThreads) {
    const int id = ids[r];
    if (static_cast<unsigned>(id) >= static_cast<unsigned>(n)) continue;
    const float2* src =
        reinterpret_cast<const float2*>(rows + static_cast<size_t>(r) * n_fields);
    float* dst = out + static_cast<size_t>(id) * n_fields;
    const bool lead = reinterpret_cast<std::uintptr_t>(dst) % 16 != 0;
    for (int j = 0; j < pairs; j += kPairs) {  // pieces of 64 bytes
      const int m = pairs - j;                 // pairs left in the row
      float2 v[kPairs];
#pragma unroll
      for (int q = 0; q < kPairs; ++q)
        v[q] = q < m ? src[j + q] : make_float2(0.0f, 0.0f);
      float* d = dst + 2 * j;
      if (!lead) {
#pragma unroll
        for (int q = 0; q < kPairs; q += 2)
          if (q < m) add_quad(d + 2 * q, v[q], v[q + 1], q + 1 < m);
      } else {
        if (nonzero(v[0])) atomicAdd(reinterpret_cast<float2*>(d), v[0]);
#pragma unroll
        for (int q = 1; q < kPairs - 1; q += 2)
          if (q < m) add_quad(d + 2 * q, v[q], v[q + 1], q + 1 < m);
        if (kPairs - 1 < m && nonzero(v[kPairs - 1]))
          atomicAdd(reinterpret_cast<float2*>(d + 2 * (kPairs - 1)), v[kPairs - 1]);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
segment_reduce_scalar(const float* __restrict__ rows,
                      const int* __restrict__ ids, int n_rows, int n_fields,
                      int n, float* __restrict__ out) {
  for (unsigned r = blockIdx.x * kThreads + threadIdx.x;
       r < static_cast<unsigned>(n_rows); r += gridDim.x * kThreads) {
    const int id = ids[r];
    if (static_cast<unsigned>(id) >= static_cast<unsigned>(n)) continue;
    const float* src = rows + static_cast<size_t>(r) * n_fields;
    float* dst = out + static_cast<size_t>(id) * n_fields;
    for (int j = 0; j < n_fields; j += kPiece) {
      float v[kPiece];
#pragma unroll
      for (int q = 0; q < kPiece; ++q) v[q] = j + q < n_fields ? src[j + q] : 0.0f;
#pragma unroll
      for (int q = 0; q < kPiece; ++q)
        if (v[q] != 0.0f) atomicAdd(dst + j + q, v[q]);
    }
  }
}

}  // namespace

extern "C" {

// Zero-fills out [n, n_fields] and adds the rows into it, both on `stream`;
// returns the first CUDA error (0 on success).
int og_segment_reduce(const float* rows, const int* ids, int n_rows,
                      int n_fields, int n, float* out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n > 0 && n_fields > 0) {
    const cudaError_t err = cudaMemsetAsync(
        out, 0, static_cast<size_t>(n) * n_fields * sizeof(float), s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (n_rows > 0 && n > 0 && n_fields > 0) {
    const int want = n_rows / kThreads + (n_rows % kThreads != 0);
    const int blocks = want < kMaxBlocks ? want : kMaxBlocks;
    const bool vec2 = n_fields % 2 == 0 &&
                      (reinterpret_cast<std::uintptr_t>(rows) |
                       reinterpret_cast<std::uintptr_t>(out)) % 8 == 0;
    if (vec2)
      segment_reduce_vec<<<blocks, kThreads, 0, s>>>(rows, ids, n_rows,
                                                     n_fields, n, out);
    else
      segment_reduce_scalar<<<blocks, kThreads, 0, s>>>(rows, ids, n_rows,
                                                        n_fields, n, out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
