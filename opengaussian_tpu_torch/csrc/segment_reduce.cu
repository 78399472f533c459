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
//
// The atomic entry is RasterizeConfig(reduce_backend="scatter"). The two
// other entries sum in a fixed order, so their sums repeat bit for bit from
// run to run and equal the CPU's index_add_, which adds the rows in the same
// order:
//   * the permutation entry (og_segment_reduce_perm), the rasterizer's
//     default ("sorted_mxu", the JAX package's default backend, whose
//     ReducePlan caches the same kind of order for frozen geometry). The
//     binning expands each splat's slots contiguously, in ascending splat
//     order and, within a splat, in ascending tile order; its stable sort by
//     (tile, depth rank) therefore keeps each splat's live slots in that
//     order. The inverse of the sort's permutation (`pos`: the stream
//     position of each expanded slot) read over a splat's range of expanded
//     slots (`ends`, the running end of each splat's range) lists the
//     splat's stream positions in ascending order: the order in which the
//     sorted entry sums them, without the sort. The slots the cull moved
//     past the last tile sit out of that order, but no tile walks them, so
//     their rows are zero and adding them changes no bit (the running sum
//     starts at +0 and never becomes -0). A negative position is skipped
//     (the compact layout's rows that no tile owns). One thread per (group,
//     splat, field) sums that field of the splat's rows serially and writes
//     it once: no zero fill, no atomics; the threads of one splat read the
//     fields of each row together. A splat over many tiles runs long in its
//     threads. Its bound is bytes too: rows (R*F*4), pos (L*4), ends (n*4)
//     and out (n*F*4), each moved once.
//   * the sorted entry (og_segment_reduce_sorted), for rows that carry no
//     such order (the SAM refiner's votes): the caller sorts the ids
//     stably, as the JAX package sorts its rows by id before its kernel, and
//     one thread per segment of equal ids sums that segment's rows, gathered
//     through the sort's permutation, in row order and writes the sum once,
//     from 0 or, with `accumulate`, from the value out holds (index_add_
//     into an existing tensor). The sort and the gathered reads make it
//     slower than the atomic entry.
// Left for later work: a warp per long splat in the permutation entry.
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

// keys: the ids sorted stably, order: the row of each sorted position. The
// thread at the head of a run of equal keys in [0, n) sums the run's rows
// in sorted (= row) order, from 0 or from out[key] (accumulate), and
// writes out[key]; other ids keep their value.
__global__ void __launch_bounds__(kThreads)
segment_reduce_sorted(const float* __restrict__ rows,
                      const int* __restrict__ keys,
                      const int64_t* __restrict__ order, int n_rows,
                      int n_fields, int n, bool accumulate,
                      float* __restrict__ out) {
  for (unsigned p = blockIdx.x * kThreads + threadIdx.x;
       p < static_cast<unsigned>(n_rows); p += gridDim.x * kThreads) {
    const int id = keys[p];
    if (static_cast<unsigned>(id) >= static_cast<unsigned>(n)) continue;
    if (p > 0 && keys[p - 1] == id) continue;  // not the head of its run
    float* dst = out + static_cast<size_t>(id) * n_fields;
    for (int j = 0; j < n_fields; j += kPiece) {
      float acc[kPiece];
#pragma unroll
      for (int q = 0; q < kPiece; ++q)
        acc[q] = accumulate && j + q < n_fields ? dst[j + q] : 0.0f;
      for (unsigned r = p; r < static_cast<unsigned>(n_rows) && keys[r] == id; ++r) {
        const float* src = rows + static_cast<size_t>(order[r]) * n_fields + j;
#pragma unroll
        for (int q = 0; q < kPiece; ++q)
          if (j + q < n_fields) acc[q] += src[q];
      }
#pragma unroll
      for (int q = 0; q < kPiece; ++q)
        if (j + q < n_fields) dst[j + q] = acc[q];
    }
  }
}

// One thread per (group, splat, field): out[(g n + i) F + f] = the sum, in
// the order of i's range of pos, of rows[(g n_rows + pos[p]) F + f]; pos[p]
// < 0 is skipped. ends: the running end of each splat's range in pos.
__global__ void __launch_bounds__(kThreads)
segment_reduce_perm(const float* __restrict__ rows, const int* __restrict__ pos,
                    const int* __restrict__ ends, int n_rows, int n_fields,
                    int n, long long total, float* __restrict__ out) {
  for (long long t = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x;
       t < total; t += static_cast<long long>(gridDim.x) * kThreads) {
    const long long gi = t / n_fields;  // g n + i
    const int f = static_cast<int>(t - gi * n_fields);
    const long long g = gi / n;
    const int i = static_cast<int>(gi - g * n);
    const int lo = i > 0 ? ends[i - 1] : 0;
    const int hi = ends[i];
    const float* src = rows + static_cast<size_t>(g) * n_rows * n_fields + f;
    float acc = 0.0f;
    for (int p = lo; p < hi; ++p) {
      const int q = pos[p];
      if (q >= 0) acc += src[static_cast<size_t>(q) * n_fields];
    }
    out[t] = acc;
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

// The sorted order: zero-fills out [n, n_fields] (unless accumulate) and
// writes each id's sum of its rows in row order, from 0 (from out's value
// with accumulate), both on `stream`. keys [n_rows] are the ids sorted
// stably and order [n_rows] the row of each sorted position; returns the
// first CUDA error (0 on success).
int og_segment_reduce_sorted(const float* rows, const int* keys,
                             const int64_t* order, int n_rows, int n_fields,
                             int n, int accumulate, float* out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!accumulate && n > 0 && n_fields > 0) {
    const cudaError_t err = cudaMemsetAsync(
        out, 0, static_cast<size_t>(n) * n_fields * sizeof(float), s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (n_rows > 0 && n > 0 && n_fields > 0) {
    const int want = n_rows / kThreads + (n_rows % kThreads != 0);
    const int blocks = want < kMaxBlocks ? want : kMaxBlocks;
    segment_reduce_sorted<<<blocks, kThreads, 0, s>>>(
        rows, keys, order, n_rows, n_fields, n, accumulate != 0, out);
  }
  return static_cast<int>(cudaGetLastError());
}

// The permutation order: writes out [groups n, n_fields], group g's splat
// i the sum of rows [g n_rows + pos[p]] over p in [ends[i - 1], ends[i])
// (ends[-1] = 0), skipping pos[p] < 0, on `stream`. Every element of out is
// written: no fill. Returns the first CUDA error (0 on success).
int og_segment_reduce_perm(const float* rows, const int* pos, const int* ends,
                           int n_rows, int n_fields, int n, int groups,
                           float* out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long total = static_cast<long long>(groups) * n * n_fields;
  if (total > 0) {
    const long long want = (total + kThreads - 1) / kThreads;
    const int blocks = static_cast<int>(want < 65536 ? want : 65536);
    segment_reduce_perm<<<blocks, kThreads, 0, s>>>(rows, pos, ends, n_rows,
                                                    n_fields, n, total, out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
