// Per-splat sum of per-slot gradient rows: out[ids[r]] += rows[r].
//
// Replaces: opengaussian_tpu/ops/rasterize_pallas.py:sorted_segment_reduce
// (the Pallas call at line 1196; kernel _reduce_kernel). The TPU has no
// atomics, so the JAX package sorts the rows by splat id and contracts each
// window of 512 ids with a one-hot matrix on the MXU, carrying the ids as
// exact f32 (hence its 2^24 limit). Hopper has fast float atomics in L2, so
// this kernel needs neither the sort nor the one-hot: one thread per
// (row, field) element adds its value into out[ids[r], f] with atomicAdd.
// Ids are int32 with no width limit below 2^31; rows whose id is outside
// [0, n) are dropped, as the JAX package drops them.
//
// Bound on an H100: bytes. Each element is read once and does one atomic
// add, so the floor is rows (R*F*4) + ids (R*4) read and out (n*F*4) written
// over 3.35 TB/s; the atomics resolve in L2, which is larger than the output
// at these sizes. What the design does about that bound:
//   * neighbouring threads read neighbouring elements of a row-major [R, F]
//     array, so the row reads are fully coalesced;
//   * a zero element adds nothing and is skipped: the rows of slots that no
//     pixel composited are all zero, and they are most of the stream;
//   * a grid-stride loop covers any R * F with a bounded grid.
// Atomic order changes from run to run, so the sums agree with the plain
// version (index_add_) to rounding, not bit for bit.
// Left for later work: a warp-level pre-sum of neighbouring rows that share
// an id (the stream keeps a splat's slots of one tile apart, so few do).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false -shared.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
segment_reduce_kernel(const float* __restrict__ rows,
                      const int* __restrict__ ids, long long n_elems,
                      int n_fields, int n, float* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < n_elems; i += stride) {
    const float v = rows[i];
    if (v == 0.0f) continue;
    const long long r = i / n_fields;
    const int id = ids[r];
    if (id < 0 || id >= n) continue;
    atomicAdd(out + static_cast<long long>(id) * n_fields + (i - r * n_fields),
              v);
  }
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// out: [n, n_fields], zeroed by the caller.
int og_segment_reduce(const float* rows, const int* ids, long long n_rows,
                      int n_fields, int n, float* out, void* stream) {
  const long long n_elems = n_rows * n_fields;
  if (n_elems > 0) {
    const long long want = (n_elems + kThreads - 1) / kThreads;
    const int blocks = static_cast<int>(want < 65536 ? want : 65536);
    segment_reduce_kernel<<<blocks, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        rows, ids, n_elems, n_fields, n, out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
