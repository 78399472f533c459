// The stage-1 SAM-mask losses' per-mask sums, forward and backward: each
// mask's pixel count, its count and feature sum inside the silhouette, and
// the sum of its pixels' distances to its mean; and the gradient of the
// feature image from those sums.
//
// Replaces no Pallas kernel: the JAX package builds the mask losses
// (utils/masks.py:masks_onehot, mask_feature_mean; train/losses.py:
// cohesion_loss) from dense [M, H, W] mask stacks and leaves them to XLA,
// which fuses the chain. The port ran the same chain as eager PyTorch ops,
// and the [M, H, W, C] difference tensor of the cohesion loss and the passes
// over it took 5.5 of a stage-1 step's 12.6 ms of device time (985x730,
// M = 32, C = 6): several GB of traffic in some 55 launches a step.
//
// Each pixel carries one SAM id, so it lies in at most one mask, and every
// per-mask quantity of the losses is a sum over the pixels of one id. Bound
// on an H100: bytes. Per pass the feature image (17 MB at 985x730x6), the
// ids and the silhouette (2.9 MB each) are read once; the backward writes
// the feature image's gradient once. About five such passes a step, ~0.1 GB,
// is ~0.03 ms at 3.35 TB/s. What the design does about that bound:
//   * two forward passes over the pixels (the masks' sums, then the
//     distances to the means) and one backward pass; the [M, *] tables
//     between them are a few KB, and no per-pixel intermediate is written;
//   * a warp walks its pixels in row order, and while its 32 pixels belong
//     to one mask (or to none) each lane adds its own pixels' values in
//     registers: only where the id changes does the warp sum its lanes (a
//     butterfly of shuffles) into its own table in shared memory;
//   * the backward recomputes each pixel's distance from the feature and its
//     mask's mean, so only the forward's inputs and the tables are kept.
// Determinism: no float atomics. Each warp's table is written by its lane 0
// alone, in the order of its pixels; a block sums its warps' tables in warp
// order into its row of partials [blocks, M, V]; a second kernel sums the
// blocks' rows in block order. The sums depend on the data alone, so two
// runs on one frame agree bit for bit. Shared memory holds a chunk of masks
// per pass over the pixels: where kWarps x M x V floats exceed 48 KB (some
// hundreds of masks), a block walks its pixels once per chunk.
// Rounding: fp32, built with -fmad=false; the sums run in another order
// than the plain versions' (ops/mask_loss_kernels.py), so the two agree to
// fp32 rounding, not bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPixelsPerBlock = 2048;  // PIXELS_PER_BLOCK in ops/mask_loss_kernels.py
constexpr int kMaxC = 16;              // MAX_C in ops/mask_loss_kernels.py
constexpr int kMaxV = kMaxC + 2;       // values summed per mask: count, scount, sum[C]
constexpr int kSmemBytes = 48 * 1024;  // the tables' shared memory: no opt-in needed
constexpr unsigned kFull = 0xffffffffu;

// torch.clamp(min=): a NaN passes through
__device__ __forceinline__ float clamp_min(float x, float lo) { return x < lo ? lo : x; }

// the sum of v over the warp's lanes, the same butterfly in every lane
__device__ __forceinline__ float warp_sum(float v) {
  v += __shfl_xor_sync(kFull, v, 16);
  v += __shfl_xor_sync(kFull, v, 8);
  v += __shfl_xor_sync(kFull, v, 4);
  v += __shfl_xor_sync(kFull, v, 2);
  v += __shfl_xor_sync(kFull, v, 1);
  return v;
}

// Adds the warp's sums of v[0..nv) to row `key` (warp-uniform) of the
// warp's table [*, nv]; lane 0 writes.
__device__ __forceinline__ void add_row(float* table, int key, const float* v, int nv) {
#pragma unroll
  for (int j = 0; j < kMaxV; ++j) {
    if (j < nv) {
      const float s = warp_sum(v[j]);
      if ((threadIdx.x & 31) == 0) table[key * nv + j] += s;
    }
  }
}

// One warp's walk over its pixels of the block's range for the masks
// k0 < id <= k0 + mc: `values(p, k, v)` gives pixel p's nv values for mask
// k (0-based), and each mask's sums go to row k - k0 of `table`. Rounds of
// 32 pixels in row order; a run of rounds whose pixels all lie in one mask
// (or in none) is summed by lane in registers and added to the table when
// it ends; a round that mixes masks adds each mask's lanes at once.
template <class Values>
__device__ void walk(const Values& values, const int* ids, int n_pix, int k0, int mc, int nv,
                     float* table) {
  const int lane = threadIdx.x & 31;
  const int start = blockIdx.x * kPixelsPerBlock;
  const int end = min(start + kPixelsPerBlock, n_pix);
  float acc[kMaxV], v[kMaxV];
#pragma unroll
  for (int j = 0; j < kMaxV; ++j) acc[j] = 0.0f;
  int cur = -1;  // the run's mask (warp-uniform), -1 for none
  for (int base = start + (threadIdx.x & ~31); base < end; base += kThreads) {
    const int p = base + lane;
    int key = -1;
    if (p < end) {
      const int id = ids[p];
      if (id > k0 && id <= k0 + mc) key = id - 1 - k0;
    }
#pragma unroll
    for (int j = 0; j < kMaxV; ++j) v[j] = 0.0f;
    if (key >= 0) values(p, key + k0, v);
    if (__all_sync(kFull, key < 0 || key == cur)) {  // the run goes on
#pragma unroll
      for (int j = 0; j < kMaxV; ++j) acc[j] += v[j];
      continue;
    }
    if (cur >= 0) {  // the run ends
      add_row(table, cur, acc, nv);
#pragma unroll
      for (int j = 0; j < kMaxV; ++j) acc[j] = 0.0f;
    }
    const unsigned has = __ballot_sync(kFull, key >= 0);
    const int first = __shfl_sync(kFull, key, __ffs(has) - 1);
    if (__all_sync(kFull, key < 0 || key == first)) {  // a new run starts
      cur = first;
#pragma unroll
      for (int j = 0; j < kMaxV; ++j) acc[j] = v[j];
      continue;
    }
    cur = -1;  // the round mixes masks: each one's lanes in turn
    unsigned pending = has;
    while (pending) {
      const int k = __shfl_sync(kFull, key, __ffs(pending) - 1);
      const bool mine = key == k;
      pending &= ~__ballot_sync(kFull, mine);
      float w[kMaxV];
#pragma unroll
      for (int j = 0; j < kMaxV; ++j) w[j] = mine ? v[j] : 0.0f;
      add_row(table, k, w, nv);
    }
  }
  if (cur >= 0) add_row(table, cur, acc, nv);
}

// The masks per chunk whose per-warp tables of nv floats fit kSmemBytes.
__host__ __device__ __forceinline__ int chunk_masks(int m, int nv) {
  const int mc = kSmemBytes / (4 * kWarps * nv);
  return m < mc ? m : mc;
}

// The block's partials [M, nv] (row blockIdx.x of part [blocks, M, nv]):
// per chunk of masks, every warp walks its pixels into its own table, then
// the block sums the tables in warp order.
template <class Values>
__device__ void block_partials(const Values& values, const int* ids, int n_pix, int m, int nv,
                               float* part) {
  extern __shared__ float tables[];
  const int mc = chunk_masks(m, nv);
  float* mine = tables + (threadIdx.x >> 5) * mc * nv;
  float* row = part + static_cast<long long>(blockIdx.x) * m * nv;
  for (int k0 = 0; k0 < m; k0 += mc) {
    const int n_k = min(mc, m - k0);
    for (int i = threadIdx.x; i < kWarps * mc * nv; i += kThreads) tables[i] = 0.0f;
    __syncthreads();
    walk(values, ids, n_pix, k0, n_k, nv, mine);
    __syncthreads();
    for (int i = threadIdx.x; i < n_k * nv; i += kThreads) {
      float s = 0.0f;
      for (int w = 0; w < kWarps; ++w) s += tables[w * mc * nv + i];
      row[k0 * nv + i] = s;
    }
    __syncthreads();
  }
}

struct Frame {
  const float* feat;  // [H, W, C] at row stride sy and pixel stride sx, channels contiguous
  long long sy, sx;
  int w, c;
  __device__ __forceinline__ const float* at(int p) const {
    const int y = p / w;
    return feat + y * sy + (p - y * w) * sx;
  }
};

// Stats: count, the silhouette's weight, the weighted feature.
struct StatsValues {
  Frame fr;
  const float* sil;
  __device__ __forceinline__ void operator()(int p, int, float* v) const {
    const float* f = fr.at(p);
    const float s = sil[p];
    v[0] = 1.0f;
    v[1] = s;
#pragma unroll
    for (int c = 0; c < kMaxC; ++c)
      if (c < fr.c) v[2 + c] = s * f[c];
  }
};

// The pixel's difference from mean k, its squared norm (channels in order)
// and its distance: 0 where the square is exactly 0 (cohesion_loss's
// double where).
__device__ __forceinline__ float distance(const float* f, const float* mean, int c_n,
                                          float* diff) {
  float sq = 0.0f;
#pragma unroll
  for (int c = 0; c < kMaxC; ++c) {
    if (c < c_n) {
      diff[c] = f[c] - mean[c];
      sq += diff[c] * diff[c];
    }
  }
  return sq > 0.0f ? sqrtf(sq) : 0.0f;
}

// Dist: the distance, the unit difference (0 at distance 0).
struct DistValues {
  Frame fr;
  const float* means;  // [M, C]
  __device__ __forceinline__ void operator()(int p, int k, float* v) const {
    float diff[kMaxC];
    const float d = distance(fr.at(p), means + k * fr.c, fr.c, diff);
    v[0] = d;
#pragma unroll
    for (int c = 0; c < kMaxC; ++c)
      if (c < fr.c) v[1 + c] = d > 0.0f ? diff[c] / d : 0.0f;
  }
};

__global__ void __launch_bounds__(kThreads)
stats_part(Frame fr, const int* ids, const float* sil, int n_pix, int m, float* part) {
  block_partials(StatsValues{fr, sil}, ids, n_pix, m, fr.c + 2, part);
}

__global__ void __launch_bounds__(kThreads)
dist_part(Frame fr, const int* ids, const float* means, int n_pix, int m, float* part) {
  block_partials(DistValues{fr, means}, ids, n_pix, m, fr.c + 1, part);
}

// Mask blockIdx.x's sums over the blocks' partials, in block order: warp s
// sums its range of blocks, then lane j sums the ranges in order.
// -> tot[0..nv) in shared memory (all threads past a __syncthreads).
__device__ void mask_totals(const float* part, int n_blocks, int m, int nv, float* tot) {
  __shared__ float seg[kWarps][32];
  const int k = blockIdx.x, j = threadIdx.x & 31, s = threadIdx.x >> 5;
  const int lo = static_cast<int>(static_cast<long long>(n_blocks) * s / kWarps);
  const int hi = static_cast<int>(static_cast<long long>(n_blocks) * (s + 1) / kWarps);
  float sum = 0.0f;
  if (j < nv)
    for (int b = lo; b < hi; ++b) sum += part[(static_cast<long long>(b) * m + k) * nv + j];
  seg[s][j] = sum;
  __syncthreads();
  if (s == 0 && j < nv) {
    float t = 0.0f;
    for (int r = 0; r < kWarps; ++r) t += seg[r][j];
    tot[j] = t;
  }
  __syncthreads();
}

// stats [M, C+2] (count, scount, sum), means [M, C] = sum / max(scount, 1),
// valid [M] = count > 0; one block a mask.
__global__ void __launch_bounds__(kThreads)
stats_final(const float* part, int n_blocks, int m, int c_n, float* stats, float* means,
            unsigned char* valid) {
  __shared__ float tot[kMaxV];
  const int nv = c_n + 2, k = blockIdx.x, j = threadIdx.x;
  mask_totals(part, n_blocks, m, nv, tot);
  if (j < nv) stats[k * nv + j] = tot[j];
  if (j >= 2 && j < nv) means[k * c_n + j - 2] = tot[j] / clamp_min(tot[1], 1.0f);
  if (j == 0) valid[k] = tot[0] > 0.0f;
}

// dist [M, C+1] (the sum of distances, the sum of unit differences); the
// last block to finish then writes n_valid and the cohesion loss: the
// valid masks' mean distances, summed in mask order, over max(n_valid, 1).
__global__ void __launch_bounds__(kThreads)
dist_final(const float* part, int n_blocks, int m, int c_n, const float* stats, float* dist,
           unsigned* done, float* n_valid, float* coh) {
  __shared__ float tot[kMaxV];
  __shared__ float terms[kThreads], counts[kThreads];
  __shared__ bool last;
  const int nv = c_n + 1, k = blockIdx.x, t = threadIdx.x;
  mask_totals(part, n_blocks, m, nv, tot);
  if (t < nv) dist[k * nv + t] = tot[t];
  __threadfence();
  __syncthreads();
  if (t == 0) last = atomicAdd(done, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  float term = 0.0f, n = 0.0f;
  for (int i = t; i < m; i += kThreads) {
    const float cnt = __ldcg(stats + i * (c_n + 2));
    if (cnt > 0.0f) {
      term += __ldcg(dist + i * nv) / clamp_min(cnt, 1.0f);
      n += 1.0f;
    }
  }
  terms[t] = term;
  counts[t] = n;
  __syncthreads();
  for (int w = kThreads / 2; w > 0; w >>= 1) {
    if (t < w) {
      terms[t] += terms[t + w];
      counts[t] += counts[t + w];
    }
    __syncthreads();
  }
  if (t == 0) {
    *n_valid = counts[0];
    *coh = terms[0] / clamp_min(counts[0], 1.0f);
  }
}

// d feat [H, W, C] (contiguous): at a pixel of mask k, with
// a = d_coh / max(n_valid, 1) / max(count_k, 1),
//   a (f - mean_k) / dist            where dist > 0
//   + sil (d_mean_k - a T_k) / max(scount_k, 1),
// T_k the mask's sum of unit differences; 0 at a pixel of no mask.
__global__ void __launch_bounds__(kThreads)
loss_bwd(Frame fr, const int* ids, const float* sil, int n_pix, int m, const float* means,
         const float* stats, const float* dist, const float* n_valid, const float* d_coh,
         const float* d_means, float* d_feat) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= n_pix) return;
  const int c_n = fr.c;
  float* out = d_feat + static_cast<long long>(p) * c_n;
  const int id = ids[p];
  if (id < 1 || id > m) {
    for (int c = 0; c < c_n; ++c) out[c] = 0.0f;
    return;
  }
  const int k = id - 1;
  const float a = (*d_coh / clamp_min(*n_valid, 1.0f)) / clamp_min(stats[k * (c_n + 2)], 1.0f);
  const float scount = clamp_min(stats[k * (c_n + 2) + 1], 1.0f);
  const float w = sil[p];
  float diff[kMaxC];
  const float d = distance(fr.at(p), means + k * c_n, c_n, diff);
  const float* unit = dist + k * (c_n + 1) + 1;
#pragma unroll
  for (int c = 0; c < kMaxC; ++c) {
    if (c < c_n) {
      const float direct = d > 0.0f ? a * diff[c] / d : 0.0f;
      out[c] = direct + w * ((d_means[k * c_n + c] - a * unit[c]) / scount);
    }
  }
}

int blocks_for(int n_pix) { return n_pix / kPixelsPerBlock + (n_pix % kPixelsPerBlock != 0); }

}  // namespace

extern "C" {

// The forward over feat [h, w, c] (row stride sy, pixel stride sx), ids
// [h, w] and sil [h, w] for masks 1..m: stats [m, c+2], means [m, c],
// valid [m], dist [m, c+1], n_valid and coh. part holds
// blocks_for(h * w) * m * (c + 2) floats and a counter after them. Returns
// the first CUDA error (0 on success), as every entry here does.
int og_mask_loss_fwd(const float* feat, long long sy, long long sx, const int* ids,
                     const float* sil, int h, int w, int c, int m, float* part, float* stats,
                     float* means, unsigned char* valid, float* dist, float* n_valid,
                     float* coh, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_pix = h * w, n_blocks = blocks_for(n_pix);
  const Frame fr{feat, sy, sx, w, c};
  unsigned* done = reinterpret_cast<unsigned*>(part + static_cast<long long>(n_blocks) * m *
                                               (c + 2));
  cudaError_t err = cudaMemsetAsync(done, 0, sizeof(unsigned), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_blocks > 0)
    stats_part<<<n_blocks, kThreads, kWarps * chunk_masks(m, c + 2) * (c + 2) * sizeof(float),
                 s>>>(fr, ids, sil, n_pix, m, part);
  stats_final<<<m, kThreads, 0, s>>>(part, n_blocks, m, c, stats, means, valid);
  if (n_blocks > 0)
    dist_part<<<n_blocks, kThreads, kWarps * chunk_masks(m, c + 1) * (c + 1) * sizeof(float),
                s>>>(fr, ids, means, n_pix, m, part);
  dist_final<<<m, kThreads, 0, s>>>(part, n_blocks, m, c, stats, dist, done, n_valid, coh);
  return static_cast<int>(cudaGetLastError());
}

// d_feat [h, w, c] (contiguous) from the forward's inputs and tables, d_coh
// (a scalar) and d_means [m, c], all in device memory.
int og_mask_loss_bwd(const float* feat, long long sy, long long sx, const int* ids,
                     const float* sil, int h, int w, int c, int m, const float* means,
                     const float* stats, const float* dist, const float* n_valid,
                     const float* d_coh, const float* d_means, float* d_feat, void* stream) {
  const int n_pix = h * w;
  if (n_pix > 0)
    loss_bwd<<<n_pix / kThreads + (n_pix % kThreads != 0), kThreads, 0,
               static_cast<cudaStream_t>(stream)>>>(Frame{feat, sy, sx, w, c}, ids, sil, n_pix,
                                                     m, means, stats, dist, n_valid, d_coh,
                                                     d_means, d_feat);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
