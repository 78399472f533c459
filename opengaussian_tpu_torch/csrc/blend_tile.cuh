// One tile's depth-ordered blend and its backward replay, shared by the
// stream kernels (blend_stream_fwd.cu K1, blend_stream_bwd.cu K2,
// blend_stream_bwd_compact.cu K4) and the dense-block kernels
// (blend_tiles_fwd.cu K5, blend_tiles_bwd.cu K6).
//
// A tile's run is `cnt` consecutive rows of n_fields floats: mean2d x/y,
// conic a/b/c, opacity, payload (C = n_fields - 6). In the stream layout it
// starts at tstart[t] of the sorted slot stream; in the dense layout at
// t * K of the [T, K, n_fields] block. Either way the caller hands these
// functions a pointer to the run's first row, so both layouts run the same
// arithmetic and round alike.
//
// Semantics (opengaussian_tpu/ops/blend.py): per pixel, walk the run front to
// back; alpha = min(0.99, o * exp(power)) with alpha = 0 where power > 0;
// skip alpha < 1/255; a slot composites only while the transmittance after it
// stays >= 1e-4, and the first slot that would take it below stops the pixel
// for good.
//
// Both walks stage the run chunk by chunk into two shared-memory buffers by
// asynchronous copies, so the next chunk lands while the walk works on this
// one (stage_chunk), and cull by warp: ballots on the staged slots' cull
// boxes (slot_box) give one bit per warp and slot, and a warp walks only
// its set bits (cull_chunk), which changes no output bit. The backward also
// keeps the warps' partial sums of a chunk, and adds only those of the
// warps whose bit is set (blend_run_bwd).
//
// Both are called by every thread of a CTA of kPix threads, one per pixel,
// with dynamic shared memory of fwd_smem_bytes (forward) or bwd_smem_bytes
// (backward). Pointer offsets are
// 64-bit: a dense block's (t * K + k) * n_fields passes 2^31 at full width.

#pragma once

#include <cuda_runtime.h>

namespace og_blend {

constexpr int kTile = 16;
constexpr int kPix = kTile * kTile;  // threads per CTA: one per pixel
constexpr int kWarps = kPix / 32;
constexpr int kMaxC = 16;  // payload channels one thread holds (MAX_C)
constexpr unsigned kFull = 0xffffffffu;


// opengaussian_tpu/ops/blend.py, rounded to float as the JAX package does
constexpr float kAlphaMin = static_cast<float>(1.0 / 255.0);
constexpr float kAlphaMax = 0.99f;
constexpr float kTEps = 1e-4f;
constexpr float kMinOneMinusA = static_cast<float>(1.0 - 0.99);

// Warp cull of the tile walks. The walk's fp32 quadratic form
// q = a dx^2 + 2b dx dy + c dy^2 (-2 power, without fused multiply-adds)
// rounds to within kCullEps * kappa * q of its exact value, kappa =
// (max(a, c) + |b|)(a + c) / det bounding the absolute terms over q.
constexpr float kCullEps = 1e-6f;

// The pixel box (x0, x1, y0, y1) of slot g outside of which its alpha stays
// below 1/255 in the walk's own arithmetic. alpha >= 1/255 needs o >= 1/255
// (o * gauss rounds to at most o) and q <= 2 ln(255 o), an ellipse whose
// half-extents are sqrt(2 L c / det) in x and sqrt(2 L a / det) in y. L is
// widened for expf's and the products' rounding and for q's (1 / (1 - r),
// r = kCullEps * kappa), the extents for their own rounding and that of the
// box's edges. Empty (x0 > x1) when o < 1/255; unbounded (-inf, inf) where
// the conic is not positive definite, kappa passes 5e5, or any value is not
// finite, so such a slot is never culled. Its plain copy,
// rasterize_kernels.py:slot_box_plain, is held against the walk's alpha by
// tests/test_torch_replay.py.
__device__ __forceinline__ float4 slot_box(const float* g) {
  const float inf = __int_as_float(0x7f800000);
  const float mx = g[0], my = g[1], ca = g[2], cb = g[3], cc = g[4], o = g[5];
  if (o < kAlphaMin) return make_float4(inf, -inf, inf, -inf);
  const float4 all = make_float4(-inf, inf, -inf, inf);
  const float det = static_cast<float>(static_cast<double>(ca) * cc -
                                       static_cast<double>(cb) * cb);
  const float r = kCullEps * ((fmaxf(ca, cc) + fabsf(cb)) * (ca + cc) / det);
  if (!(ca > 0.0f && cc > 0.0f && det > 0.0f && r <= 0.5f)) return all;
  const float lvl = (logf(o / kAlphaMin) + 1e-5f) / (1.0f - r) * 1.0001f;
  const float ex = sqrtf(2.0f * lvl * cc / det);
  const float ey = sqrtf(2.0f * lvl * ca / det);
  const float hx = ex + (ex * 1e-4f + fabsf(mx) * 2.4e-7f + 0.015625f);
  const float hy = ey + (ey * 1e-4f + fabsf(my) * 2.4e-7f + 0.015625f);
  const float4 b = make_float4(mx - hx, mx + hx, my - hy, my + hy);
  if (!(isfinite(b.x) && isfinite(b.y) && isfinite(b.z) && isfinite(b.w)))
    return all;
  return b;
}

// Reduce-scatter of N values per lane over the 32 lanes of a warp (call with
// OFF = 16): at each xor offset a lane keeps half of what it holds and adds
// its partner's copy of that half, then, once it holds one value, adds its
// partner's whole. The xor partners are the pairs the shuffle-down tree
// (offsets 16, 8, 4, 2, 1) adds, and float addition commutes, so each sum is
// bit for bit the tree's. Afterwards lane l holds the warp's sum of value
// l >> 1 (N = 16, lanes 2i and 2i + 1 alike) or of value l (N = 32), in
// v[0]: 16 shuffles for 16 values, where the tree takes 5 per value.
template <int N, int OFF>
__device__ __forceinline__ void reduce_scatter(float* v, int wl) {
  if constexpr (OFF > 0) {
    if constexpr (N > 1) {
      constexpr int H = N / 2;
      const bool up = (wl & OFF) != 0;
#pragma unroll
      for (int j = 0; j < H; ++j) {
        const float send = up ? v[j] : v[j + H];
        const float keep = up ? v[j + H] : v[j];
        v[j] = keep + __shfl_xor_sync(kFull, send, OFF);
      }
      reduce_scatter<H, OFF / 2>(v, wl);
    } else {
      v[0] = v[0] + __shfl_xor_sync(kFull, v[0], OFF);
      reduce_scatter<1, OFF / 2>(v, wl);
    }
  }
}

// Staging of both walks: asynchronous copies from device memory into
// shared memory, so that chunk i + 1 lands while the walk works on chunk
// i. All are Hopper (sm_90) instructions issued by inline PTX.
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Every thread copies elements threadIdx.x, + kPix, ... of [0, count) by
// 4-byte cp.async, then commits them as one group (possibly empty).
__device__ __forceinline__ void copy_async_4(float* dst, const float* src,
                                             int count) {
  for (int i = threadIdx.x; i < count; i += kPix)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                     smem_u32(dst + i)),
                 "l"(src + i)
                 : "memory");
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar))
               : "memory");
}

// One thread: a bulk copy (the TMA's 1-D form) of `bytes` from src to dst,
// both 16-byte aligned, bytes a multiple of 16; its completion is the
// phase of `bar`. The fence orders the walk's earlier reads of dst (generic
// proxy) before the copy's writes (async proxy).
__device__ __forceinline__ void copy_bulk(float* dst, const float* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Waits until phase `parity` of bar has completed.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  unsigned ok = 0;
  while (!ok)
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(ok)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
}

// The staging of both walks, carved from the dynamic shared memory: two
// mbarriers (one per buffer, the bulk path's), two chunks' warp masks (one
// bit per warp and slot, `words` words per warp and chunk) and two buffers
// of rows, in that order, so the rows start 16-byte aligned.
struct Staging {
  unsigned long long* bar;  // [2]
  unsigned* smask;          // [2][kWarps][words]
  float* sbuf;              // [2][chunk, n_fields]
  int words;
};

__device__ __forceinline__ Staging staging_of(float* smem, int chunk) {
  Staging s;
  s.words = (chunk + 31) / 32;
  s.bar = reinterpret_cast<unsigned long long*>(smem);
  s.smask = reinterpret_cast<unsigned*>(smem + 4);
  s.sbuf = smem + 4 + 2 * kWarps * s.words;
  return s;
}

// Called by every thread before the first stage_chunk.
template <bool kBulk>
__device__ __forceinline__ void staging_init(const Staging& s) {
  if constexpr (kBulk) {
    if (threadIdx.x == 0) {
      mbar_init(&s.bar[0]);
      mbar_init(&s.bar[1]);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }
}

// Starts copying chunk i of a run of cnt rows into buffer i % 2. kBulk:
// the chunk arrives by one bulk copy, which needs the run's first row and
// every chunk of rows 16-byte aligned (the dense block, whose chunk starts
// at (t K + base) * n_fields floats, when chunk % 4 == 0 and the block is);
// otherwise each thread copies every kPix-th float by 4-byte cp.async, which
// takes any offset (a stream run starts at tstart[t] * n_fields floats).
template <bool kBulk>
__device__ __forceinline__ void stage_chunk(const Staging& s,
                                            const float* __restrict__ run,
                                            int n_fields, int cnt, int chunk,
                                            int i) {
  const int base = i * chunk;
  const int n = min(chunk, cnt - base);
  float* dst = s.sbuf + (i & 1) * chunk * n_fields;
  const float* src = run + static_cast<long long>(base) * n_fields;
  if constexpr (kBulk) {
    // n rounded up to 4 rows keeps the size a multiple of 16 bytes; the
    // rows past n lie inside the chunk and are never read
    if (threadIdx.x == 0)
      copy_bulk(dst, src, static_cast<unsigned>((n + 3) & ~3) * n_fields * 4,
                &s.bar[i & 1]);
  } else {
    copy_async_4(dst, src, n * n_fields);
  }
}

// Waits for chunk i, then sets the warps' masks of its slots: thread
// k % kPix computes slot k's cull box (slot_box, from the staged row) and
// tests it against the 16x2 pixel rectangle of each of the 8 warps; ballots
// turn the tests into one bit per (warp, slot), 32 slots to a word. A slot
// whose box misses a warp's rectangle has none of that warp's pixels at
// alpha >= 1/255, so the warp may skip it. tx, ty: the tile's first pixel.
// kGroup (the group entries of the dense kernels): thread k first writes
// slot k's opacity into its staged row, gopac[ids[k]] (the group's opacity
// of the slot's splat), so the box and the walk see the group's opacity;
// the next barrier of the walk publishes the write to every thread.
template <bool kBulk, bool kGroup = false>
__device__ __forceinline__ void cull_chunk(const Staging& s, int n_fields,
                                           int cnt, int chunk, int i, int tx,
                                           int ty,
                                           const int* __restrict__ ids = nullptr,
                                           const float* __restrict__ gopac = nullptr) {
  const int lane = threadIdx.x;
  const int warp = lane / 32;
  const int n = min(chunk, cnt - i * chunk);
  float* srow = s.sbuf + (i & 1) * chunk * n_fields;
  if constexpr (kBulk) {
    mbar_wait(&s.bar[i & 1], (i >> 1) & 1);
  } else {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();  // every thread's copies of the chunk
  }
  unsigned* mask = s.smask + (i & 1) * kWarps * s.words;
  const float rx0 = static_cast<float>(tx);
  const float rx1 = static_cast<float>(tx + kTile - 1);
  for (int k0 = 0; k0 < n; k0 += kPix) {
    const int k = k0 + lane;
    unsigned meets = 0;  // bit w: warp w's rectangle meets slot k's box
    if (k < n) {
      if constexpr (kGroup) srow[k * n_fields + 5] = gopac[ids[i * chunk + k]];
      const float4 b = slot_box(srow + k * n_fields);
      if (!(rx1 < b.x || rx0 > b.y)) {
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
          // warp w's pixels: rows 2w and 2w + 1 of the tile
          const float ry0 = static_cast<float>(ty + 2 * w);
          const float ry1 = ry0 + 1.0f;
          if (!(ry1 < b.z || ry0 > b.w)) meets |= 1u << w;
        }
      }
    }
    const int word = k0 / 32 + warp;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const unsigned bits = __ballot_sync(kFull, (meets >> w) & 1u);
      if (lane % 32 == 0 && word < s.words) mask[w * s.words + word] = bits;
    }
  }
}

// Dynamic shared memory of the staging, in bytes: two mbarriers, two
// chunks' warp masks and two buffers of rows. It is all blend_run_fwd uses.
inline size_t fwd_smem_bytes(int chunk, int n_fields) {
  return 16 + 2 * static_cast<size_t>(kWarps) * ((chunk + 31) / 32) * 4 +
         2 * static_cast<size_t>(chunk) * n_fields * sizeof(float);
}

// Forward blend of one run, chunk by chunk through two shared-memory
// buffers (stage_chunk): while the walk evaluates chunk i out of one, chunk
// i + 1 is copied into the other.
//
// Warp cull (cull_chunk): once a chunk has landed, one bit per (warp,
// slot). The walk of a warp then visits only its set bits, in slot order: a
// slot whose box misses the warp's rectangle costs it nothing, since none of
// its pixels could pass 1/255, composite or stop there. So the outputs are
// bit for bit those of the walk without the cull. A pixel that stops leaves
// the walk, so a warp whose 32 pixels have all stopped leaves the chunk
// together; the CTA stops at the next chunk when all 256 have
// (__syncthreads_and).
//
// The box tests of chunk i + 1 run right after the walk of chunk i, so one
// barrier per chunk (two on the cp.async path, whose rows come from every
// thread) orders the staging, the masks and the walk. KC: the accumulators
// a thread holds, C <= KC <= kMaxC. tile: the image tile whose pixels this
// CTA shades. accum: this tile's [C, 256] block; t_final: its [256] row.
// kGroup, ids, gopac: the run's splat ids and a group's opacity by splat id,
// which replace the rows' opacity (cull_chunk). Dynamic shared memory:
// fwd_smem_bytes.
template <int KC, bool kBulk, bool kGroup = false>
__device__ __forceinline__ void blend_run_fwd(
    const float* __restrict__ run, int n_fields, int cnt, int tile,
    int grid_x, int chunk, float* __restrict__ accum,
    float* __restrict__ t_final, const int* __restrict__ ids = nullptr,
    const float* __restrict__ gopac = nullptr) {
  static_assert(KC > 0 && KC <= kMaxC, "KC is at most kMaxC");
  extern __shared__ __align__(16) float smem[];
  const Staging st = staging_of(smem, chunk);
  const int lane = threadIdx.x;
  const int warp = lane / 32;
  const int C = n_fields - 6;
  const int tx = (tile % grid_x) * kTile;
  const int ty = (tile / grid_x) * kTile;
  // integer pixel coordinates (rasterize_pallas.py:_pixels), not +0.5
  const float px = static_cast<float>(tx + lane % kTile);
  const float py = static_cast<float>(ty + lane / kTile);
  staging_init<kBulk>(st);

  float T = 1.0f;
  int done = 0;
  float acc[KC];
#pragma unroll
  for (int c = 0; c < KC; ++c) acc[c] = 0.0f;

  if (cnt > 0) {
    stage_chunk<kBulk>(st, run, n_fields, cnt, chunk, 0);
    cull_chunk<kBulk, kGroup>(st, n_fields, cnt, chunk, 0, tx, ty, ids, gopac);
  }
  int i = 0;
  for (int base = 0; base < cnt; base += chunk, ++i) {
    // Every pixel stopped: the tile is finished. This is also the barrier
    // after which chunk i's masks are set and chunk i - 1's rows and masks
    // no longer read, so chunk i + 1 may overwrite them. No copy is in
    // flight here.
    if (__syncthreads_and(done)) break;
    const bool next = base + chunk < cnt;
    if (next) stage_chunk<kBulk>(st, run, n_fields, cnt, chunk, i + 1);
    if (!done) {
      const int n = min(chunk, cnt - base);
      const float* srow = st.sbuf + (i & 1) * chunk * n_fields;
      const unsigned* mask = st.smask + ((i & 1) * kWarps + warp) * st.words;
      for (int q = 0; q < (n + 31) / 32; ++q) {
        for (unsigned m = mask[q]; m != 0; m &= m - 1) {
          const float* g = srow + (q * 32 + __ffs(m) - 1) * n_fields;
          const float dx = g[0] - px;
          const float dy = g[1] - py;
          const float power =
              -0.5f * (g[2] * dx * dx + g[4] * dy * dy) - g[3] * dx * dy;
          const float gauss = expf(fminf(power, 0.0f));
          const float araw = power <= 0.0f ? g[5] * gauss : 0.0f;
          const float a = fminf(araw, kAlphaMax);
          if (!(a >= kAlphaMin)) continue;
          const float t_next = T * (1.0f - a);
          if (t_next < kTEps) {
            done = 1;
            break;
          }
          const float w = a * T;
#pragma unroll
          for (int c = 0; c < KC; ++c)
            if (c < C) acc[c] += g[6 + c] * w;
          T = t_next;
        }
        if (done) break;
      }
    }
    if (next)
      cull_chunk<kBulk, kGroup>(st, n_fields, cnt, chunk, i + 1, tx, ty, ids,
                                gopac);
  }

#pragma unroll
  for (int c = 0; c < KC; ++c)
    if (c < C) accum[c * kPix + lane] = acc[c];
  t_final[lane] = T;
}

// The payload channels a backward walk holds for C (C <= KC), so that the
// C = 4 color pass runs 4 channels' terms per composited pair, not 10; the
// values per lane its butterfly sums, NV: 16 while 6 + KC fields fit, else
// 32; and the CTAs per SM it is compiled for (__launch_bounds__): 4 for the
// 16-value walks (61-64 registers), which ran faster on the H100 than 3 CTAs
// and within 2.5% of 5, faster for K6 and slower for K2 and K4 (the walk
// waits on long dependent chains: expf, two divisions, the butterfly;
// PERF.md); 3 for the 32-value walk, which would spill more.
inline int bwd_channels(int C) {
  return C <= 4 ? 4 : C <= 8 ? 8 : C <= 10 ? 10 : kMaxC;
}
__host__ __device__ constexpr int bwd_values(int kc) {
  return kc + 6 <= 16 ? 16 : 32;
}
constexpr int bwd_min_blocks(int kc) { return bwd_values(kc) == 16 ? 4 : 3; }

// The accumulators a forward walk holds for C payload channels, and the
// CTAs per SM it is compiled for (__launch_bounds__): 5 for the 4- and
// 8-channel walks, which at 6-8 CTAs spill and ran no faster on the H100
// (the walk waits on long dependent chains: the quadratic form, expf, the
// transmittance); 4 for the 16-channel walk.
inline int fwd_channels(int C) { return C <= 4 ? 4 : C <= 8 ? 8 : kMaxC; }
constexpr int fwd_min_blocks(int kc) { return kc == kMaxC ? 4 : 5; }

// Backward replay of one run: the forward's walk again, with the suffix form
// of the blend's derivative, which needs no back-to-front pass and no stored
// per-slot state:
//   ga_total = sum_c g_accum[c] * accum[c]            (per pixel, once)
//   gc       = sum_c g_accum[c] * payload[c]          (per slot and pixel)
//   b_inc   += w * gc                                 (inclusive running sum)
//   d_alpha  = T_prev * gc - (ga_total - b_inc) / (1 - a)
//              - g_t * t_final / (1 - a)              (1 - a floored at 0.01)
// d_alpha is zero where alpha was clamped at 0.99 and for pixels that had
// stopped. From it: d_power = a * d_alpha, the conic and mean2d gradients of
// the quadratic form, d_opacity = d_alpha * exp(power), d_payload =
// w * g_accum. Row k of d_run gets the sum of the 256 pixels' terms for slot
// k, so the rows repeat bit for bit (no atomics).
//
// Staging and cull are the forward's: chunk i + 1 is copied into the second
// buffer while chunk i is walked (kBulk as in blend_run_fwd), and once a
// chunk lands, one bit per (warp, slot) comes from ballots on the staged
// rows' boxes. Each warp walks only its set bits, in slot order. For each,
// the warp's sum of every field: reduce_scatter over its 32 pixels, or,
// where one pixel composites, that pixel's value + 0 (what the sum gives).
// A warp in which no pixel composites the slot, or whose pixels have all
// stopped, writes no partial and clears its bit, as for a culled slot: its
// partial would be zero.
//
// Row k is then the partials of the warps whose bit is set, added in warp
// order, + 0 once where some warp's bit is clear, and +0 where none is set.
// That is bit for bit the sum of all 8 partials in warp order with +0 for
// each clear bit: adding +0 leaves every value but -0 as it was, so the two
// sums differ at most in the sign of a zero, and a sum that took a +0 is
// never -0 (the single + 0 at the end makes a -0 into +0 as well).
//
// Rows the walk does not reach (after every pixel stopped) are not
// written. Returns where the walk ended, the same in every thread: rows
// [0, return) of d_run hold the walk's rows, rows [return, cnt) are the
// caller's to fill. KC: the payload channels a thread holds, C <= KC
// (bwd_channels). accum/g_accum: this tile's [C, 256] blocks; t_final/g_t:
// its [256] rows. kGroup, ids, gopac: as for blend_run_fwd. Dynamic shared
// memory: bwd_smem_bytes.
template <int KC, bool kBulk, bool kGroup = false>
__device__ __forceinline__ int blend_run_bwd(
    const float* __restrict__ run, int n_fields, int cnt, int tile,
    int grid_x, int chunk, const float* __restrict__ accum,
    const float* __restrict__ t_final, const float* __restrict__ g_accum,
    const float* __restrict__ g_t, float* __restrict__ d_run,
    const int* __restrict__ ids = nullptr,
    const float* __restrict__ gopac = nullptr) {
  static_assert(KC > 0 && KC <= kMaxC, "KC is at most kMaxC");
  constexpr int NV = bwd_values(KC);  // values per lane in the butterfly
  constexpr int kF = 6 + KC;          // fields a lane computes
  extern __shared__ __align__(16) float smem[];
  const Staging st = staging_of(smem, chunk);
  float* part = st.sbuf + 2 * chunk * n_fields;  // [kWarps][chunk, n_fields]
  const int lane = threadIdx.x;
  const int warp = lane / 32;
  const int wl = lane % 32;
  const int C = n_fields - 6;
  const int tx = (tile % grid_x) * kTile;
  const int ty = (tile / grid_x) * kTile;
  // integer pixel coordinates (rasterize_pallas.py:_pixels), not +0.5
  const float px = static_cast<float>(tx + lane % kTile);
  const float py = static_cast<float>(ty + lane / kTile);

  float gacc[KC];
  float ga_total = 0.0f;
#pragma unroll
  for (int c = 0; c < KC; ++c) {
    gacc[c] = 0.0f;
    if (c < C) {
      gacc[c] = g_accum[c * kPix + lane];
      const float term = gacc[c] * accum[c * kPix + lane];
      ga_total = c == 0 ? term : ga_total + term;
    }
  }
  const float gtt = g_t[lane] * t_final[lane];
  staging_init<kBulk>(st);

  float T = 1.0f;
  float bacc = 0.0f;
  int done = 0;
  if (cnt > 0) {
    stage_chunk<kBulk>(st, run, n_fields, cnt, chunk, 0);
    cull_chunk<kBulk, kGroup>(st, n_fields, cnt, chunk, 0, tx, ty, ids, gopac);
  }
  int i = 0;
  int base = 0;
  for (; base < cnt; base += chunk, ++i) {
    // Every pixel stopped: the rest of the run gets no gradient. This is
    // also the barrier after which chunk i's masks are set and chunk
    // i - 1's rows, masks and partials no longer read, so chunk i + 1 may
    // overwrite its buffer and this walk the partials. No copy is in
    // flight here.
    if (__syncthreads_and(done)) break;
    const bool next = base + chunk < cnt;
    if (next) stage_chunk<kBulk>(st, run, n_fields, cnt, chunk, i + 1);
    const int n = min(chunk, cnt - base);
    const float* srow = st.sbuf + (i & 1) * chunk * n_fields;
    unsigned* mask = st.smask + (i & 1) * kWarps * st.words;  // [kWarps][words]
    unsigned* wmask = mask + warp * st.words;  // this warp's, no other's
    for (int q = 0; q < (n + 31) / 32; ++q) {
      const unsigned m0 = wmask[q];
      // a warp whose pixels have all stopped walks no further slot (every
      // lane has read m0 once this vote returns)
      unsigned keep = __any_sync(kFull, !done) ? m0 : 0u;
      for (unsigned m = keep; m != 0; m &= m - 1) {
        const int j = __ffs(m) - 1;
        const float* g = srow + (q * 32 + j) * n_fields;
        float* out = part + (warp * chunk + q * 32 + j) * n_fields;
        float v[NV];
#pragma unroll
        for (int f = 0; f < NV; ++f) v[f] = 0.0f;
        bool contrib = false;
        if (!done) {
          const float dx = g[0] - px;
          const float dy = g[1] - py;
          const float power =
              -0.5f * (g[2] * dx * dx + g[4] * dy * dy) - g[3] * dx * dy;
          const float gauss = expf(fminf(power, 0.0f));
          const float araw = power <= 0.0f ? g[5] * gauss : 0.0f;
          const float a = fminf(araw, kAlphaMax);
          if (a >= kAlphaMin) {
            const float t_next = T * (1.0f - a);
            if (t_next < kTEps) {
              done = 1;
            } else {
              contrib = true;
              const float w = a * T;
              float gc = 0.0f;
#pragma unroll
              for (int c = 0; c < KC; ++c) {
                if (c < C) {
                  const float term = g[6 + c] * gacc[c];
                  gc = c == 0 ? term : gc + term;
                }
              }
              bacc = bacc + w * gc;
              const float one_m_a = fmaxf(1.0f - a, kMinOneMinusA);
              float d_alpha =
                  T * gc - (ga_total - bacc) / one_m_a - gtt / one_m_a;
              // min(0.99, .) has no gradient where it clamped
              if (!(araw < kAlphaMax)) d_alpha = 0.0f;
              const float d_power = a * d_alpha;
              const float ca = g[2], cb = g[3], cc = g[4];
              v[0] = d_power * -(ca * dx + cb * dy);
              v[1] = d_power * -(cc * dy + cb * dx);
              v[2] = d_power * (-0.5f * dx * dx);
              v[3] = d_power * (-dx * dy);
              v[4] = d_power * (-0.5f * dy * dy);
              v[5] = d_alpha * gauss;
#pragma unroll
              for (int c = 0; c < KC; ++c)
                if (c < C) v[6 + c] = w * gacc[c];
              T = t_next;
            }
          }
        }
        const unsigned who = __ballot_sync(kFull, contrib);
        if (who == 0) {
          keep &= ~(1u << j);  // a zero partial: counted as culled
        } else if ((who & (who - 1)) == 0) {
          // one pixel composites: the warp's sum of each field is its value
          // plus the other lanes' zeros, which only turns -0 into +0
          if (contrib) {
#pragma unroll
            for (int f = 0; f < kF; ++f)
              if (f < n_fields) out[f] = v[f] + 0.0f;
          }
        } else {
          reduce_scatter<NV, 16>(v, wl);
          const int f = NV == 16 ? wl >> 1 : wl;
          if ((NV == 32 || (wl & 1) == 0) && f < n_fields) out[f] = v[0];
        }
      }
      if (wl == 0 && keep != m0) wmask[q] = keep;
    }
    __syncthreads();
    // each (slot, field): the partials of the warps whose bit is set, in
    // warp order
    float* dst = d_run + static_cast<long long>(base) * n_fields;
    for (int e = lane; e < n * n_fields; e += kPix) {
      const int k = e / n_fields;
      unsigned set = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w)
        set |= ((mask[w * st.words + (k >> 5)] >> (k & 31)) & 1u) << w;
      float s = 0.0f;
      if (set != 0) {
        s = part[(__ffs(set) - 1) * chunk * n_fields + e];
        for (unsigned r = set & (set - 1); r != 0; r &= r - 1)
          s = s + part[(__ffs(r) - 1) * chunk * n_fields + e];
        if (set != (1u << kWarps) - 1) s = s + 0.0f;
      }
      dst[e] = s;
    }
    if (next)
      cull_chunk<kBulk, kGroup>(st, n_fields, cnt, chunk, i + 1, tx, ty, ids,
                                gopac);
  }
  return min(base, cnt);
}

// Dynamic shared memory of blend_run_bwd, in bytes: the forward's staging
// and the 8 warps' partials of one chunk.
inline size_t bwd_smem_bytes(int chunk, int n_fields) {
  return fwd_smem_bytes(chunk, n_fields) +
         static_cast<size_t>(kWarps) * chunk * n_fields * sizeof(float);
}

}  // namespace og_blend
