// The ring of row tiles shared by the window-attention kernels: the
// per-sample pair (window_attention_fwd.cu, window_attention_bwd.cu) and the
// grouped pair (window_attention_fwd_grouped.cu,
// window_attention_bwd_grouped.cu). Each includes it and is built into a
// library of its own.
//
// A CTA stages rows of K and V through a ring of `depth` tiles of `rows` rows
// each, K rows then V rows (the per-sample kernels' depth is kStages, the
// grouped kernels' a template parameter). Tile t goes into stage t % depth. Where the
// tables are 16-byte aligned and D is a multiple of 4, one warp sends a bulk
// (TMA) copy per row, and tile t completes on the stage's mbarrier, phase
// t / depth; the next depth - 1 tiles' copies are in flight while the current
// one is used. Elsewhere all threads copy 4-byte cp.async pieces and wait for them.
// The caller ends each tile with a __syncthreads(), which frees its stage for
// the tile `depth` later.
//
// Two ways to address the tiles:
// * WindowRing (per-sample kernels): the window of one sample, tile t its
//   window rows [t * rows, (t + 1) * rows), each clamped to its table.
// * RangeRing (grouped kernels): ranges of table rows. Tile t is rows
//   [row0, row0 + rows) of one table, from a list of tiles in shared memory:
//   first tiles of the run's worker's timeline, then of the PE table.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kMaskFill = -1e20f;
constexpr int kMaxThreads = 512;
constexpr size_t kMaxSmem = 232448;  // 227 KB: the most a CTA may have
constexpr unsigned kFull = 0xffffffffu;
// Tiles in the per-sample kernels' ring. On the card deeper rings were slower
// for them: the CTAs that share an SM already overlap one another's copies
// and arithmetic.
constexpr int kStages = 2;
// The deepest ring, and the floats at the start of shared memory that hold
// its barriers (up to four 8-byte mbarriers; the ring starts 32-byte
// aligned).
constexpr int kMaxDepth = 4;
constexpr int kBarFloats = 8;
static_assert(kMaxDepth * sizeof(uint64_t) <= kBarFloats * sizeof(float),
              "the ring's barriers outgrow their floats");

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

// Arrives on the barrier and adds `bytes` to the transfers its phase waits for.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes) : "memory");
}

// Waits until the barrier's phase of this parity has completed. A wait that
// never ends (a bug, not a slow copy) traps instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const unsigned a = smem_u32(bar);
  for (unsigned polls = 0;; ++polls) {
    unsigned done;
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
    if (done) return;
    if (polls > (1u << 26)) __trap();
  }
}

// One bulk (TMA) copy of `bytes` (a multiple of 16, both ends 16-byte
// aligned) from global to shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_copy(float* dst, const float* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar)) : "memory");
}

// Floats between the starts of two rows of a staged tile: D rounded up to 4,
// plus 4, so that rows start 16-byte aligned and lanes that read the same
// column of neighbouring rows fall in different banks.
__host__ __device__ __forceinline__ int row_stride(int D) { return ((D + 3) & ~3) + 4; }

// Floats of the per-sample kernels' ring in shared memory.
__host__ __device__ __forceinline__ size_t ring_floats(int D, int rows) {
  return (size_t)kStages * 2 * rows * row_stride(D);
}

inline bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// One warp: a bulk copy per row of a tile's n K and V rows (row r's from
// src(kv, r)) into stage `dst` (rows `stride` floats apart), a lane per row,
// completing on `bar`.
template <class Src>
__device__ __forceinline__ void ring_issue_rows(float* dst, uint64_t* bar, int rows, int n,
                                                int D, int stride, const Src& src) {
  const int lane = threadIdx.x & 31;
  if (lane == 0) mbar_expect_tx(bar, (unsigned)(2 * n * D) * sizeof(float));
  __syncwarp();
  for (int i = lane; i < 2 * n; i += 32) {
    const int kv = i & 1, r = i >> 1;
    bulk_copy(dst + ((size_t)kv * rows + r) * stride, src(kv, r), (unsigned)D * sizeof(float),
              bar);
  }
}

// All threads: 4-byte cp.async pieces of a tile's n K and V rows into stage
// `dst` (rows `stride` floats apart), then a wait and a block-wide barrier.
template <class Src>
__device__ __forceinline__ void ring_copy4(float* dst, int rows, int n, int D, int stride,
                                           const Src& src) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, n_warps = blockDim.x >> 5;
  for (int i = warp; i < 2 * n; i += n_warps) {
    const int kv = i & 1, r = i >> 1;
    const float* s = src(kv, r);
    float* d = dst + ((size_t)kv * rows + r) * stride;
    for (int c = lane; c < D; c += 32) cp_async4(d + c, s + c);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
}

// The ring's protocol, for a ring type that has its depth kDepth, `bars`,
// `ring`, `rows`, `D`, `vec`, n_tiles(), tile_n(t) (rows in tile t),
// stride() (floats between two rows of a stage), issue(t, dst, bar) (one
// warp sends tile t's bulk copies into stage `dst`) and src(t, kv, r) (the
// source of row r of tile t in K (kv = 0) or V (kv = 1)).
template <class Ring>
__device__ __forceinline__ float* ring_stage(const Ring& g, int t) {
  return g.ring + (size_t)(t % Ring::kDepth) * 2 * g.rows * g.stride();
}

template <class Ring>
__device__ __forceinline__ void ring_issue(const Ring& g, int t) {
  g.issue(t, ring_stage(g, t), g.bars + t % Ring::kDepth);
}

// Called by all threads, before anything else that uses the ring:
// initialises the barriers, waits at a block-wide barrier for that, and sends
// the first tiles' copies.
template <class Ring>
__device__ __forceinline__ void ring_start(const Ring& g) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < Ring::kDepth; ++i) mbar_init(g.bars + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (g.vec && threadIdx.x < 32)
    for (int t = 0; t < min(Ring::kDepth - 1, g.n_tiles()); ++t) ring_issue(g, t);
}

// Called by all threads at the top of tile t: sends the copies of tile
// t + depth - 1 into the stage that tile t - 1 freed and waits for tile
// t's, or, where rows are not 16-byte aligned, copies tile t in 4-byte pieces
// and waits for them. Returns tile t's K rows; its V rows follow
// `rows * stride()` floats on.
template <class Ring>
__device__ __forceinline__ const float* ring_acquire(const Ring& g, int t) {
  float* dst = ring_stage(g, t);
  if (g.vec) {
    const int tn = t + Ring::kDepth - 1;
    if (threadIdx.x < 32 && tn < g.n_tiles()) ring_issue(g, tn);
    mbar_wait(g.bars + t % Ring::kDepth, (unsigned)(t / Ring::kDepth) & 1u);
  } else {
    ring_copy4(dst, g.rows, g.tile_n(t), g.D, g.stride(),
               [&](int kv, int r) { return g.src(t, kv, r); });
  }
  return dst;
}

// The window of one sample (rows clamped to their tables) and the ring it is
// staged through.
struct WindowRing {
  static constexpr int kDepth = kStages;
  const float* tk;
  const float* tv;
  const float* pe_k;
  const float* pe_v;
  int w, st, nv, slo, S, P, D, L, rows;
  bool vec;         // bulk copies (else 4-byte cp.async pieces)
  uint64_t* bars;   // [kStages]
  float* ring;      // [kStages][2][rows][row_stride(D)]

  // Row l of the window (all D columns) in K (kv = 0) or V (kv = 1), clamped
  // to its table.
  __device__ __forceinline__ const float* row(int kv, int l) const {
    if (l < nv) {
      const int r = min(max(st + l, 0), S - 1);
      return (kv ? tv : tk) + ((size_t)w * S + r) * D;
    }
    const int r = min(max(slo + l, 0), P - 1);
    return (kv ? pe_v : pe_k) + (size_t)r * D;
  }

  __device__ __forceinline__ int n_tiles() const { return (L + rows - 1) / rows; }
  __device__ __forceinline__ int tile_n(int t) const { return min(rows, L - t * rows); }
  __device__ __forceinline__ const float* src(int t, int kv, int r) const {
    return row(kv, t * rows + r);
  }
  __device__ __forceinline__ int stride() const { return row_stride(D); }
  // A bulk copy per row (a window's rows lie anywhere in their tables).
  __device__ __forceinline__ void issue(int t, float* dst, uint64_t* bar) const {
    ring_issue_rows(dst, bar, rows, tile_n(t), D, stride(),
                    [&](int kv, int r) { return src(t, kv, r); });
  }

  // K rows of tile t's stage; its V rows follow `rows * row_stride(D)` floats on.
  __device__ __forceinline__ float* stage(int t) const { return ring_stage(*this, t); }
  __device__ __forceinline__ void start() const { ring_start(*this); }
  __device__ __forceinline__ const float* acquire(int t) const { return ring_acquire(*this, t); }
};

// Floats of a range ring of `depth` tiles: rows lie D floats apart, as in
// their tables.
__host__ __device__ __forceinline__ size_t range_ring_floats(int D, int rows, int depth) {
  return (size_t)depth * 2 * rows * D;
}

// Ranges of table rows and the ring they are staged through. Tiles
// [0, n_first) are rows of the first table pair (k0/v0, rows up to hi0), the
// rest rows of the second (k1/v1, up to hi1); tile t starts at table row
// row0[t] and holds min(rows, hi - row0[t]) rows. Rows are never clamped: the
// caller lists only rows inside their tables. A tile's K rows (and its V
// rows) are one contiguous block of its table, staged as they lie there by
// one bulk copy each.
template <int Depth>
struct RangeRing {
  static constexpr int kDepth = Depth;
  const float* k0;
  const float* v0;
  const float* k1;
  const float* v1;
  const int* row0;  // [n_all] in shared memory
  int n_first, n_all, hi0, hi1, D, rows;
  bool vec;
  uint64_t* bars;   // [Depth]
  float* ring;      // [Depth][2][rows][D]

  __device__ __forceinline__ int n_tiles() const { return n_all; }
  __device__ __forceinline__ int stride() const { return D; }
  __device__ __forceinline__ int tile_n(int t) const {
    return min(rows, (t < n_first ? hi0 : hi1) - row0[t]);
  }
  __device__ __forceinline__ const float* src(int t, int kv, int r) const {
    const float* table = t < n_first ? (kv ? v0 : k0) : (kv ? v1 : k1);
    return table + (size_t)(row0[t] + r) * D;
  }
  __device__ __forceinline__ void issue(int t, float* dst, uint64_t* bar) const {
    if ((threadIdx.x & 31) == 0) {
      const unsigned bytes = (unsigned)(tile_n(t) * D) * sizeof(float);
      mbar_expect_tx(bar, 2 * bytes);
      bulk_copy(dst, src(t, 0, 0), bytes, bar);
      bulk_copy(dst + (size_t)rows * D, src(t, 1, 0), bytes, bar);
    }
  }
  __device__ __forceinline__ const float* acquire(int t) const { return ring_acquire(*this, t); }
  __device__ __forceinline__ void start() const { ring_start(*this); }
};

}  // namespace
