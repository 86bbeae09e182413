// The window ring of the per-sample window-attention kernels
// (window_attention_fwd.cu, window_attention_bwd.cu): each includes it and is
// built into a library of its own.
//
// A CTA stages the window of its sample through a ring of kStages tiles of
// `rows` window rows of K and then V. Tile t goes into stage t % kStages.
// Where the tables are 16-byte aligned and D is a multiple of 4, one warp
// sends a bulk (TMA) copy per row, and tile t completes on the stage's
// mbarrier, phase t / kStages; the next tile's copies are in flight while the
// current one is used. Elsewhere all threads copy 4-byte cp.async pieces and
// wait for them. The caller ends each tile with a __syncthreads(), which
// frees its stage for the tile kStages later.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kMaskFill = -1e20f;
constexpr int kMaxThreads = 512;
constexpr size_t kMaxSmem = 232448;  // 227 KB: the most a CTA may have
constexpr unsigned kFull = 0xffffffffu;
// Tiles in the ring. On the card deeper rings were slower: the CTAs that
// share an SM already overlap one another's copies and arithmetic.
constexpr int kStages = 2;
// Floats at the start of shared memory that hold the ring's barriers (two
// 8-byte mbarriers, padded so that the ring starts 32-byte aligned).
constexpr int kBarFloats = 8;

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

// Floats of the ring in shared memory.
__host__ __device__ __forceinline__ size_t ring_floats(int D, int rows) {
  return (size_t)kStages * 2 * rows * row_stride(D);
}

inline bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// The window of one sample (rows clamped to their tables) and the ring it is
// staged through.
struct WindowRing {
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

  // K rows of tile t's stage; its V rows follow `rows * row_stride(D)` floats on.
  __device__ __forceinline__ float* stage(int t) const {
    return ring + (size_t)(t % kStages) * 2 * rows * row_stride(D);
  }

  // Called by one warp: a bulk copy per row of tile t's K and V rows, a lane
  // per row, completing on the stage's barrier.
  __device__ __forceinline__ void issue_bulk(int t) const {
    const int stride = row_stride(D);
    const int lane = threadIdx.x & 31;
    const int l0 = t * rows, n = min(rows, L - l0);
    uint64_t* bar = bars + t % kStages;
    float* dst = stage(t);
    if (lane == 0) mbar_expect_tx(bar, (unsigned)(2 * n * D) * sizeof(float));
    __syncwarp();
    for (int i = lane; i < 2 * n; i += 32) {
      const int kv = i & 1, r = i >> 1;
      bulk_copy(dst + ((size_t)kv * rows + r) * stride, row(kv, l0 + r),
                (unsigned)D * sizeof(float), bar);
    }
  }

  // Called by all threads, before anything else of the kernel: initialises
  // the barriers, waits at a block-wide barrier for that, and sends the first
  // tile's copies.
  __device__ __forceinline__ void start() const {
    if (threadIdx.x == 0) {
      for (int i = 0; i < kStages; ++i) mbar_init(bars + i, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (vec && threadIdx.x < 32)
      for (int t = 0; t < min(kStages - 1, n_tiles()); ++t) issue_bulk(t);
  }

  // Called by all threads at the top of tile t: sends the copies of tile
  // t + kStages - 1 into the stage that tile t - 1 freed and waits for tile
  // t's, or, where rows are not 16-byte aligned, copies tile t in 4-byte
  // pieces and waits for them. Returns tile t's K rows.
  __device__ __forceinline__ const float* acquire(int t) const {
    if (vec) {
      const int tn = t + kStages - 1;
      if (threadIdx.x < 32 && tn < n_tiles()) issue_bulk(tn);
      mbar_wait(bars + t % kStages, (unsigned)(t / kStages) & 1u);
    } else {
      const int stride = row_stride(D);
      const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, n_warps = blockDim.x >> 5;
      const int l0 = t * rows, n = min(rows, L - l0);
      float* dst = stage(t);
      for (int i = warp; i < 2 * n; i += n_warps) {
        const int kv = i & 1, r = i >> 1;
        const float* src = row(kv, l0 + r);
        float* d = dst + ((size_t)kv * rows + r) * stride;
        for (int c = lane; c < D; c += 32) cp_async4(d + c, src + c);
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      __syncthreads();
    }
    return stage(t);
  }
};

}  // namespace
