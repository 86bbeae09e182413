// Episodic window attention, forward, grouped by worker, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_grouped_kernel` / `_pallas_forward_grouped` in
// etmppo_tpu/ops/pallas_window_attention.py. It computes what
// window_attention_fwd.cu computes. For sample b, with w = w_idx[b]:
//
//   window row l <  n_valid[b]:  timeline[w, start[b] + l]       (K and V)
//   window row l >= n_valid[b]:  pe[s_lo[b] + l]                 (K and V)
//   per head h:  out[b, h] = softmax(where(mask[b], q[b, h] . K[:, h], -1e20)
//                                    / sqrt(D)) . V[:, h]
//
// with the same quirks: the finite -1e20 fill (an all-masked row comes out
// uniform), the 1/sqrt(D) scale of the whole embedding, and reads clamped to
// the tables.
//
// The minibatch comes sorted by worker: `order` is a stable argsort of w_idx
// and `w_sorted` = w_idx[order] (the wrapper sorts, as the TPU wrapper does
// outside its kernel). The kernel reads each sample through `order` and
// writes its output straight back to row order[j], so no sorted copy of the
// inputs or the output is made.
//
// What bounds it on an H100: bytes. The per-sample kernel reads L rows of K
// and V per (sample, head), 2*B*L*D*4 B in all (742 MB at the Mortar Mayhem
// shape B=2048, L=118, D=384), mostly from L2. The TPU kernel stages a
// worker's whole timeline in VMEM once; here one worker's timeline (S=750
// rows x 384 x 4 B = 1.15 MB for K alone) is far over the 227 KB of shared
// memory a CTA can hold. So the staging unit is smaller: one CTA per (chunk of
// kRun consecutive sorted samples, head), one warp per sample. The chunk is
// cut where the worker changes into runs of one worker; for each run the CTA
// walks the union of the run's window rows in tiles of kTile rows, first in
// the timeline, then in the PE table, copies each tile of K (then of V) into
// shared memory once, and every sample of the run whose window meets the tile
// reads it there. A tile that no window of the run meets is skipped.
//
// Scores: a lane per window row, dotting the sample's query (shared memory,
// broadcast) with the tile row (row stride hd + 1 floats, so the lanes' rows
// fall in different banks). Softmax: the warp over the sample's L scores.
// Output: a lane per head dim (up to kMaxDimsPerLane per lane), summing
// p[l] * V[l] over the rows in registers.
//
// Built by nvcc into a shared library with a plain C interface and loaded with
// ctypes (etmppo_tpu_torch/ops/window_attention.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRun = kWarps;          // sorted samples per CTA, a warp each
constexpr int kTile = 64;             // rows per staged tile
constexpr int kMaxDimsPerLane = 8;    // head width up to 256
constexpr float kMaskFill = -1e20f;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// The window rows [la, lb) of one sample that come from one table (the
// timeline: [0, n_valid); the PE table: [n_valid, L)), and where row l lies in
// that table: clamp(base + l, 0, n - 1), as the per-sample kernel reads it.
struct Span {
  int base, la, lb, n;

  __device__ __forceinline__ int row(int l) const {
    return min(max(base + l, 0), n - 1);
  }
  // The first l in [la, lb) whose row is >= x (lb if none); rows grow with l.
  __device__ __forceinline__ int first_at(int x) const {
    if (x <= 0) return la;
    if (x > n - 1) return lb;
    return min(max(x - base, la), lb);
  }
};

__global__ void __launch_bounds__(kThreads) window_attention_fwd_grouped_kernel(
    const float* __restrict__ q, const float* __restrict__ tk,
    const float* __restrict__ tv, const float* __restrict__ pe_k,
    const float* __restrict__ pe_v, const int32_t* __restrict__ start,
    const int32_t* __restrict__ n_valid, const int32_t* __restrict__ s_lo,
    const uint8_t* __restrict__ mask, const int64_t* __restrict__ order,
    const int32_t* __restrict__ w_sorted, float* __restrict__ out, int B,
    int W, int S, int P, int L, int D, int H) {
  extern __shared__ float smem[];
  const int hd = D / H;
  const int stride = hd + 1;
  float* qs = smem;                    // [kRun][hd]   queries
  float* ps = qs + kRun * hd;          // [kRun][L]    scores, then probs
  float* tile = ps + kRun * L;         // [kTile][hd + 1]
  __shared__ int s_w[kRun];            // raw worker of each sample
  __shared__ int s_union[4];           // timeline lo/hi, PE lo/hi of the run

  const int h = blockIdx.y;
  const int col = h * hd;
  const int c0 = blockIdx.x * kRun;
  const int c1 = min(B, c0 + kRun);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int j = c0 + warp;             // this warp's sorted sample
  const bool has_sample = j < c1;

  int b = 0;
  Span tl{0, 0, 0, S}, pe{0, 0, 0, P};
  if (has_sample) {
    b = (int)order[j];
    const int nv = min(max((int)n_valid[b], 0), L);
    tl = Span{(int)start[b], 0, nv, S};
    pe = Span{(int)s_lo[b], nv, L, P};
    for (int d = lane; d < hd; d += 32) qs[warp * hd + d] = q[(size_t)b * D + col + d];
    if (lane == 0) s_w[warp] = w_sorted[j];
  }
  __syncthreads();

  const float sqrt_d = sqrtf((float)D);
  float* my_ps = ps + warp * L;
  const float* my_q = qs + warp * hd;

  for (int i0 = c0; i0 < c1;) {
    // The run [i0, i1) of one worker.
    const int w_raw = s_w[i0 - c0];
    int i1 = i0 + 1;
    while (i1 < c1 && s_w[i1 - c0] == w_raw) ++i1;
    const int w = min(max(w_raw, 0), W - 1);
    const bool mine = has_sample && j >= i0 && j < i1;

    // The union of the run's rows in each table.
    if (threadIdx.x == 0) {
      s_union[0] = S; s_union[1] = 0; s_union[2] = P; s_union[3] = 0;
    }
    __syncthreads();
    if (mine && lane == 0) {
      if (tl.la < tl.lb) {
        atomicMin(&s_union[0], tl.row(tl.la));
        atomicMax(&s_union[1], tl.row(tl.lb - 1) + 1);
      }
      if (pe.la < pe.lb) {
        atomicMin(&s_union[2], pe.row(pe.la));
        atomicMax(&s_union[3], pe.row(pe.lb - 1) + 1);
      }
    }
    __syncthreads();
    const int u_lo[2] = {s_union[0], s_union[2]};
    const int u_hi[2] = {s_union[1], s_union[3]};

    // Scores, tile by tile: timeline (src 0), then PE table (src 1).
    for (int src = 0; src < 2; ++src) {
      const Span& sp = src == 0 ? tl : pe;
      const float* table = src == 0 ? tk + (size_t)w * S * D : pe_k;
      for (int t0 = u_lo[src]; t0 < u_hi[src]; t0 += kTile) {
        const int rows = min(kTile, u_hi[src] - t0);
        const int la = mine ? sp.first_at(t0) : 0;
        const int lb = mine ? sp.first_at(t0 + rows) : 0;
        if (!__syncthreads_or(la < lb)) continue;
        for (int e = threadIdx.x; e < rows * hd; e += kThreads) {
          const int r = e / hd;
          const int d = e - r * hd;
          tile[r * stride + d] = __ldg(table + (size_t)(t0 + r) * D + col + d);
        }
        __syncthreads();
        for (int l = la + lane; l < lb; l += 32) {
          const float* k = tile + (sp.row(l) - t0) * stride;
          float acc = 0.f;
          for (int d = 0; d < hd; ++d) acc = fmaf(my_q[d], k[d], acc);
          my_ps[l] = acc;
        }
        __syncthreads();
      }
    }

    // Softmax over the sample's L scores, after the mask fill and the scale.
    if (mine) {
      const uint8_t* mrow = mask + (size_t)b * L;
      float m = -INFINITY;
      for (int l = lane; l < L; l += 32) {
        const float s = (mrow[l] ? my_ps[l] : kMaskFill) / sqrt_d;
        my_ps[l] = s;
        m = fmaxf(m, s);
      }
      m = warp_max(m);
      float sum = 0.f;
      for (int l = lane; l < L; l += 32) {
        const float e = expf(my_ps[l] - m);
        my_ps[l] = e;
        sum += e;
      }
      const float inv = 1.f / warp_sum(sum);
      for (int l = lane; l < L; l += 32) my_ps[l] *= inv;
      __syncwarp();
    }

    // out = sum_l p[l] V[l], tile by tile, in registers.
    float acc[kMaxDimsPerLane];
#pragma unroll
    for (int k = 0; k < kMaxDimsPerLane; ++k) acc[k] = 0.f;
    for (int src = 0; src < 2; ++src) {
      const Span& sp = src == 0 ? tl : pe;
      const float* table = src == 0 ? tv + (size_t)w * S * D : pe_v;
      for (int t0 = u_lo[src]; t0 < u_hi[src]; t0 += kTile) {
        const int rows = min(kTile, u_hi[src] - t0);
        const int la = mine ? sp.first_at(t0) : 0;
        const int lb = mine ? sp.first_at(t0 + rows) : 0;
        if (!__syncthreads_or(la < lb)) continue;
        for (int e = threadIdx.x; e < rows * hd; e += kThreads) {
          const int r = e / hd;
          const int d = e - r * hd;
          tile[r * stride + d] = __ldg(table + (size_t)(t0 + r) * D + col + d);
        }
        __syncthreads();
        for (int l = la; l < lb; ++l) {
          const float p = my_ps[l];
          const float* v = tile + (sp.row(l) - t0) * stride;
#pragma unroll
          for (int k = 0; k < kMaxDimsPerLane; ++k) {
            const int d = lane + 32 * k;
            if (d < hd) acc[k] = fmaf(p, v[d], acc[k]);
          }
        }
        __syncthreads();
      }
    }
    if (mine) {
#pragma unroll
      for (int k = 0; k < kMaxDimsPerLane; ++k) {
        const int d = lane + 32 * k;
        if (d < hd) out[(size_t)b * D + col + d] = acc[k];
      }
    }
    i0 = i1;
    __syncthreads();  // s_union is reset for the next run
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
// Pointers are device pointers to contiguous arrays:
//   q (B, D), tk/tv (W, S, D), pe_k/pe_v (P, D), out (B, D): float32;
//   w_idx/start/n_valid/s_lo (B,): int32; mask (B, L): uint8 (0/1);
//   order (B,): int64, a stable argsort of w_idx; w_sorted (B,): int32,
//   w_idx[order].
// w_idx itself is not read (w_sorted holds it in sorted order); it is in the
// signature so that the grouped and per-sample forwards take the same inputs.
extern "C" int window_attention_fwd_grouped(
    const void* q, const void* tk, const void* tv, const void* pe_k,
    const void* pe_v, const void* w_idx, const void* start,
    const void* n_valid, const void* s_lo, const void* mask, const void* order,
    const void* w_sorted, void* out, int B, int W, int S, int P, int L, int D,
    int H, void* stream) {
  (void)w_idx;
  if (B <= 0 || W <= 0 || S <= 0 || P <= 0 || L <= 0 || H <= 0 || D % H != 0 ||
      D / H > 32 * kMaxDimsPerLane)
    return (int)cudaErrorInvalidValue;
  const int hd = D / H;
  const size_t smem =
      (size_t)(kRun * hd + kRun * L + kTile * (hd + 1)) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        window_attention_fwd_grouped_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((unsigned)((B + kRun - 1) / kRun), (unsigned)H);
  window_attention_fwd_grouped_kernel<<<grid, kThreads, smem,
                                        (cudaStream_t)stream>>>(
      (const float*)q, (const float*)tk, (const float*)tv, (const float*)pe_k,
      (const float*)pe_v, (const int32_t*)start, (const int32_t*)n_valid,
      (const int32_t*)s_lo, (const uint8_t*)mask, (const int64_t*)order,
      (const int32_t*)w_sorted, (float*)out, B, W, S, P, L, D, H);
  return (int)cudaGetLastError();
}
