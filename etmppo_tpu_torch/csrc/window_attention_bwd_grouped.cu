// Episodic window attention, backward, grouped by worker and deterministic,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel `_grouped_bwd_kernel` / `_pallas_backward_grouped`
// in etmppo_tpu/ops/pallas_window_attention.py. It computes what
// window_attention_bwd.cu computes. Given the output gradient g (B, D), per
// sample b and head h:
//
//   p     = softmax(where(mask[b], q_h . K_h^T, -1e20) / sqrt(D))   (recomputed)
//   dp[l] = g_h . V_h[l]
//   ds[l] = p[l] * (dp[l] - sum_l' p[l'] dp[l']) / sqrt(D), zeroed where mask is
//           false (the VJP of the mask fill)
//   dq_h  = sum_l ds[l] K_h[l];  dK_h[l] = ds[l] q_h;  dV_h[l] = p[l] g_h
//
// dK/dV of window row l < n_valid[b] go to timeline row (w_idx[b], start[b] + l),
// those of row l >= n_valid[b] to PE row s_lo[b] + l; rows outside the tables
// are dropped, never clamped.
//
// Determinism. The TPU kernel walks the minibatch sorted by worker on its
// sequential grid and sums each worker's gradients in that order. Here no
// float is ever added atomically, and every gradient entry is summed by one
// thread in one fixed order, so two calls on one input give the same bits:
//
//   pass 1  one CTA per (sorted sample j, head): recomputes p and ds as the
//           per-sample backward does, writes dq[order[j]] (its own slice),
//           and writes p and ds to scratch, probs/dscores (B, H, L) in sorted
//           order (2 * B * H * L * 4 B: 7.7 MB at the Mortar Mayhem shape).
//   pass 2  output-stationary. A CTA per (worker, tile of kRows timeline rows,
//           head) owns those rows of dtk/dtv: a thread per head dim sums, for
//           each row, ds * q and p * g over that worker's sorted samples whose
//           window holds the row, in sorted order. The worker's samples are
//           the segment [seg[w], seg[w+1]) of the sorted minibatch. Rows that
//           no sample touches are written as zeros, so nothing is zeroed
//           beforehand. The PE rows are shared by all workers: a CTA per (tile
//           of PE rows, head, chunk of kPeChunk sorted samples) sums that
//           chunk into its own slice of the scratch part_k/part_v.
//   pass 3  dpk/dpv = the sum of the chunks' slices, in chunk order.
//
// A call launches the three passes on one stream; the wrapper counts a call
// as one launch of this kernel.
//
// What bounds it on an H100: bytes (the per-sample backward's count: the
// distinct K/V rows read once, dq and the whole gradient tables written).
// Pass 1 reads each window from L2 as the per-sample kernel does. Pass 2
// stages each chunk of candidate samples' indices in shared memory, skips the
// samples whose window misses its tile (most: a window holds 118 of a
// worker's 750 rows at the Mortar Mayhem shape), and reads q, g, p and ds of
// the rest, mostly from L1/L2.
//
// Built by nvcc into a shared library with a plain C interface and loaded with
// ctypes (etmppo_tpu_torch/ops/window_attention.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;      // pass 1
constexpr int kRows = 16;          // pass 2: rows per CTA, accumulated in registers
constexpr int kPeChunk = 128;      // pass 2: sorted samples per PE partial sum
constexpr int kReduceThreads = 256;
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

// Pass 1: p and ds of sorted sample j = blockIdx.x, head h = blockIdx.y, and
// dq of its row order[j]. Reads are clamped as in the forward.
__global__ void __launch_bounds__(kThreads) grouped_bwd_scores_kernel(
    const float* __restrict__ q, const float* __restrict__ tk,
    const float* __restrict__ tv, const float* __restrict__ pe_k,
    const float* __restrict__ pe_v, const int32_t* __restrict__ w_idx,
    const int32_t* __restrict__ start, const int32_t* __restrict__ n_valid,
    const int32_t* __restrict__ s_lo, const uint8_t* __restrict__ mask,
    const float* __restrict__ g, const int64_t* __restrict__ order,
    float* __restrict__ dq, float* __restrict__ probs,
    float* __restrict__ dscores, int W, int S, int P, int L, int D, int H) {
  extern __shared__ float smem[];
  const int j = blockIdx.x;
  const int h = blockIdx.y;
  const int hd = D / H;
  float* qs = smem;            // [hd] this head's query
  float* gs = qs + hd;         // [hd] this head's output gradient
  float* ps = gs + hd;         // [L]  scores, then probabilities
  float* ds = ps + L;          // [L]  dp, then ds

  const int b = (int)order[j];
  const int w = min(max((int)w_idx[b], 0), W - 1);
  const int st = start[b];
  const int nv = n_valid[b];
  const int slo = s_lo[b];
  const int col = h * hd;
  const uint8_t* mrow = mask + (size_t)b * L;

  for (int d = threadIdx.x; d < hd; d += blockDim.x) {
    qs[d] = q[(size_t)b * D + col + d];
    gs[d] = g[(size_t)b * D + col + d];
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  const float inv_sqrt_d = 1.f / sqrtf((float)D);
  const float sqrt_d = sqrtf((float)D);

  auto row_ptr = [&](const float* timeline, const float* pe, int l) {
    if (l < nv) return timeline + ((size_t)w * S + min(max(st + l, 0), S - 1)) * D + col;
    return pe + (size_t)min(max(slo + l, 0), P - 1) * D + col;
  };

  for (int l = warp; l < L; l += n_warps) {
    const float* k = row_ptr(tk, pe_k, l);
    const float* v = row_ptr(tv, pe_v, l);
    float s = 0.f, dp = 0.f;
    for (int d = lane; d < hd; d += 32) {
      s = fmaf(qs[d], __ldg(k + d), s);
      dp = fmaf(gs[d], __ldg(v + d), dp);
    }
    s = warp_sum(s);
    dp = warp_sum(dp);
    if (lane == 0) {
      ps[l] = (mrow[l] ? s : kMaskFill) / sqrt_d;
      ds[l] = dp;
    }
  }
  __syncthreads();

  float* prow = probs + ((size_t)j * H + h) * L;
  float* dsrow = dscores + ((size_t)j * H + h) * L;
  if (warp == 0) {
    float m = -INFINITY;
    for (int l = lane; l < L; l += 32) m = fmaxf(m, ps[l]);
    m = warp_max(m);
    float sum = 0.f;
    for (int l = lane; l < L; l += 32) {
      const float e = expf(ps[l] - m);
      ps[l] = e;
      sum += e;
    }
    const float inv = 1.f / warp_sum(sum);
    float pdp = 0.f;
    for (int l = lane; l < L; l += 32) {
      ps[l] *= inv;
      pdp = fmaf(ps[l], ds[l], pdp);
    }
    pdp = warp_sum(pdp);
    for (int l = lane; l < L; l += 32) {
      ds[l] = mrow[l] ? ps[l] * (ds[l] - pdp) * inv_sqrt_d : 0.f;
      prow[l] = ps[l];
      dsrow[l] = ds[l];
    }
  }
  __syncthreads();

  for (int d = threadIdx.x; d < hd; d += blockDim.x) {
    float acc = 0.f;
    for (int l = 0; l < L; ++l) acc = fmaf(ds[l], __ldg(row_ptr(tk, pe_k, l) + d), acc);
    dq[(size_t)b * D + col + d] = acc;
  }
}

// Pass 2. blockIdx.x < W * tiles_s: timeline tile (worker, row tile); above:
// PE tile (row tile, sample chunk). A thread per head dim; blockDim.x >= hd.
__global__ void grouped_bwd_reduce_kernel(
    const float* __restrict__ q, const int32_t* __restrict__ start,
    const int32_t* __restrict__ n_valid, const int32_t* __restrict__ s_lo,
    const float* __restrict__ g, const int64_t* __restrict__ order,
    const int32_t* __restrict__ seg, const float* __restrict__ probs,
    const float* __restrict__ dscores, float* __restrict__ dtk,
    float* __restrict__ dtv, float* __restrict__ part_k,
    float* __restrict__ part_v, int B, int W, int S, int P, int L, int D,
    int H, int tiles_s, int tiles_p) {
  extern __shared__ int meta[];
  const int n_meta = blockDim.x;
  int* m_b = meta;                 // [n_meta] original row of the sample
  int* m_base = m_b + n_meta;      // [n_meta] table row of window row 0
  int* m_lo = m_base + n_meta;     // [n_meta] window rows [lo, hi) land in
  int* m_hi = m_lo + n_meta;       //          this table
  int* m_j = m_hi + n_meta;        // [n_meta] sorted index, -1: misses the tile

  const int h = blockIdx.y;
  const int hd = D / H;
  const int col = h * hd;
  const int d = threadIdx.x;
  const bool is_pe = (int)blockIdx.x >= W * tiles_s;
  int w = 0, t0, j0, j1, chunk = 0;
  if (!is_pe) {
    w = blockIdx.x / tiles_s;
    t0 = (blockIdx.x - w * tiles_s) * kRows;
    j0 = seg[w];
    j1 = seg[w + 1];
  } else {
    const int k = blockIdx.x - W * tiles_s;
    chunk = k / tiles_p;
    t0 = (k - chunk * tiles_p) * kRows;
    j0 = chunk * kPeChunk;
    j1 = min(B, j0 + kPeChunk);
  }

  float acc_k[kRows], acc_v[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc_k[r] = acc_v[r] = 0.f;

  for (int c = j0; c < j1; c += n_meta) {
    const int n = min(n_meta, j1 - c);
    __syncthreads();  // the previous chunk's metadata has been read
    if ((int)threadIdx.x < n) {
      const int jj = c + threadIdx.x;
      const int b = (int)order[jj];
      const int nv = min(max((int)n_valid[b], 0), L);
      const int base = is_pe ? s_lo[b] : start[b];
      const int lo = is_pe ? nv : 0;
      const int hi = is_pe ? L : nv;
      const bool meets = lo < hi && base + hi > t0 && base + lo < t0 + kRows;
      m_b[threadIdx.x] = b;
      m_base[threadIdx.x] = base;
      m_lo[threadIdx.x] = lo;
      m_hi[threadIdx.x] = hi;
      m_j[threadIdx.x] = meets ? jj : -1;
    }
    __syncthreads();
    for (int i = 0; i < n; ++i) {
      const int jj = m_j[i];
      if (jj < 0 || d >= hd) continue;
      const int b = m_b[i];
      const int base = m_base[i], lo = m_lo[i], hi = m_hi[i];
      const float qd = q[(size_t)b * D + col + d];
      const float gd = g[(size_t)b * D + col + d];
      const float* prow = probs + ((size_t)jj * H + h) * L;
      const float* dsrow = dscores + ((size_t)jj * H + h) * L;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int l = t0 + r - base;
        if (l >= lo && l < hi) {
          acc_k[r] = fmaf(dsrow[l], qd, acc_k[r]);
          acc_v[r] = fmaf(prow[l], gd, acc_v[r]);
        }
      }
    }
  }

  if (d >= hd) return;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = t0 + r;
    if (!is_pe) {
      if (row < S) {
        const size_t off = ((size_t)w * S + row) * D + col + d;
        dtk[off] = acc_k[r];
        dtv[off] = acc_v[r];
      }
    } else if (row < P) {
      const size_t off = ((size_t)chunk * P + row) * D + col + d;
      part_k[off] = acc_k[r];
      part_v[off] = acc_v[r];
    }
  }
}

// Pass 3: dpk/dpv[i] = sum over chunks c, in order, of part[c][i].
__global__ void grouped_bwd_pe_sum_kernel(
    const float* __restrict__ part_k, const float* __restrict__ part_v,
    float* __restrict__ dpk, float* __restrict__ dpv, int n, int chunks) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float sk = 0.f, sv = 0.f;
  for (int c = 0; c < chunks; ++c) {
    sk += part_k[(size_t)c * n + i];
    sv += part_v[(size_t)c * n + i];
  }
  dpk[i] = sk;
  dpv[i] = sv;
}

}  // namespace

// The number of sorted samples summed into one PE partial: the wrapper sizes
// part_k/part_v as (ceil(B / this), P, D).
extern "C" int window_attention_bwd_grouped_pe_chunk() { return kPeChunk; }

// Launches the three passes on `stream` and returns the first launch error
// (0 = launched). Pointers are device pointers to contiguous arrays:
//   q, g, dq (B, D); tk/tv, dtk/dtv (W, S, D); pe_k/pe_v, dpk/dpv (P, D):
//   float32; w_idx/start/n_valid/s_lo (B,): int32; mask (B, L): uint8 (0/1);
//   order (B,): int64, a stable argsort of w_idx; seg (W + 1,): int32, the
//   first sorted position of each worker 0..W (searchsorted of w_idx[order]);
//   scratch probs/dscores (B, H, L) and part_k/part_v (ceil(B / kPeChunk),
//   P, D): float32.
// Every output entry is written; nothing needs zeroing first.
extern "C" int window_attention_bwd_grouped(
    const void* q, const void* tk, const void* tv, const void* pe_k,
    const void* pe_v, const void* w_idx, const void* start,
    const void* n_valid, const void* s_lo, const void* mask, const void* g,
    const void* order, const void* seg, void* probs, void* dscores,
    void* part_k, void* part_v, void* dq, void* dtk, void* dtv, void* dpk,
    void* dpv, int B, int W, int S, int P, int L, int D, int H, void* stream) {
  if (B <= 0 || W <= 0 || S <= 0 || P <= 0 || L <= 0 || H <= 0 || D % H != 0)
    return (int)cudaErrorInvalidValue;
  const int hd = D / H;
  const cudaStream_t s = (cudaStream_t)stream;

  const size_t smem1 = (size_t)(2 * hd + 2 * L) * sizeof(float);
  if (smem1 > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        grouped_bwd_scores_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem1);
    if (err != cudaSuccess) return (int)err;
  }
  grouped_bwd_scores_kernel<<<dim3((unsigned)B, (unsigned)H), kThreads, smem1, s>>>(
      (const float*)q, (const float*)tk, (const float*)tv, (const float*)pe_k,
      (const float*)pe_v, (const int32_t*)w_idx, (const int32_t*)start,
      (const int32_t*)n_valid, (const int32_t*)s_lo, (const uint8_t*)mask,
      (const float*)g, (const int64_t*)order, (float*)dq, (float*)probs,
      (float*)dscores, W, S, P, L, D, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int threads2 = ((hd + 31) / 32) * 32;
  if (threads2 > 1024) return (int)cudaErrorInvalidValue;
  const int tiles_s = (S + kRows - 1) / kRows;
  const int tiles_p = (P + kRows - 1) / kRows;
  const int chunks = (B + kPeChunk - 1) / kPeChunk;
  const size_t smem2 = (size_t)5 * threads2 * sizeof(int);
  grouped_bwd_reduce_kernel<<<dim3((unsigned)(W * tiles_s + tiles_p * chunks),
                                   (unsigned)H),
                              threads2, smem2, s>>>(
      (const float*)q, (const int32_t*)start, (const int32_t*)n_valid,
      (const int32_t*)s_lo, (const float*)g, (const int64_t*)order,
      (const int32_t*)seg, (const float*)probs, (const float*)dscores,
      (float*)dtk, (float*)dtv, (float*)part_k, (float*)part_v, B, W, S, P, L,
      D, H, tiles_s, tiles_p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int n = P * D;
  grouped_bwd_pe_sum_kernel<<<(n + kReduceThreads - 1) / kReduceThreads,
                              kReduceThreads, 0, s>>>(
      (const float*)part_k, (const float*)part_v, (float*)dpk, (float*)dpv, n,
      chunks);
  return (int)cudaGetLastError();
}
