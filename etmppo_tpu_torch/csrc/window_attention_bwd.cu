// Episodic window attention, backward, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_bwd_kernel` / `_pallas_backward` in
// etmppo_tpu/ops/pallas_window_attention.py. The window of sample b, with
// w = w_idx[b], is the one of the forward kernel (window_attention_fwd.cu):
//
//   window row l <  n_valid[b]:  timeline[w, start[b] + l]       (K and V)
//   window row l >= n_valid[b]:  pe[s_lo[b] + l]                 (K and V)
//
// Given the output gradient g (B, D), per sample b and head h:
//
//   p     = softmax(where(mask[b], q_h . K_h^T, -1e20) / sqrt(D))   (recomputed)
//   dp[l] = g_h . V_h[l]
//   ds[l] = p[l] * (dp[l] - sum_l' p[l'] dp[l']) / sqrt(D), zeroed where mask is
//           false (the VJP of the mask fill)
//   dq_h  = sum_l ds[l] K_h[l];  dK_h[l] = ds[l] q_h;  dV_h[l] = p[l] g_h
//
// dK/dV of row l < n_valid[b] go to timeline row (w, start[b] + l), those of
// row l >= n_valid[b] to PE row s_lo[b] + l. An all-masked row has uniform p,
// zero ds and dq, and a non-zero dV = p * g, as in the forward's edge case.
//
// What bounds it on an H100: bytes, and the scatter. Each (sample, head) reads
// L rows of K and V (served mostly from L2: a worker's neighbouring samples
// share most of their window) and adds 2 * L * D/H values into the gradient
// tables. The tables dtk/dtv (W, S, D) are written whole, and at the flagship
// shape (W=16, S=672, D=384) they are 33 MB of the ~63 MB the call must move;
// the 2 * B * L * D atomic adds (50 M there), not the bytes, set its time.
//
// Race-freedom. The TPU kernel relies on its sequential grid for a race-free
// read-modify-write of the timeline gradients. Here CTAs run in no order:
// overlapping windows of one worker add into the same timeline rows from
// different CTAs, and the invalid rows of many samples add into the same few PE
// rows. The design is the simple one: every contribution goes out as an fp32
// atomicAdd (compiled to a fire-and-forget RED) into tables that the caller
// zeroes on the same stream before the launch. Zero contributions (masked rows,
// whose p and ds are exactly 0) are skipped, which changes no bit of the sums.
// The order of the additions, and so the last bits of dK/dV/dPE, varies from
// run to run. The deterministic alternative, a sort of the minibatch by worker
// followed by an output-stationary reduction with no atomics, is the grouped
// backward, window_attention_bwd_grouped.cu (`_grouped_bwd_kernel`).
//
// Layout: one CTA per (sample, head), 128 threads. Scores and dp: one warp per
// window row, lanes striding over the head's dims (coalesced), shuffle
// reductions. Softmax and ds: one warp over the L values in shared memory. dq:
// one thread per head dim, summing over rows. Scatter: (row, dim) pairs
// flattened over the CTA, neighbouring threads on neighbouring dims. Reads are
// clamped to the tables, as in the forward, so that the recomputed p is the
// forward's; scatter rows are bounds-checked and an out-of-range row is
// dropped, never clamped onto another row.
//
// Built by nvcc into a shared library with a plain C interface and loaded with
// ctypes (etmppo_tpu_torch/ops/window_attention.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
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

// Row index into the flattened (W*S) timeline or the (P) PE table that window
// row l reads, clamped to the table (reads only).
__device__ __forceinline__ size_t read_row(int w, int st, int nv, int slo,
                                           int l, int S, int P) {
  if (l < nv) return (size_t)w * S + min(max(st + l, 0), S - 1);
  return (size_t)min(max(slo + l, 0), P - 1);
}

__global__ void __launch_bounds__(kThreads) window_attention_bwd_kernel(
    const float* __restrict__ q, const float* __restrict__ tk,
    const float* __restrict__ tv, const float* __restrict__ pe_k,
    const float* __restrict__ pe_v, const int32_t* __restrict__ w_idx,
    const int32_t* __restrict__ start, const int32_t* __restrict__ n_valid,
    const int32_t* __restrict__ s_lo, const uint8_t* __restrict__ mask,
    const float* __restrict__ g, float* __restrict__ dq,
    float* __restrict__ dtk, float* __restrict__ dtv, float* __restrict__ dpk,
    float* __restrict__ dpv, int W, int S, int P, int L, int D, int H) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int hd = D / H;
  float* qs = smem;            // [hd] this head's query
  float* gs = qs + hd;         // [hd] this head's output gradient
  float* ps = gs + hd;         // [L]  scores, then probabilities
  float* ds = ps + L;          // [L]  dp, then ds

  const int w_raw = w_idx[b];
  const int w = min(max(w_raw, 0), W - 1);
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

  // Scores (as the forward computes them) and dp = g . V.
  for (int l = warp; l < L; l += n_warps) {
    const size_t r = read_row(w, st, nv, slo, l, S, P);
    const float* k = (l < nv ? tk : pe_k) + r * D + col;
    const float* v = (l < nv ? tv : pe_v) + r * D + col;
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

  // Softmax, then ds = p * (dp - sum p dp) / sqrt(D), zeroed where masked.
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
    for (int l = lane; l < L; l += 32)
      ds[l] = mrow[l] ? ps[l] * (ds[l] - pdp) * inv_sqrt_d : 0.f;
  }
  __syncthreads();

  // dq_h = sum_l ds[l] K_h[l]; this CTA owns its slice of dq.
  for (int d = threadIdx.x; d < hd; d += blockDim.x) {
    float acc = 0.f;
    for (int l = 0; l < L; ++l) {
      const size_t r = read_row(w, st, nv, slo, l, S, P);
      acc = fmaf(ds[l], __ldg((l < nv ? tk : pe_k) + r * D + col + d), acc);
    }
    dq[(size_t)b * D + col + d] = acc;
  }

  // Scatter dK = ds q and dV = p g into the timeline or PE rows.
  const bool w_ok = w_raw >= 0 && w_raw < W;
  for (int i = threadIdx.x; i < L * hd; i += blockDim.x) {
    const int l = i / hd;
    const int d = i - l * hd;
    float* dk;
    float* dv;
    if (l < nv) {
      const int r = st + l;
      if (!w_ok || r < 0 || r >= S) continue;
      const size_t off = ((size_t)w_raw * S + r) * D + col + d;
      dk = dtk + off;
      dv = dtv + off;
    } else {
      const int r = slo + l;
      if (r < 0 || r >= P) continue;
      const size_t off = (size_t)r * D + col + d;
      dk = dpk + off;
      dv = dpv + off;
    }
    const float dsl = ds[l];
    const float pl = ps[l];
    if (dsl != 0.f) atomicAdd(dk, dsl * qs[d]);
    if (pl != 0.f) atomicAdd(dv, pl * gs[d]);
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
// Pointers are device pointers to contiguous arrays:
//   q, g, dq (B, D); tk/tv, dtk/dtv (W, S, D); pe_k/pe_v, dpk/dpv (P, D):
//   float32; w_idx/start/n_valid/s_lo (B,): int32; mask (B, L): uint8 (0/1).
// dtk, dtv, dpk and dpv are accumulated into: the caller zeroes them on
// `stream` first.
extern "C" int window_attention_bwd(
    const void* q, const void* tk, const void* tv, const void* pe_k,
    const void* pe_v, const void* w_idx, const void* start,
    const void* n_valid, const void* s_lo, const void* mask, const void* g,
    void* dq, void* dtk, void* dtv, void* dpk, void* dpv,
    int B, int W, int S, int P, int L, int D, int H, void* stream) {
  if (B <= 0 || W <= 0 || S <= 0 || P <= 0 || L <= 0 || H <= 0 || D % H != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(2 * (D / H) + 2 * L) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        window_attention_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((unsigned)B, (unsigned)H);
  window_attention_bwd_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)tk, (const float*)tv, (const float*)pe_k,
      (const float*)pe_v, (const int32_t*)w_idx, (const int32_t*)start,
      (const int32_t*)n_valid, (const int32_t*)s_lo, (const uint8_t*)mask,
      (const float*)g, (float*)dq, (float*)dtk, (float*)dtv, (float*)dpk,
      (float*)dpv, W, S, P, L, D, H);
  return (int)cudaGetLastError();
}
