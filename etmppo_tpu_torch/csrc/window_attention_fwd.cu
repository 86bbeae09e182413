// Episodic window attention, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_kernel` / `_pallas_forward` in
// etmppo_tpu/ops/pallas_window_attention.py. For sample b, with w = w_idx[b]:
//
//   window row l <  n_valid[b]:  timeline[w, start[b] + l]       (K and V)
//   window row l >= n_valid[b]:  pe[s_lo[b] + l]                 (K and V)
//   per head h:  out[b, h] = softmax(where(mask[b], q[b, h] . K[:, h], -1e20)
//                                    / sqrt(D)) . V[:, h]
//
// The finite -1e20 fill gives an all-masked row uniform attention over all L
// rows (no NaN), and the scale is 1/sqrt(D) of the whole embedding, not of a
// head: both are quirks of the reference model kept for parity.
//
// What bounds it on an H100: bytes. Each (sample, head) reads L rows of K and V
// of D/H floats; at the flagship shape (B=1024, L=64, D=384, H=4) that is
// 2*B*L*D*4 B = 201 MB of row reads against about 0.1 GFLOP. Neighbouring
// samples of one worker share most of their window rows, so the distinct
// timeline and PE rows a minibatch touches are only ~33 MB, which fits in the
// 50 MB L2.
//
// The design is the simple one: one CTA per (sample, head), 128 threads. The
// window is read straight from the two contiguous runs in global memory (no
// gathered copy is ever written). Scores: one warp per window row, lanes
// striding over the head's dims (coalesced), a shuffle reduction. Softmax: one
// warp over the L scores in shared memory, max-subtracted. Output: one thread
// per head dim, summing p[l] * V[l, d] over the rows (coalesced). Repeated row
// reads are left to L2. Indices are clamped to the tables so that a bad index
// can never read outside them; the trainer's index math keeps them in range.
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

// Start of window row l (all D columns) for one sample.
__device__ __forceinline__ const float* window_row(
    const float* __restrict__ timeline, const float* __restrict__ pe,
    int w, int st, int nv, int slo, int l, int S, int P, int D) {
  if (l < nv) {
    const int r = min(max(st + l, 0), S - 1);
    return timeline + ((size_t)w * S + r) * D;
  }
  const int r = min(max(slo + l, 0), P - 1);
  return pe + (size_t)r * D;
}

__global__ void __launch_bounds__(kThreads) window_attention_fwd_kernel(
    const float* __restrict__ q, const float* __restrict__ tk,
    const float* __restrict__ tv, const float* __restrict__ pe_k,
    const float* __restrict__ pe_v, const int32_t* __restrict__ w_idx,
    const int32_t* __restrict__ start, const int32_t* __restrict__ n_valid,
    const int32_t* __restrict__ s_lo, const uint8_t* __restrict__ mask,
    float* __restrict__ out, int W, int S, int P, int L, int D, int H) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int hd = D / H;
  float* qs = smem;       // [hd]  this head's query
  float* ps = smem + hd;  // [L]   scores, then probabilities

  const int w = min(max((int)w_idx[b], 0), W - 1);
  const int st = start[b];
  const int nv = n_valid[b];
  const int slo = s_lo[b];
  const int col = h * hd;

  for (int d = threadIdx.x; d < hd; d += blockDim.x) qs[d] = q[(size_t)b * D + col + d];
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  const float sqrt_d = sqrtf((float)D);

  for (int l = warp; l < L; l += n_warps) {
    const float* k = window_row(tk, pe_k, w, st, nv, slo, l, S, P, D) + col;
    float acc = 0.f;
    for (int d = lane; d < hd; d += 32) acc = fmaf(qs[d], __ldg(k + d), acc);
    acc = warp_sum(acc);
    if (lane == 0) ps[l] = (mask[(size_t)b * L + l] ? acc : kMaskFill) / sqrt_d;
  }
  __syncthreads();

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
    for (int l = lane; l < L; l += 32) ps[l] *= inv;
  }
  __syncthreads();

  for (int d = threadIdx.x; d < hd; d += blockDim.x) {
    float acc = 0.f;
#pragma unroll 8
    for (int l = 0; l < L; ++l) {
      const float* v = window_row(tv, pe_v, w, st, nv, slo, l, S, P, D) + col;
      acc = fmaf(ps[l], __ldg(v + d), acc);
    }
    out[(size_t)b * D + col + d] = acc;
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
// Pointers are device pointers to contiguous arrays:
//   q (B, D), tk/tv (W, S, D), pe_k/pe_v (P, D), out (B, D): float32;
//   w_idx/start/n_valid/s_lo (B,): int32; mask (B, L): uint8 (0/1).
extern "C" int window_attention_fwd(
    const void* q, const void* tk, const void* tv, const void* pe_k,
    const void* pe_v, const void* w_idx, const void* start,
    const void* n_valid, const void* s_lo, const void* mask, void* out,
    int B, int W, int S, int P, int L, int D, int H, void* stream) {
  if (B <= 0 || W <= 0 || S <= 0 || P <= 0 || L <= 0 || H <= 0 || D % H != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(D / H + L) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        window_attention_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((unsigned)B, (unsigned)H);
  window_attention_fwd_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)tk, (const float*)tv, (const float*)pe_k,
      (const float*)pe_v, (const int32_t*)w_idx, (const int32_t*)start,
      (const int32_t*)n_valid, (const int32_t*)s_lo, (const uint8_t*)mask,
      (float*)out, W, S, P, L, D, H);
  return (int)cudaGetLastError();
}
