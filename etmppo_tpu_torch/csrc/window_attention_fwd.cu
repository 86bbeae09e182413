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
// Quirks of the reference kept for parity: the finite -1e20 fill gives an
// all-masked row uniform attention over all L rows (no NaN); the scale is
// 1/sqrt(D) of the whole embedding, not of a head; reads are clamped to the
// tables, so that a bad index can never read outside them (the trainer's
// index math keeps them in range).
//
// What bounds it on an H100. Each (sample, head) is a matrix-vector product
// with one query, so wgmma has nothing to offer: the bound is bytes. At the
// flagship shape (B=1024, L=64, D=384, H=4) a call reads 2*B*L*D*4 B = 201 MB
// of window rows against about 0.1 GFLOP. Neighbouring samples of one worker
// share most of their window rows, so the distinct rows are only ~33 MB and
// the row reads are served from the 50 MB L2: the floor in practice is the
// rate at which L2 feeds the SMs, and the kernel must keep enough row bytes
// in flight to reach it. (At Mortar Mayhem Grid's shape the timelines alone,
// 74 MB, outgrow L2.)
//
// The design:
// * One CTA per sample takes all its heads, so that a window row is one
//   contiguous line of D floats. It is staged in shared memory through the
//   two-tile ring of window_ring.cuh: where rows are 16-byte aligned one
//   warp sends a bulk (TMA) copy per row, each tile completing on its stage's
//   mbarrier, so the next tile's copies are in flight while the current one
//   is used and the only block-wide barrier is the one that frees a stage;
//   elsewhere all threads copy 4-byte cp.async pieces. No gathered copy of
//   the window is ever written to device memory.
// * A warp per head takes every row of a tile (the rows per tile are a
//   template parameter, so the loops over them unroll). It computes q . K for
//   them from shared memory (several lanes a row, float4 reads, a shuffle
//   reduction) and folds the tile into an online softmax: a running max m,
//   the sum l = sum e^(s-m) and the output o = sum e^(s-m) V, rescaled when m
//   grows, so that K and V of a tile are used in one pass; out = o / l.
// * Small CTAs (a warp per head, tiles of at most 8 rows) let several share
//   an SM, whose copies and arithmetic then overlap: on the card this beat
//   larger tiles, deeper rings and more warps per head.
//
// The launch plan (rows per tile, threads, shared memory) is chosen by the
// wrapper (etmppo_tpu_torch/ops/window_attention.py, `forward_plan`) and
// checked here. Built by nvcc into a shared library with a plain C interface
// and loaded with ctypes.

#include "window_ring.cuh"

namespace {

// Shared memory of one CTA, in floats: the ring's barriers, the ring (K and
// V tiles), q, and the output sums of every head.
__host__ __device__ inline size_t smem_floats(int D, int rows) {
  return kBarFloats + ring_floats(D, rows) + (size_t)((D + 3) & ~3) + (size_t)D;
}

template <int RW>
__global__ void __launch_bounds__(kMaxThreads) window_attention_fwd_kernel(
    const float* __restrict__ q, const float* __restrict__ tk,
    const float* __restrict__ tv, const float* __restrict__ pe_k,
    const float* __restrict__ pe_v, const int32_t* __restrict__ w_idx,
    const int32_t* __restrict__ start, const int32_t* __restrict__ n_valid,
    const int32_t* __restrict__ s_lo, const uint8_t* __restrict__ mask,
    float* __restrict__ out, int W, int S, int P, int L, int D, int H, int vec) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.x;
  const int hd = D / H;
  const int stride = row_stride(D);
  float* ring = smem + kBarFloats;                           // [kStages][2][RW][stride]
  float* qs = ring + ring_floats(D, RW);                     // [D rounded up to 4]
  float* os = qs + ((D + 3) & ~3);                           // [H][hd]

  const WindowRing win{tk, tv, pe_k, pe_v, min(max((int)w_idx[b], 0), W - 1), start[b],
                       n_valid[b], s_lo[b], S, P, D, L, RW, vec != 0,
                       reinterpret_cast<uint64_t*>(smem), ring};
  win.start();
  for (int i = threadIdx.x; i < D; i += blockDim.x) {
    qs[i] = q[(size_t)b * D + i];
    os[i] = 0.f;
  }
  __syncthreads();

  const uint8_t* mrow = mask + (size_t)b * L;
  const int h = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int col = h * hd;
  constexpr int parts = 32 / RW;       // lanes per row
  const int r = lane & (RW - 1);       // this lane's row of the tile
  const int part = lane / RW;          // and its share of the head's dims
  const bool vec4 = (hd & 3) == 0;     // head slices start 16-byte aligned
  const float sqrt_d = sqrtf((float)D);
  float* o = os + col;
  // The running max, and this lane's row's share of l (every part of a row
  // holds the same).
  float m = -INFINITY, l_row = 0.f;

  for (int t = 0; t < win.n_tiles(); ++t) {
    const float* kt = win.acquire(t);
    const float* vt = kt + (size_t)RW * stride;
    const int l0 = t * RW;
    const int n_rows = min(RW, L - l0);

    // Scores of the tile's rows: `parts` lanes a row.
    const bool row_ok = r < n_rows;
    float s = 0.f;
    if (row_ok) {
      const float* kr = kt + (size_t)r * stride + col;
      if (vec4) {
#pragma unroll 4
        for (int c = part; c < (hd >> 2); c += parts) {
          const float4 kv = reinterpret_cast<const float4*>(kr)[c];
          const float4 qv = reinterpret_cast<const float4*>(qs + col)[c];
          s = fmaf(qv.x, kv.x, fmaf(qv.y, kv.y, fmaf(qv.z, kv.z, fmaf(qv.w, kv.w, s))));
        }
      } else {
        for (int c = part; c < hd; c += parts) s = fmaf(qs[col + c], kr[c], s);
      }
    }
#pragma unroll
    for (int off = RW; off < 32; off <<= 1) s += __shfl_xor_sync(kFull, s, off);
    const float sv = row_ok ? (mrow[l0 + r] ? s : kMaskFill) / sqrt_d : -INFINITY;

    // The online softmax.
    float tmax = sv;
#pragma unroll
    for (int off = 1; off < RW; off <<= 1) tmax = fmaxf(tmax, __shfl_xor_sync(kFull, tmax, off));
    const float m_new = fmaxf(m, tmax);
    const float alpha = expf(m - m_new);
    const float u = row_ok ? expf(sv - m_new) : 0.f;
    l_row = l_row * alpha + u;
    m = m_new;
    for (int d0 = 0; d0 < hd; d0 += 128) {
      float x[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int d = d0 + lane + 32 * i;
        x[i] = d < hd ? o[d] * alpha : 0.f;
      }
      // All RW rows, unrolled; u is 0 on rows past the tile's end, which
      // read the tile's last row instead.
#pragma unroll
      for (int jj = 0; jj < RW; ++jj) {
        const float c = __shfl_sync(kFull, u, jj);
        const float* vr = vt + (size_t)min(jj, n_rows - 1) * stride + col;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int d = d0 + lane + 32 * i;
          if (d < hd) x[i] = fmaf(c, vr[d], x[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int d = d0 + lane + 32 * i;
        if (d < hd) o[d] = x[i];
      }
    }
    __syncthreads();  // frees the stage for a later tile
  }
  // Each lane wrote the entries of o that it reads here.
  const float l = warp_sum(part == 0 ? l_row : 0.f);
  for (int d = lane; d < hd; d += 32) out[(size_t)b * D + col + d] = o[d] / l;
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched), or
// cudaErrorInvalidValue for shapes or a plan the kernel cannot run.
// Pointers are device pointers to contiguous arrays:
//   q (B, D), tk/tv (W, S, D), pe_k/pe_v (P, D), out (B, D): float32;
//   w_idx/start/n_valid/s_lo (B,): int32; mask (B, L): uint8 (0/1).
// The plan: `rows` window rows per tile (1, 2, 4 or 8), `threads` = H * 32,
// and `smem` bytes of dynamic shared memory, which must be what the plan
// needs.
extern "C" int window_attention_fwd(
    const void* q, const void* tk, const void* tv, const void* pe_k,
    const void* pe_v, const void* w_idx, const void* start,
    const void* n_valid, const void* s_lo, const void* mask, void* out,
    int B, int W, int S, int P, int L, int D, int H,
    int rows, int threads, int smem, void* stream) {
  if (B <= 0 || W <= 0 || S <= 0 || P <= 0 || L <= 0 || H <= 0 || D % H != 0)
    return (int)cudaErrorInvalidValue;
  if (threads != H * 32 || threads > kMaxThreads) return (int)cudaErrorInvalidValue;
  const size_t need = smem_floats(D, rows) * sizeof(float);
  if (smem < 0 || (size_t)smem != need || need > kMaxSmem) return (int)cudaErrorInvalidValue;
  const bool vec = D % 4 == 0 && aligned16(tk) && aligned16(tv) && aligned16(pe_k) &&
                   aligned16(pe_v);
  void (*kernel)(const float*, const float*, const float*, const float*, const float*,
                 const int32_t*, const int32_t*, const int32_t*, const int32_t*,
                 const uint8_t*, float*, int, int, int, int, int, int, int);
  switch (rows) {
    case 1: kernel = window_attention_fwd_kernel<1>; break;
    case 2: kernel = window_attention_fwd_kernel<2>; break;
    case 4: kernel = window_attention_fwd_kernel<4>; break;
    case 8: kernel = window_attention_fwd_kernel<8>; break;
    default: return (int)cudaErrorInvalidValue;
  }
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B, threads, need, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)tk, (const float*)tv, (const float*)pe_k,
      (const float*)pe_v, (const int32_t*)w_idx, (const int32_t*)start,
      (const int32_t*)n_valid, (const int32_t*)s_lo, (const uint8_t*)mask, (float*)out,
      W, S, P, L, D, H, vec);
  return (int)cudaGetLastError();
}
