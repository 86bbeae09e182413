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
// row l >= n_valid[b] to PE row s_lo[b] + l. Quirks of the reference kept for
// parity: the finite -1e20 fill (an all-masked row has uniform p, zero ds and
// dq, and a non-zero dV = p * g), the 1/sqrt(D) scale of the whole embedding,
// reads clamped to the tables, and scatter rows that fall outside their table
// dropped, never clamped onto another row.
//
// What bounds it on an H100. Each (sample, head) is a matrix-vector product
// with one query, so wgmma has nothing to offer: the bound is bytes. A call
// must write the four gradient tables whole (33 MB at the flagship shape
// B=1024, W=16, S=672, L=64, D=384; 74 MB at Mortar Mayhem Grid's) and read
// every window row of K and V once per sample that holds it (201 MB of row
// reads at the flagship shape, served mostly from the 50 MB L2: a worker's
// neighbouring samples share most of their window). Then 2 * B * L * D
// values are added into the tables from CTAs that run in no order, so the
// adds must be atomic. The tables and the timelines together outgrow L2, so
// the row reads and the adds also compete for it.
//
// The design:
// * One CTA per sample takes all its heads, so that a window row is one
//   contiguous line of D floats, and each K and V row is read from L2 once
//   per sample. It is staged in shared memory through the two-tile ring of
//   window_ring.cuh, tiles of `rows_per_tile` rows of K and V: where rows
//   are 16-byte aligned one warp sends a bulk (TMA) copy per row, each tile
//   completing on its stage's mbarrier, so the next tile's copies are in
//   flight while the current one is used and the only block-wide barrier is
//   the one that frees a stage; elsewhere all threads copy 4-byte cp.async
//   pieces.
// * `warps_per_head` warps per head split each tile's rows (the rows per
//   warp are a template parameter, so the loops over them unroll). A warp
//   computes q . K and g . V for its rows from shared memory (several lanes
//   a row, float4 reads, a shuffle reduction), then keeps a running max m and
//   sums Z = sum e^(s-m), C = sum e^(s-m) dp', A1 = sum e^(s-m) dp' K and
//   A2 = sum e^(s-m) K (the last two over unmasked rows), rescaled when m
//   grows, so that dq = (A1 - (C/Z) A2) / (Z sqrt(D)) needs no second pass
//   over K. dp' = dp - dp[0]: the shift leaves ds and dq unchanged and keeps
//   the difference from cancelling when all dp share a large common part.
//   The scores and dp' of every row stay in shared memory.
// * The warps of a head merge their sums; p and ds follow for every row, and
//   dq is written.
// * The scatter: a warp per window row sends dK and dV of all heads as float4
//   reductions (atomicAdd on float4, red.global.add.v4.f32: one per 4 floats)
//   and skips masked rows (their ds, and unless the row is all masked their
//   p, are exactly 0). A bulk reduction per row (cp.reduce.async.bulk) was
//   slower on the card. The order of the additions, and so the last bits of
//   dK/dV/dPE, varies from run to run. The deterministic alternative is the
//   grouped backward, window_attention_bwd_grouped.cu (`_grouped_bwd_kernel`).
// * The caller zeroes the gradient tables on the same stream first, in one
//   fill.
//
// The launch plan (rows per tile, warps per head, threads, shared memory) is
// chosen by the wrapper (etmppo_tpu_torch/ops/window_attention.py,
// `backward_plan`) and checked here. Built by nvcc into a shared library with
// a plain C interface and loaded with ctypes.

#include "window_ring.cuh"

namespace {

// Shared memory of one CTA, in floats: the ring's barriers, the ring (K and
// V tiles), q and g, A1 and A2 of every warp, the scores and dp' (then p and
// ds) of every (head, row), and (m, Z, C) of every warp.
__host__ __device__ inline size_t smem_floats(int L, int D, int H, int rows, int wph) {
  const size_t dp4 = (size_t)((D + 3) & ~3);
  return kBarFloats + ring_floats(D, rows) + 2 * dp4 + 2 * (size_t)wph * D +
         2 * (size_t)H * L + 3 * (size_t)H * wph;
}

// Two CTAs of the most threads a plan takes per SM caps the registers at 64,
// so that three CTAs of 8 warps fit an SM where shared memory allows (at
// Mystery Path Grid's D=256): without the cap nvcc takes 87 and fits two,
// and the kernel is 13% slower there.
template <int RW>
__global__ void __launch_bounds__(kMaxThreads, 2) window_attention_bwd_kernel(
    const float* __restrict__ q, const float* __restrict__ tk,
    const float* __restrict__ tv, const float* __restrict__ pe_k,
    const float* __restrict__ pe_v, const int32_t* __restrict__ w_idx,
    const int32_t* __restrict__ start, const int32_t* __restrict__ n_valid,
    const int32_t* __restrict__ s_lo, const uint8_t* __restrict__ mask,
    const float* __restrict__ g, float* __restrict__ dq,
    float* __restrict__ dtk, float* __restrict__ dtv, float* __restrict__ dpk,
    float* __restrict__ dpv, int W, int S, int P, int L, int D, int H,
    int rows, int wph, int vec) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.x;
  const int hd = D / H;
  const int stride = row_stride(D);
  const int dp4 = (D + 3) & ~3;
  float* ring = smem + kBarFloats;                           // [kStages][2][rows][stride]
  float* qs = ring + ring_floats(D, rows);                   // [dp4]
  float* gs = qs + dp4;                                      // [dp4]
  float* a1s = gs + dp4;                                     // [H][wph][hd]
  float* a2s = a1s + (size_t)wph * D;                        // [H][wph][hd]
  float* ss = a2s + (size_t)wph * D;                         // [H][L] scores, then p
  float* dps = ss + (size_t)H * L;                           // [H][L] dp', then ds
  float* stats = dps + (size_t)H * L;                        // [H][wph][3] m, Z, C

  const int w_raw = w_idx[b];
  const WindowRing win{tk, tv, pe_k, pe_v, min(max(w_raw, 0), W - 1), start[b],
                       n_valid[b], s_lo[b], S, P, D, L, rows, vec != 0,
                       reinterpret_cast<uint64_t*>(smem), ring};
  win.start();
  const uint8_t* mrow = mask + (size_t)b * L;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < D; i += blockDim.x) {
    qs[i] = q[(size_t)b * D + i];
    gs[i] = g[(size_t)b * D + i];
  }
  for (int i = threadIdx.x; i < 2 * wph * D; i += blockDim.x) a1s[i] = 0.f;
  __syncthreads();

  const int h = warp / wph, k = warp - h * wph;
  const int col = h * hd;
  constexpr int rw = RW;               // rows of a tile per warp: rows / wph
  constexpr int parts = 32 / RW;       // lanes per row
  const int j = lane & (rw - 1);       // this lane's row among them
  const int part = lane / rw;          // and its share of the head's dims
  const bool vec4 = (hd & 3) == 0;     // head slices start 16-byte aligned
  const float sqrt_d = sqrtf((float)D);
  float* a1 = a1s + (size_t)warp * hd;
  float* a2 = a2s + (size_t)warp * hd;
  // The running max, and this lane's row's shares of Z and C (every part of
  // a row holds the same).
  float m = -INFINITY, z_row = 0.f, c_row = 0.f, ref = 0.f;

  for (int t = 0; t < win.n_tiles(); ++t) {
    const float* kt = win.acquire(t);
    const float* vt = kt + (size_t)rows * stride;
    const int l0 = t * rows;
    const int n_rows = min(rows, L - l0);
    if (t == 0) {  // dp of window row 0, the shift of dp
      float x = 0.f;
      for (int d = lane; d < hd; d += 32) x = fmaf(gs[col + d], vt[col + d], x);
      ref = warp_sum(x);
    }

    // Scores and dp' of this warp's rows: `parts` lanes a row.
    const int r = k * rw + j;
    const bool row_ok = r < n_rows;
    float s = 0.f, dp = 0.f;
    if (row_ok) {
      const float* kr = kt + (size_t)r * stride + col;
      const float* vr = vt + (size_t)r * stride + col;
      if (vec4) {
#pragma unroll 4
        for (int c = part; c < (hd >> 2); c += parts) {
          const float4 kv = reinterpret_cast<const float4*>(kr)[c];
          const float4 vv = reinterpret_cast<const float4*>(vr)[c];
          const float4 qv = reinterpret_cast<const float4*>(qs + col)[c];
          const float4 gv = reinterpret_cast<const float4*>(gs + col)[c];
          s = fmaf(qv.x, kv.x, fmaf(qv.y, kv.y, fmaf(qv.z, kv.z, fmaf(qv.w, kv.w, s))));
          dp = fmaf(gv.x, vv.x, fmaf(gv.y, vv.y, fmaf(gv.z, vv.z, fmaf(gv.w, vv.w, dp))));
        }
      } else {
        for (int c = part; c < hd; c += parts) {
          s = fmaf(qs[col + c], kr[c], s);
          dp = fmaf(gs[col + c], vr[c], dp);
        }
      }
    }
#pragma unroll
    for (int off = rw; off < 32; off <<= 1) {
      s += __shfl_xor_sync(kFull, s, off);
      dp += __shfl_xor_sync(kFull, dp, off);
    }
    const bool live = row_ok && mrow[l0 + r];
    const float sv = row_ok ? (live ? s : kMaskFill) / sqrt_d : -INFINITY;
    const float dpv = dp - ref;
    if (row_ok && part == 0) {
      ss[(size_t)h * L + l0 + r] = sv;
      dps[(size_t)h * L + l0 + r] = dpv;
    }

    // The running sums. A warp whose rows all lie past the window's end skips.
    float tmax = sv;
#pragma unroll
    for (int off = 1; off < rw; off <<= 1) tmax = fmaxf(tmax, __shfl_xor_sync(kFull, tmax, off));
    if (tmax != -INFINITY) {
      const float m_new = fmaxf(m, tmax);
      const float alpha = expf(m - m_new);
      const float u = row_ok ? expf(sv - m_new) : 0.f;
      z_row = z_row * alpha + u;
      c_row = c_row * alpha + u * dpv;
      m = m_new;
      const float w1 = live ? u * dpv : 0.f;
      const float w2 = live ? u : 0.f;
      const int nr = min(rw, n_rows - k * rw);
      for (int d0 = 0; d0 < hd; d0 += 128) {
        float x1[4], x2[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int d = d0 + lane + 32 * i;
          x1[i] = d < hd ? a1[d] * alpha : 0.f;
          x2[i] = d < hd ? a2[d] * alpha : 0.f;
        }
        // All rw rows, unrolled; w1 and w2 are 0 on rows past the tile's
        // end, which read the tile's last row instead.
#pragma unroll
        for (int jj = 0; jj < rw; ++jj) {
          const float c1 = __shfl_sync(kFull, w1, jj);
          const float c2 = __shfl_sync(kFull, w2, jj);
          const float* kr = kt + (size_t)(k * rw + min(jj, nr - 1)) * stride + col;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int d = d0 + lane + 32 * i;
            if (d < hd) {
              const float kv = kr[d];
              x1[i] = fmaf(c1, kv, x1[i]);
              x2[i] = fmaf(c2, kv, x2[i]);
            }
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int d = d0 + lane + 32 * i;
          if (d < hd) {
            a1[d] = x1[i];
            a2[d] = x2[i];
          }
        }
      }
    }
    __syncthreads();  // frees the stage for a later tile
  }
  const float z = warp_sum(part == 0 ? z_row : 0.f);
  const float csum = warp_sum(part == 0 ? c_row : 0.f);
  if (lane == 0) {
    stats[3 * warp] = m;
    stats[3 * warp + 1] = z;
    stats[3 * warp + 2] = csum;
  }
  __syncthreads();

  // Merge the head's warps: p and ds for every row, and dq.
  {
    const float* st = stats + 3 * (size_t)h * wph;
    float ms = -INFINITY;
    for (int i = 0; i < wph; ++i) ms = fmaxf(ms, st[3 * i]);
    float zs = 0.f, cs = 0.f;
    for (int i = 0; i < wph; ++i) {
      const float e = expf(st[3 * i] - ms);
      zs = fmaf(e, st[3 * i + 1], zs);
      cs = fmaf(e, st[3 * i + 2], cs);
    }
    const float c = cs / zs;
    const int th = k * 32 + lane;
    for (int l = th; l < L; l += wph * 32) {
      const float p = expf(ss[(size_t)h * L + l] - ms) / zs;
      ss[(size_t)h * L + l] = p;
      dps[(size_t)h * L + l] = mrow[l] ? p * (dps[(size_t)h * L + l] - c) / sqrt_d : 0.f;
    }
    const float* a1h = a1s + (size_t)h * wph * hd;
    const float* a2h = a2s + (size_t)h * wph * hd;
    const float scale = 1.f / (zs * sqrt_d);
    for (int d = th; d < hd; d += wph * 32) {
      float x1 = 0.f, x2 = 0.f;
      for (int i = 0; i < wph; ++i) {
        const float e = expf(st[3 * i] - ms);
        x1 = fmaf(e, a1h[(size_t)i * hd + d], x1);
        x2 = fmaf(e, a2h[(size_t)i * hd + d], x2);
      }
      dq[(size_t)b * D + col + d] = (x1 - c * x2) * scale;
    }
  }
  __syncthreads();

  // Scatter dK = ds q and dV = p g of every head, a warp per window row.
  const bool w_ok = w_raw >= 0 && w_raw < W;
  const int n_warps = blockDim.x >> 5;
  for (int l = warp; l < L; l += n_warps) {
    size_t off;
    float *dk, *dv;
    if (l < win.nv) {
      const int r = win.st + l;
      if (!w_ok || r < 0 || r >= S) continue;
      off = ((size_t)w_raw * S + r) * D;
      dk = dtk;
      dv = dtv;
    } else {
      const int r = win.slo + l;
      if (r < 0 || r >= P) continue;
      off = (size_t)r * D;
      dk = dpk;
      dv = dpv;
    }
    dk += off;
    dv += off;
    const bool do_k = mrow[l] != 0;
    bool do_v = false;
    for (int hh = 0; hh < H; ++hh) do_v |= ss[(size_t)hh * L + l] != 0.f;
    if (!do_k && !do_v) continue;
    if (vec) {
      for (int c4 = lane; c4 < (D >> 2); c4 += 32) {
        const int c = 4 * c4;
        int hh = c / hd, next = (hh + 1) * hd;
        float kq[4], vg[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (c + e == next) {
            ++hh;
            next += hd;
          }
          kq[e] = dps[(size_t)hh * L + l] * qs[c + e];
          vg[e] = ss[(size_t)hh * L + l] * gs[c + e];
        }
        if (do_k) atomicAdd(reinterpret_cast<float4*>(dk + c), make_float4(kq[0], kq[1], kq[2], kq[3]));
        if (do_v) atomicAdd(reinterpret_cast<float4*>(dv + c), make_float4(vg[0], vg[1], vg[2], vg[3]));
      }
    } else {
      for (int c = lane; c < D; c += 32) {
        const int hh = c / hd;
        if (do_k) atomicAdd(dk + c, dps[(size_t)hh * L + l] * qs[c]);
        if (do_v) atomicAdd(dv + c, ss[(size_t)hh * L + l] * gs[c]);
      }
    }
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched), or
// cudaErrorInvalidValue for shapes or a plan the kernel cannot run.
// Pointers are device pointers to contiguous arrays:
//   q, g, dq (B, D); tk/tv, dtk/dtv (W, S, D); pe_k/pe_v, dpk/dpv (P, D):
//   float32; w_idx/start/n_valid/s_lo (B,): int32; mask (B, L): uint8 (0/1).
// dtk, dtv, dpk and dpv are accumulated into: the caller zeroes them on
// `stream` first. The plan: `rows` window rows per tile, `wph` warps per
// head (rows / wph a power of 2 up to 32), `threads` = H * wph * 32, and
// `smem` bytes of dynamic shared memory, which must be what the plan needs.
extern "C" int window_attention_bwd(
    const void* q, const void* tk, const void* tv, const void* pe_k,
    const void* pe_v, const void* w_idx, const void* start,
    const void* n_valid, const void* s_lo, const void* mask, const void* g,
    void* dq, void* dtk, void* dtv, void* dpk, void* dpv,
    int B, int W, int S, int P, int L, int D, int H,
    int rows, int wph, int threads, int smem, void* stream) {
  if (B <= 0 || W <= 0 || S <= 0 || P <= 0 || L <= 0 || H <= 0 || D % H != 0)
    return (int)cudaErrorInvalidValue;
  const int rw = wph > 0 ? rows / wph : 0;
  if (wph <= 0 || rows % wph != 0 || rw <= 0 || rw > 32 || (rw & (rw - 1)) != 0 ||
      threads != H * wph * 32 || threads > kMaxThreads)
    return (int)cudaErrorInvalidValue;
  const size_t need = smem_floats(L, D, H, rows, wph) * sizeof(float);
  if (smem < 0 || (size_t)smem != need || need > kMaxSmem) return (int)cudaErrorInvalidValue;
  // Rows 16-byte aligned: bulk copies in, float4 reductions out.
  const void* const tables[] = {tk, tv, pe_k, pe_v, dtk, dtv, dpk, dpv};
  bool vec = D % 4 == 0;
  for (const void* t : tables) vec = vec && aligned16(t);
  void (*kernel)(const float*, const float*, const float*, const float*, const float*,
                 const int32_t*, const int32_t*, const int32_t*, const int32_t*,
                 const uint8_t*, const float*, float*, float*, float*, float*, float*, int,
                 int, int, int, int, int, int, int, int);
  switch (rw) {
    case 1: kernel = window_attention_bwd_kernel<1>; break;
    case 2: kernel = window_attention_bwd_kernel<2>; break;
    case 4: kernel = window_attention_bwd_kernel<4>; break;
    case 8: kernel = window_attention_bwd_kernel<8>; break;
    case 16: kernel = window_attention_bwd_kernel<16>; break;
    default: kernel = window_attention_bwd_kernel<32>; break;
  }
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B, threads, need, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)tk, (const float*)tv, (const float*)pe_k,
      (const float*)pe_v, (const int32_t*)w_idx, (const int32_t*)start,
      (const int32_t*)n_valid, (const int32_t*)s_lo, (const uint8_t*)mask,
      (const float*)g, (float*)dq, (float*)dtk, (float*)dtv, (float*)dpk, (float*)dpv,
      W, S, P, L, D, H, rows, wph, vec);
  return (int)cudaGetLastError();
}
