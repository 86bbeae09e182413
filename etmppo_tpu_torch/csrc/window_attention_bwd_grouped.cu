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
// those of row l >= n_valid[b] to PE row s_lo[b] + l. Quirks of the reference
// kept for parity: the finite -1e20 fill (an all-masked row has uniform p,
// zero ds and dq, and a non-zero dV = p * g), the 1/sqrt(D) scale of the
// whole embedding, reads clamped to the tables, and scatter rows outside the
// tables (or of a w_idx outside [0, W)) dropped, never clamped.
//
// Determinism. The TPU kernel walks the minibatch sorted by worker on its
// sequential grid and sums each worker's gradients in that order. Here no
// float is ever added atomically, and every gradient entry is summed by one
// thread in one fixed order (the minibatch sorted by (worker, start)), so two
// calls on one input give the same bits.
//
// What bounds it on an H100: bytes. A call must write the four gradient
// tables whole (33 / 20 / 74 MB at the flagship / Mystery Path Grid / Mortar
// Mayhem Grid shapes) and read the distinct K and V rows; the per-sample
// backward also reads every window row once per sample that holds it (201 /
// 403 / 742 MB from L2). The passes:
//
//   sort    window_runs.cuh: the minibatch ranked by (worker, start, row) on
//           the card, the sorted samples' fields in `meta`, each worker's
//           first sorted position in `seg`.
//   pass 1  a CTA per run of R sorted samples of one worker, all heads, as
//           the grouped forward (window_attention_fwd_grouped.cu): the union
//           of the run's window rows streams once through the ring of
//           window_ring.cuh (range mode), a warp takes one head of four
//           samples, 8 lanes a sample, and a reduce-scatter leaves each
//           row's q . K and g . V in one lane. Each sample keeps, beside the
//           running max m, the sums Z = sum e^(s-m), C = sum e^(s-m) dp',
//           A1 = sum e^(s-m) dp' K and A2 = sum e^(s-m) K (the last two over
//           unmasked rows), so dq = (A1 - (C/Z) A2) / (Z sqrt(D)) needs no
//           second pass over K (dp' = dp - dp[row 0], against cancellation,
//           as in the per-sample backward; the sample's first chunk starts
//           at window row 0). q and g of the run's samples, and the scores
//           and dp' of every (sample, head, row), stay in shared memory,
//           which keeps a lane's registers to its A1 and A2 under the cap
//           of 128; at the end the CTA writes dq of its samples, and p and
//           ds, in sorted order, to the scratch probs/dscores (B, H, L).
//   pass 2  output-stationary. A CTA per (worker, tile of kRows timeline
//           rows) owns those rows of dtk/dtv for all heads (full-width rows,
//           float4 columns where they fit; tiles of 16 rows in float2
//           columns, which halve the q and g reads per row, were slower on
//           the card). With the samples in start order, those whose window
//           meets the tile have start in (t0 - L, t0 + kRows): one
//           contiguous part of the worker's segment, found by a warp-wide
//           count. The CTA lists those that meet the tile, gathers
//           their p and ds at its rows into shared memory, and a thread per
//           column sums ds * q and p * g over them in sorted order, the q
//           and g loads of kBatch candidates in flight together. Rows no
//           sample touches come out zero, so nothing is zeroed beforehand.
//           The PE rows are shared by all workers: a CTA per (tile of PE
//           rows, chunk of kPeChunk sorted samples) sums that chunk into its
//           own slice of part_k/part_v.
//   pass 3  dpk/dpv = the sum of the chunks' slices, in chunk order.
//
// A call launches the four kernels on one stream; the wrapper counts a call
// as one launch of this kernel. The launch plan of pass 1 (samples per run,
// rows per tile, threads, shared memory) is chosen by the wrapper
// (etmppo_tpu_torch/ops/window_attention.py, `grouped_backward_plan`) and
// checked here. Built by nvcc into a shared library with a plain C interface
// and loaded with ctypes.

#include "window_ring.cuh"
#include "window_runs.cuh"

namespace {

constexpr int kRows = 8;           // pass 2: table rows per CTA
constexpr int kCand = 64;          // pass 2: candidates staged at a time
constexpr int kBatch = 4;          // pass 2: candidates whose loads are in flight together
constexpr int kPeChunk = 64;       // pass 2: sorted samples per PE partial sum
constexpr int kSumThreads = 256;   // pass 3

// Shared memory of one pass-1 CTA, in bytes: the ring's barriers and the
// ring, q and g of the run's samples, the scores and dp' of every (sample,
// head, row) and (m, Z, C/Z) of every (sample, head), the run's ints, and
// its mask rows.
__host__ __device__ inline size_t bwd_grouped_smem(int L, int D, int H, int R, int rows,
                                                   int depth) {
  return (kBarFloats + range_ring_floats(D, rows, depth) + 2 * (size_t)R * row_stride(D) +
          (size_t)R * H * (2 * (size_t)L + 3)) *
             sizeof(float) +
         run_ints(R, L, rows) * sizeof(int) + (((size_t)R * L + 15) & ~(size_t)15);
}

template <int DPL, bool VEC, int DEPTH>
__global__ void __launch_bounds__(kMaxThreads) grouped_bwd_scores_kernel(
    const float* __restrict__ q, const float* __restrict__ tk,
    const float* __restrict__ tv, const float* __restrict__ pe_k,
    const float* __restrict__ pe_v, const uint8_t* __restrict__ mask,
    const float* __restrict__ g, const int32_t* __restrict__ meta,
    const int32_t* __restrict__ seg, float* __restrict__ dq, float* __restrict__ probs,
    float* __restrict__ dscores, int B, int W, int S, int P, int L, int D, int H, int R,
    int rows, int vec) {
  extern __shared__ __align__(16) float smem[];
  const int stride = D;                  // floats between staged rows
  const int qstride = row_stride(D);     // and between rows of q and g
  float* ring_buf = smem + kBarFloats;
  float* qg = ring_buf + range_ring_floats(D, rows, DEPTH);  // [2][R][qstride] q, then g
  float* ss = qg + 2 * (size_t)R * qstride;                // [R][H][L] scores, then p
  float* dps = ss + (size_t)R * H * L;                    // [R][H][L] dp', then ds
  float* stats = dps + (size_t)R * H * L;                 // [R][H][3] m, Z, C/Z
  int* ints = reinterpret_cast<int*>(stats + 3 * (size_t)R * H);
  uint8_t* mk = reinterpret_cast<uint8_t*>(ints + run_ints(R, L, rows));   // [R][L]
  const Run run = Run::at(ints, R);
  if (!run_setup(run, blockIdx.x, meta, seg, B, W, S, P, L, R, rows)) return;
  const int w = run.head[0], j0 = run.head[1], n = run.head[2];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, n_warps = blockDim.x >> 5;
  // The run's mask rows, q and g, a warp per row.
  for (int i = warp; i < 3 * n; i += n_warps) {
    const size_t b_i = run.b[i % n];
    if (i < n) {
      for (int l = lane; l < L; l += 32) mk[i * L + l] = mask[b_i * L + l];
    } else {
      const float* src = (i < 2 * n ? q : g) + b_i * D;
      float* dst = qg + (size_t)(i < 2 * n ? i % n : R + i % n) * qstride;
#pragma unroll 4
      for (int c = lane; c < D; c += 32) dst[c] = src[c];
    }
  }
  const RangeRing<DEPTH> ring{tk + (size_t)w * S * D, tv + (size_t)w * S * D, pe_k, pe_v,
                              run.tiles, run.head[3], run.head[4], run.head[5], run.head[6],
                              D, rows, vec != 0, reinterpret_cast<uint64_t*>(smem), ring_buf};
  ring.start();  // its block-wide barrier also publishes the mask rows, q and g

  const int wph = R / 4;                          // warps per head
  const int h = warp / wph;
  const int si = (warp - h * wph) * 4 + lane / kLanes;   // sample of the run
  const int part = lane & (kLanes - 1);
  const bool has = si < n;
  const int hd = D / H;
  const int col = h * hd + part * DPL;            // this lane's first dim
  const int valid = min(DPL, hd - part * DPL);    // its dims inside the head
  const float* qs = qg + (size_t)(has ? si : 0) * qstride + col;
  const float* gs = qg + (size_t)(R + (has ? si : 0)) * qstride + col;
  const float sqrt_d = sqrtf((float)D);
  // Scores in base 2: s * log2(e) / sqrt(D), so that 2^(s2 - m2) = e^(s - m).
  const float scale2 = kLog2e / sqrt_d;
  const float fill2 = kMaskFill * scale2;
  const int b = has ? run.b[si] : 0;
  const Span tl = has ? run.timeline(si, S) : Span{0, 0, 0, S};
  const Span pe = has ? run.pe(si, L, P) : Span{0, 0, 0, P};
  const uint8_t* mrow = mk + (size_t)(has ? si : 0) * L;
  float* srow = ss + ((size_t)(has ? si : 0) * H + h) * L;
  float* drow = dps + ((size_t)(has ? si : 0) * H + h) * L;

  float a1[DPL], a2[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) a1[i] = a2[i] = 0.f;
  // The running max, this lane's rows' shares of Z and C, and dp of window
  // row 0 (the first row the sample walks).
  float m = -INFINITY, z_part = 0.f, c_part = 0.f, ref = 0.f;
  bool need_ref = true;

  const int n_first = run.head[3];
  for (int t = 0; t < ring.n_tiles(); ++t) {
    const float* kt = ring.acquire(t) + col;
    const float* vt = kt + (size_t)rows * stride;
    const int r0 = run.tiles[t], r1 = r0 + ring.tile_n(t);
    const Span sp = t < n_first ? tl : pe;
    const int la = sp.first_at(r0), cnt = sp.first_at(r1) - la;
    const int most = warp_max_int(cnt);

    for (int i0 = 0; i0 < most; i0 += kLanes) {
      int off[kLanes];
      float vs[kLanes], vd[kLanes];
#pragma unroll
      for (int r = 0; r < kLanes; ++r) {
        off[r] = i0 + r < cnt ? (sp.row(la + i0 + r) - r0) * stride : 0;
        vs[r] = vd[r] = 0.f;
      }
      // Dims outer, rows inner: a step's 16 row reads are in flight
      // together, and the empty asm keeps the compiler from hoisting more
      // (past 128 registers it spills).
      if constexpr (VEC) {
#pragma unroll
        for (int k = 0; k < DPL; k += 4) {
          const float4 q4 = *reinterpret_cast<const float4*>(qs + k);
          const float4 g4 = *reinterpret_cast<const float4*>(gs + k);
#pragma unroll
          for (int r = 0; r < kLanes; ++r) {
            const float4 a = *reinterpret_cast<const float4*>(kt + off[r] + k);
            const float4 c = *reinterpret_cast<const float4*>(vt + off[r] + k);
            vs[r] = fmaf(q4.x, a.x, fmaf(q4.y, a.y, fmaf(q4.z, a.z, fmaf(q4.w, a.w, vs[r]))));
            vd[r] = fmaf(g4.x, c.x, fmaf(g4.y, c.y, fmaf(g4.z, c.z, fmaf(g4.w, c.w, vd[r]))));
          }
          asm volatile("" ::: "memory");
        }
      } else {
#pragma unroll
        for (int r = 0; r < kLanes; ++r) {
          vs[r] = dot_part<DPL, VEC>(kt + off[r], qs, valid);
          vd[r] = dot_part<DPL, VEC>(vt + off[r], gs, valid);
        }
      }
      const float s = scatter8(vs, part);      // q . K and g . V of row i0 + part
      const float dp = scatter8(vd, part);
      // The sample's first chunk with rows starts at window row 0.
      const float dp0 = __shfl_sync(kFull, dp, 0, kLanes);
      if (need_ref && cnt > 0) {
        ref = dp0;
        need_ref = false;
      }
      const int i = i0 + part, l = la + i;
      const bool act = i < cnt;
      const bool live = act && mrow[l];
      const float s2 = act ? (live ? s * scale2 : fill2) : -INFINITY;
      const float dpv = dp - ref;
      if (act) {
        srow[l] = s2;
        drow[l] = dpv;
      }
      float u;
      const float alpha = online_step(m, s2, u);
      z_part = fmaf(z_part, alpha, u);
      c_part = fmaf(c_part, alpha, u * dpv);
      const float w1 = live ? u * dpv : 0.f, w2 = live ? u : 0.f;
#pragma unroll
      for (int k = 0; k < DPL; ++k) {
        a1[k] *= alpha;
        a2[k] *= alpha;
      }
#pragma unroll
      for (int r = 0; r < kLanes; ++r) {
        const float c1 = __shfl_sync(kFull, w1, r, kLanes);
        const float c2 = __shfl_sync(kFull, w2, r, kLanes);
        axpy_part<DPL, VEC>(c1, kt + off[r], a1, valid);
        axpy_part<DPL, VEC>(c2, kt + off[r], a2, valid);
        if (r & 1) asm volatile("" ::: "memory");
      }
    }
    __syncthreads();  // frees the stage for a later tile
  }

  // dq of this lane's dims; then p and ds of every (sample, head, row) of
  // the run, written in sorted order.
  const float z = sum8(z_part), cz = sum8(c_part) / z;
  if (has) {
    const float scale = 1.f / (z * sqrt_d);
#pragma unroll
    for (int i = 0; i < DPL; ++i)
      if (i < valid) dq[(size_t)b * D + col + i] = (a1[i] - cz * a2[i]) * scale;
    if (part == 0) {
      float* st = stats + 3 * ((size_t)si * H + h);
      st[0] = m;
      st[1] = z;
      st[2] = cz;
    }
  }
  __syncthreads();
  const size_t base = (size_t)j0 * H * L;
  for (int e = threadIdx.x; e < n * H * L; e += blockDim.x) {
    const float* st = stats + 3 * (e / L);
    const float p = exp2f(ss[e] - st[0]) / st[1];
    probs[base + e] = p;
    dscores[base + e] = mk[(e / (H * L)) * L + e % L] ? p * (dps[e] - st[2]) / sqrt_d : 0.f;
  }
}

// Pass 2. blockIdx.x < W * tiles_s: timeline tile (worker, row tile); above:
// PE tile (row tile, sample chunk). A thread per column unit of VW floats
// (one head's), kRows rows each, summed in registers. The candidates are
// staged kCand at a time: those whose window meets the tile are listed in
// sorted order, their p and ds at the tile's rows gathered into shared memory
// (zero where a row is not theirs), and then summed kBatch at a time, whose
// q and g loads are in flight together.
template <int VW>
__global__ void __launch_bounds__(kMaxThreads) grouped_bwd_reduce_kernel(
    const float* __restrict__ q, const float* __restrict__ g,
    const int32_t* __restrict__ meta, const int32_t* __restrict__ seg,
    const float* __restrict__ probs, const float* __restrict__ dscores,
    float* __restrict__ dtk, float* __restrict__ dtv, float* __restrict__ part_k,
    float* __restrict__ part_v, int B, int W, int S, int P, int L, int D, int H, int tiles_s,
    int tiles_p) {
  extern __shared__ __align__(16) float pd[];   // [kCand][H][kRows] p, then ds
  __shared__ int c_j[kCand], c_b[kCand], c_base[kCand], c_lo[kCand], c_hi[kCand];
  __shared__ int c_list[kCand];                 // the candidates that meet the tile
  __shared__ int range[3];
  float* ds_s = pd + (size_t)kCand * H * kRows;
  const int lane = threadIdx.x & 31;
  const bool is_pe = (int)blockIdx.x >= W * tiles_s;
  int w = 0, chunk = 0, t0, n_rows;
  if (!is_pe) {
    w = blockIdx.x / tiles_s;
    t0 = (blockIdx.x - w * tiles_s) * kRows;
    n_rows = S;
    if (threadIdx.x < 32) {
      // The samples of worker w with start in [t0 - L + 1, t0 + kRows): their
      // starts grow along the segment, so counting those below each end
      // finds the range.
      const int s0 = seg[w], s1 = seg[w + 1];
      int below_lo = 0, below_hi = 0;
      for (int j = s0 + lane; j - lane < s1; j += 32) {
        const int st = j < s1 ? meta[2 * (size_t)B + j] : 0x7fffffff;
        below_lo += __popc(__ballot_sync(kFull, st < t0 - L + 1));
        below_hi += __popc(__ballot_sync(kFull, st < t0 + kRows));
      }
      if (lane == 0) {
        range[0] = s0 + below_lo;
        range[1] = s0 + below_hi;
      }
    }
  } else {
    const int k = blockIdx.x - W * tiles_s;
    chunk = k / tiles_p;
    t0 = (k - chunk * tiles_p) * kRows;
    n_rows = P;
    if (threadIdx.x == 0) {
      range[0] = chunk * kPeChunk;
      range[1] = min(B, (chunk + 1) * kPeChunk);
    }
  }
  __syncthreads();
  const int j_lo = range[0], j_hi = range[1];

  const int hd = D / H;
  const int c = threadIdx.x * VW;                 // first column of this thread
  const bool on = c < D;
  const int h = on ? c / hd : 0;
  float acc_k[kRows][VW], acc_v[kRows][VW];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int e = 0; e < VW; ++e) acc_k[r][e] = acc_v[r][e] = 0.f;

  for (int c0 = j_lo; c0 < j_hi; c0 += kCand) {
    const int n = min(kCand, j_hi - c0);
    __syncthreads();  // the previous candidates have been read
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int j = c0 + i;
      const int nv = min(max((int)meta[3 * (size_t)B + j], 0), L);
      const int base = is_pe ? meta[4 * (size_t)B + j] : meta[2 * (size_t)B + j];
      // Window rows [lo, hi) land in this table; none where w_idx is not w.
      const int lo = is_pe ? nv : 0;
      const int hi = is_pe ? L : (meta[(size_t)B + j] == w ? nv : 0);
      const bool meets = lo < hi && base + hi > t0 && base + lo < t0 + kRows;
      c_j[i] = meets ? j : -1;
      c_b[i] = meta[j];
      c_base[i] = base;
      c_lo[i] = lo;
      c_hi[i] = hi;
    }
    __syncthreads();
    // Warp 0 lists the candidates that meet the tile, in sorted order.
    if (threadIdx.x < 32) {
      int at = 0;
      for (int i0 = 0; i0 < n; i0 += 32) {
        const bool ok = i0 + lane < n && c_j[i0 + lane] >= 0;
        const unsigned mask_ok = __ballot_sync(kFull, ok);
        if (ok) c_list[at + __popc(mask_ok & ((1u << lane) - 1u))] = i0 + lane;
        at += __popc(mask_ok);
      }
      if (lane == 0) range[2] = at;
    }
    __syncthreads();
    const int m = range[2];
    // p and ds of each listed candidate at the tile's rows, every head.
    for (int e = threadIdx.x; e < m * H * kRows; e += blockDim.x) {
      const int k = e / (H * kRows), hh = (e / kRows) % H, r = e % kRows;
      const int i = c_list[k];
      const int l = t0 + r - c_base[i];
      const bool mine = l >= c_lo[i] && l < c_hi[i];
      const size_t at = ((size_t)c_j[i] * H + hh) * L + l;
      pd[e] = mine ? probs[at] : 0.f;
      ds_s[e] = mine ? dscores[at] : 0.f;
    }
    __syncthreads();
    if (!on) continue;
    for (int k0 = 0; k0 < m; k0 += kBatch) {
      float qv[kBatch][VW], gv[kBatch][VW];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int b = k0 + u < m ? c_b[c_list[k0 + u]] : c_b[c_list[k0]];
        const float* qr = q + (size_t)b * D + c;
        const float* gr = g + (size_t)b * D + c;
        if constexpr (VW == 4) {
          const float4 x = *reinterpret_cast<const float4*>(qr);
          const float4 y = *reinterpret_cast<const float4*>(gr);
          qv[u][0] = x.x; qv[u][1] = x.y; qv[u][2] = x.z; qv[u][3] = x.w;
          gv[u][0] = y.x; gv[u][1] = y.y; gv[u][2] = y.z; gv[u][3] = y.w;
        } else {
#pragma unroll
          for (int e = 0; e < VW; ++e) {
            qv[u][e] = qr[e];
            gv[u][e] = gr[e];
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (k0 + u >= m) break;
        const float* pr = pd + ((size_t)(k0 + u) * H + h) * kRows;
        const float* dr = ds_s + ((size_t)(k0 + u) * H + h) * kRows;
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float p = pr[r], ds = dr[r];
#pragma unroll
          for (int e = 0; e < VW; ++e) {
            acc_k[r][e] = fmaf(ds, qv[u][e], acc_k[r][e]);
            acc_v[r][e] = fmaf(p, gv[u][e], acc_v[r][e]);
          }
        }
      }
    }
  }

  if (!on) return;
  float* out_k = is_pe ? part_k + (size_t)chunk * P * D : dtk + (size_t)w * S * D;
  float* out_v = is_pe ? part_v + (size_t)chunk * P * D : dtv + (size_t)w * S * D;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = t0 + r;
    if (row >= n_rows) break;
    const size_t off = (size_t)row * D + c;
    if constexpr (VW == 4) {
      *reinterpret_cast<float4*>(out_k + off) =
          make_float4(acc_k[r][0], acc_k[r][1], acc_k[r][2], acc_k[r][3]);
      *reinterpret_cast<float4*>(out_v + off) =
          make_float4(acc_v[r][0], acc_v[r][1], acc_v[r][2], acc_v[r][3]);
    } else {
#pragma unroll
      for (int e = 0; e < VW; ++e) {
        out_k[off + e] = acc_k[r][e];
        out_v[off + e] = acc_v[r][e];
      }
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

struct ScoresInstances {
  using Fn = void (*)(const float*, const float*, const float*, const float*, const float*,
                      const uint8_t*, const float*, const int32_t*, const int32_t*, float*,
                      float*, float*, int, int, int, int, int, int, int, int, int, int);
  template <int DPL, bool VEC, int DEPTH>
  static Fn get() {
    return grouped_bwd_scores_kernel<DPL, VEC, DEPTH>;
  }
};

}  // namespace

// The number of sorted samples summed into one PE partial: the wrapper sizes
// part_k/part_v as (ceil(B / this), P, D).
extern "C" int window_attention_bwd_grouped_pe_chunk() { return kPeChunk; }

// Launches the sort and the three passes on `stream` and returns the first
// launch error (0 = launched), or cudaErrorInvalidValue for shapes or a plan
// the kernel cannot run. Pointers are device pointers to contiguous arrays:
//   q, g, dq (B, D); tk/tv, dtk/dtv (W, S, D); pe_k/pe_v, dpk/dpv (P, D):
//   float32; w_idx/start/n_valid/s_lo (B,): int32; mask (B, L): uint8 (0/1);
//   scratch meta (5, B) and seg (W + 1,): int32; probs/dscores (B, H, L) and
//   part_k/part_v (ceil(B / kPeChunk), P, D): float32.
// Every output entry is written; nothing needs zeroing first. The plan of
// pass 1: R samples per run (4 or 8), `rows` table rows per tile, a ring of
// `depth` tiles (2 or 4), `threads` = H * R * 8, and `smem` bytes of dynamic
// shared memory, which must be what the plan needs.
extern "C" int window_attention_bwd_grouped(
    const void* q, const void* tk, const void* tv, const void* pe_k,
    const void* pe_v, const void* w_idx, const void* start,
    const void* n_valid, const void* s_lo, const void* mask, const void* g,
    void* meta, void* seg, void* probs, void* dscores, void* part_k, void* part_v,
    void* dq, void* dtk, void* dtv, void* dpk, void* dpv, int B, int W, int S, int P, int L,
    int D, int H, int R, int rows, int depth, int threads, int smem, void* stream) {
  if (B <= 0 || W <= 0 || S <= 0 || P <= 0 || L <= 0 || H <= 0 || D % H != 0)
    return (int)cudaErrorInvalidValue;
  if ((R != 4 && R != 8) || rows < 1 || rows > 32 || threads != H * R * 8 ||
      threads > kMaxThreads)
    return (int)cudaErrorInvalidValue;
  const size_t need = bwd_grouped_smem(L, D, H, R, rows, depth);
  if (smem < 0 || (size_t)smem != need || need > kMaxSmem) return (int)cudaErrorInvalidValue;
  const int hd = D / H;
  const ScoresInstances::Fn scores = pick_instance<ScoresInstances>(hd, depth);
  if (scores == nullptr) return (int)cudaErrorInvalidValue;
  const bool vec = D % 4 == 0 && aligned16(tk) && aligned16(tv) && aligned16(pe_k) &&
                   aligned16(pe_v);
  // Pass 2 in float4 columns where a column unit stays in one head and the
  // rows it reads and writes are 16-byte aligned.
  const void* const rows4[] = {q, g, dtk, dtv, part_k, part_v};
  bool vec2 = hd % 4 == 0;
  for (const void* t : rows4) vec2 = vec2 && aligned16(t);
  const int units = vec2 ? D / 4 : D;
  const int threads2 = (units + 31) / 32 * 32;
  if (threads2 > kMaxThreads) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;

  cudaError_t err = launch_grouped_sort(w_idx, start, n_valid, s_lo, B, W, meta, seg, s);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(scores, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  scores<<<(B + R - 1) / R + W, threads, need, s>>>(
      (const float*)q, (const float*)tk, (const float*)tv, (const float*)pe_k,
      (const float*)pe_v, (const uint8_t*)mask, (const float*)g, (const int32_t*)meta,
      (const int32_t*)seg, (float*)dq, (float*)probs, (float*)dscores, B, W, S, P, L, D, H,
      R, rows, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int tiles_s = (S + kRows - 1) / kRows;
  const int tiles_p = (P + kRows - 1) / kRows;
  const int chunks = (B + kPeChunk - 1) / kPeChunk;
  auto reduce = vec2 ? grouped_bwd_reduce_kernel<4> : grouped_bwd_reduce_kernel<1>;
  const size_t smem2 = 2 * (size_t)kCand * H * kRows * sizeof(float);
  if (smem2 > kMaxSmem) return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(reduce, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem2);
  if (err != cudaSuccess) return (int)err;
  reduce<<<W * tiles_s + tiles_p * chunks, threads2, smem2, s>>>(
      (const float*)q, (const float*)g, (const int32_t*)meta, (const int32_t*)seg,
      (const float*)probs, (const float*)dscores, (float*)dtk, (float*)dtv, (float*)part_k,
      (float*)part_v, B, W, S, P, L, D, H, tiles_s, tiles_p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int n = P * D;
  grouped_bwd_pe_sum_kernel<<<(n + kSumThreads - 1) / kSumThreads, kSumThreads, 0, s>>>(
      (const float*)part_k, (const float*)part_v, (float*)dpk, (float*)dpv, n, chunks);
  return (int)cudaGetLastError();
}
