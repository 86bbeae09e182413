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
// What bounds it on an H100: bytes. The per-sample kernel reads every window
// row once per sample that holds it, 2*B*L*D*4 B per call (201 / 403 / 742 MB
// at the flagship / Mystery Path Grid / Mortar Mayhem Grid shapes), from L2.
// Here the minibatch is sorted by (worker, start) (window_runs.cuh), so R
// consecutive sorted samples of one worker, about 8 rows apart in a random
// eighth of a rollout, have windows that overlap almost entirely. A CTA takes
// such a run with all its heads and stages the union of the run's window
// rows once: about 7 * 8 + L rows instead of R * L, some 47 / 80 / 137 MB a
// call. Each staged row then serves every sample of the run.
//
// The design:
// * A sort kernel ranks the minibatch by (worker, start, row) on the card
//   (window_runs.cuh) and writes the sorted samples' fields; no host sync,
//   no library sort. Then a CTA per run (ceil(B / R) + W CTAs, those without
//   a run exit) lists the tiles of its union, timeline rows of its worker
//   then PE rows, skipping tiles no window meets, and streams them through
//   the ring of window_ring.cuh in range mode (TMA bulk copies of full
//   D-wide rows on mbarriers; 4-byte cp.async where rows are not 16-byte
//   aligned).
// * A warp takes one head of four samples: 8 lanes a sample, each lane DPL =
//   head width / 8 dims of q and of the output in registers. Per staged row
//   the four samples read the same row in the common case, so a float4 read
//   of shared memory serves four lanes at once.
// * Each sample walks the window rows l of each tile in order (clamped rows
//   repeat where a window runs past its table, as in the per-sample kernel)
//   in chunks of 8: every lane forms its share of the 8 rows' dot products,
//   and one reduce-scatter (7 shuffles) leaves row r's score in the sample's
//   lane r, which alone scales, masks and exponentiates it. An online
//   softmax in base 2 (a running max m, each lane's share of l, the output
//   o, rescaled when m grows) then folds the chunk's V rows into o, the
//   weights broadcast from their lanes.
// * Each tile's K rows, and its V rows, are one contiguous block of their
//   table, one bulk copy each. The plan takes tiles of 16 rows two deep
//   where two CTAs still share an SM (at D = 256 and 384), else of 8 rows
//   four or two deep: a run's rows come mostly from HBM, not from L2 as the
//   per-sample kernel's do, so copies must be in flight while a tile is used.
// * The output goes straight to row b of `out`: no sorted copy of the inputs
//   or the output is made.
//
// The launch plan (samples per run, rows per tile, threads, shared memory)
// is chosen by the wrapper (etmppo_tpu_torch/ops/window_attention.py,
// `grouped_forward_plan`) and checked here. Built by nvcc into a shared
// library with a plain C interface and loaded with ctypes.

#include "window_ring.cuh"
#include "window_runs.cuh"

namespace {

// Shared memory of one CTA, in bytes: the ring's barriers and the ring, the
// run's ints, and the run's mask rows.
__host__ __device__ inline size_t fwd_grouped_smem(int L, int D, int R, int rows, int depth) {
  return (kBarFloats + range_ring_floats(D, rows, depth)) * sizeof(float) +
         run_ints(R, L, rows) * sizeof(int) + (((size_t)R * L + 15) & ~(size_t)15);
}

template <int DPL, bool VEC, int DEPTH>
__global__ void __launch_bounds__(kMaxThreads) window_attention_fwd_grouped_kernel(
    const float* __restrict__ q, const float* __restrict__ tk,
    const float* __restrict__ tv, const float* __restrict__ pe_k,
    const float* __restrict__ pe_v, const uint8_t* __restrict__ mask,
    const int32_t* __restrict__ meta, const int32_t* __restrict__ seg,
    float* __restrict__ out, int B, int W, int S, int P, int L, int D, int H, int R,
    int rows, int vec) {
  extern __shared__ __align__(16) float smem[];
  float* ring_buf = smem + kBarFloats;
  int* ints = reinterpret_cast<int*>(ring_buf + range_ring_floats(D, rows, DEPTH));
  uint8_t* mk = reinterpret_cast<uint8_t*>(ints + run_ints(R, L, rows));   // [R][L]
  const Run run = Run::at(ints, R);
  if (!run_setup(run, blockIdx.x, meta, seg, B, W, S, P, L, R, rows)) return;
  const int w = run.head[0], n = run.head[2];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, n_warps = blockDim.x >> 5;
  for (int i = warp; i < n; i += n_warps)  // the run's mask rows, a warp per row
    for (int l = lane; l < L; l += 32) mk[i * L + l] = mask[(size_t)run.b[i] * L + l];
  const RangeRing<DEPTH> ring{tk + (size_t)w * S * D, tv + (size_t)w * S * D, pe_k, pe_v,
                              run.tiles, run.head[3], run.head[4], run.head[5], run.head[6],
                              D, rows, vec != 0, reinterpret_cast<uint64_t*>(smem), ring_buf};
  ring.start();  // its block-wide barrier also publishes the mask rows

  const int wph = R / 4;                          // warps per head
  const int h = warp / wph;
  const int si = (warp - h * wph) * 4 + lane / kLanes;   // sample of the run
  const int part = lane & (kLanes - 1);
  const bool has = si < n;
  const int hd = D / H;
  const int col = h * hd + part * DPL;            // this lane's first dim
  const int valid = min(DPL, hd - part * DPL);    // its dims inside the head
  const int stride = D;                           // floats between staged rows
  // Scores in base 2: s * log2(e) / sqrt(D), so that 2^(s2 - m2) = e^(s - m).
  const float scale2 = kLog2e / sqrtf((float)D);
  const float fill2 = kMaskFill * scale2;
  const int b = has ? run.b[si] : 0;
  const Span tl = has ? run.timeline(si, S) : Span{0, 0, 0, S};
  const Span pe = has ? run.pe(si, L, P) : Span{0, 0, 0, P};
  const uint8_t* mrow = mk + (size_t)(has ? si : 0) * L;

  float qr[DPL], o[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) {
    qr[i] = has && i < valid ? q[(size_t)b * D + col + i] : 0.f;
    o[i] = 0.f;
  }
  float m = -INFINITY, l_part = 0.f;   // the running max; this lane's rows' share of l

  const int n_first = run.head[3];
  for (int t = 0; t < ring.n_tiles(); ++t) {
    const float* kt = ring.acquire(t) + col;
    const float* vt = kt + (size_t)rows * stride;
    const int r0 = run.tiles[t], r1 = r0 + ring.tile_n(t);
    const Span sp = t < n_first ? tl : pe;
    const int la = sp.first_at(r0), cnt = sp.first_at(r1) - la;
    const int most = warp_max_int(cnt);

    for (int i0 = 0; i0 < most; i0 += kLanes) {
      // Rows i0 .. i0 + 7 of the sample's part of the tile (past its end:
      // the tile's first row, weight 0).
      int off[kLanes];
      float v[kLanes];
#pragma unroll
      for (int r = 0; r < kLanes; ++r) {
        off[r] = i0 + r < cnt ? (sp.row(la + i0 + r) - r0) * stride : 0;
        v[r] = dot_part<DPL, VEC>(kt + off[r], qr, valid);
      }
      const float s = scatter8(v, part);       // the score of row i0 + part
      const int i = i0 + part;
      const float s2 = i < cnt ? (mrow[la + i] ? s * scale2 : fill2) : -INFINITY;
      float u;
      const float alpha = online_step(m, s2, u);
      l_part = fmaf(l_part, alpha, u);
#pragma unroll
      for (int k = 0; k < DPL; ++k) o[k] *= alpha;
#pragma unroll
      for (int r = 0; r < kLanes; ++r)
        axpy_part<DPL, VEC>(__shfl_sync(kFull, u, r, kLanes), vt + off[r], o, valid);
    }
    __syncthreads();  // frees the stage for a later tile
  }
  const float inv = 1.f / sum8(l_part);
  if (has) {
#pragma unroll
    for (int i = 0; i < DPL; ++i)
      if (i < valid) out[(size_t)b * D + col + i] = o[i] * inv;
  }
}

struct FwdInstances {
  using Fn = void (*)(const float*, const float*, const float*, const float*, const float*,
                      const uint8_t*, const int32_t*, const int32_t*, float*, int, int, int, int,
                      int, int, int, int, int, int);
  template <int DPL, bool VEC, int DEPTH>
  static Fn get() {
    return window_attention_fwd_grouped_kernel<DPL, VEC, DEPTH>;
  }
};

}  // namespace

// The sort alone, for checks of the order on the card: meta [5][B] and seg
// [W + 1] as window_runs.cuh describes them.
extern "C" int window_attention_grouped_sort(const void* w_idx, const void* start,
                                             const void* n_valid, const void* s_lo, void* meta,
                                             void* seg, int B, int W, void* stream) {
  if (B <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  return (int)launch_grouped_sort(w_idx, start, n_valid, s_lo, B, W, meta, seg,
                                  (cudaStream_t)stream);
}

// Launches the sort and the kernel on `stream` and returns the first launch
// error (0 = launched), or cudaErrorInvalidValue for shapes or a plan the
// kernel cannot run. Pointers are device pointers to contiguous arrays:
//   q (B, D), tk/tv (W, S, D), pe_k/pe_v (P, D), out (B, D): float32;
//   w_idx/start/n_valid/s_lo (B,): int32; mask (B, L): uint8 (0/1);
//   scratch meta (5, B) and seg (W + 1,): int32.
// The plan: R samples per run (4 or 8), `rows` table rows per tile, a ring
// of `depth` tiles (2 or 4), `threads` = H * R * 8, and `smem` bytes of
// dynamic shared memory, which must be what the plan needs.
extern "C" int window_attention_fwd_grouped(
    const void* q, const void* tk, const void* tv, const void* pe_k,
    const void* pe_v, const void* w_idx, const void* start,
    const void* n_valid, const void* s_lo, const void* mask, void* meta,
    void* seg, void* out, int B, int W, int S, int P, int L, int D,
    int H, int R, int rows, int depth, int threads, int smem, void* stream) {
  if (B <= 0 || W <= 0 || S <= 0 || P <= 0 || L <= 0 || H <= 0 || D % H != 0)
    return (int)cudaErrorInvalidValue;
  if ((R != 4 && R != 8) || rows < 1 || rows > 32 || threads != H * R * 8 ||
      threads > kMaxThreads)
    return (int)cudaErrorInvalidValue;
  const size_t need = fwd_grouped_smem(L, D, R, rows, depth);
  if (smem < 0 || (size_t)smem != need || need > kMaxSmem) return (int)cudaErrorInvalidValue;
  const FwdInstances::Fn kernel = pick_instance<FwdInstances>(D / H, depth);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  const bool vec = D % 4 == 0 && aligned16(tk) && aligned16(tv) && aligned16(pe_k) &&
                   aligned16(pe_v);
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = launch_grouped_sort(w_idx, start, n_valid, s_lo, B, W, meta, seg, s);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(B + R - 1) / R + W, threads, need, s>>>(
      (const float*)q, (const float*)tk, (const float*)tv, (const float*)pe_k,
      (const float*)pe_v, (const uint8_t*)mask, (const int32_t*)meta, (const int32_t*)seg,
      (float*)out, B, W, S, P, L, D, H, R, rows, vec);
  return (int)cudaGetLastError();
}
