// Runs of the grouped window-attention kernels (window_attention_fwd_grouped.cu,
// window_attention_bwd_grouped.cu): the sort of the minibatch by (worker,
// start), the runs of consecutive sorted samples of one worker that a CTA
// takes, and the tiles of table rows a run stages. Include after
// window_ring.cuh. The wrapper (etmppo_tpu_torch/ops/window_attention.py)
// states the same walk in Python (`grouped_order`, `grouped_runs`,
// `run_tiles`, `reduce_candidates`) for the CPU tests.
//
// The sort. Sample b's key is (clamp(w_idx[b], 0, W - 1), start[b], b): every
// key differs, so ranking each key among all B is a stable sort. A CTA per
// worker lists that worker's samples and ranks each among them by (start,
// b), after the seg[w] samples of the workers below, with integer counts
// only, so the order is a pure function of the inputs. `meta` receives the sorted samples' fields ([5][B]: original row b, w_idx,
// start, n_valid, s_lo) and `seg` (W + 1) the first sorted position of each
// clamped worker.
//
// The runs. Worker w's sorted samples [seg[w], seg[w+1]) are cut into runs
// of R: run c is [seg[w] + c R, min(seg[w] + (c + 1) R, seg[w+1])). Run (w,
// c) goes to CTA seg[w] / R + w + c. That number is distinct for every run
// and below ceil(B / R) + W, so the kernels launch that many CTAs and a CTA
// that finds no run exits.

#pragma once

namespace {

constexpr int kSortThreads = 256;
constexpr int kNoSpan = 0x7fffffff;

// One CTA per clamped worker w: stages w_idx and start of the minibatch in
// shared memory, lists the rows of w's samples (and counts the samples of
// the workers below w, seg[w]), then ranks each of w's samples among them by
// (start, row). Dynamic shared memory: 3 * B ints.
__global__ void __launch_bounds__(kSortThreads) grouped_sort_kernel(
    const int32_t* __restrict__ w_idx, const int32_t* __restrict__ start,
    const int32_t* __restrict__ n_valid, const int32_t* __restrict__ s_lo, int B, int W,
    int32_t* __restrict__ meta, int32_t* __restrict__ seg) {
  extern __shared__ int sort_smem[];
  __shared__ int warp_n[kSortThreads / 32];
  int* ws = sort_smem;          // [B] clamped w_idx
  int* ss = ws + B;             // [B] start
  int* mine = ss + B;           // [n_w] rows of worker w, in row order
  const int w = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll 8
  for (int i = threadIdx.x; i < B; i += kSortThreads) {  // loads in flight together
    ws[i] = min(max((int)w_idx[i], 0), W - 1);
    ss[i] = start[i];
  }
  __syncthreads();
  int below = 0, n_w = 0;
  for (int base = 0; base < B; base += kSortThreads) {
    const int i = base + threadIdx.x;
    const int cw = i < B ? ws[i] : W;
    const unsigned m = __ballot_sync(kFull, cw == w);
    if (lane == 0) warp_n[warp] = __popc(m);
    below += __syncthreads_count(cw < w);  // also publishes warp_n
    int at = n_w, total = 0;
    for (int k = 0; k < kSortThreads / 32; ++k) {
      at += k < warp ? warp_n[k] : 0;
      total += warp_n[k];
    }
    if (cw == w) mine[at + __popc(m & ((1u << lane) - 1u))] = i;
    n_w += total;
    __syncthreads();  // warp_n is read before the next round writes it
  }
  if (threadIdx.x == 0) {
    seg[w] = below;
    if (w == W - 1) seg[W] = B;
  }
  for (int k = threadIdx.x; k < n_w; k += kSortThreads) {
    const int i = mine[k], st = ss[i];
    int r = 0;
    for (int k2 = 0; k2 < n_w; ++k2) {
      const int i2 = mine[k2], st2 = ss[i2];
      r += (st2 < st) | ((st2 == st) & (i2 < i));
    }
    const int at = below + r;
    meta[at] = i;
    meta[(size_t)B + at] = w_idx[i];
    meta[2 * (size_t)B + at] = st;
    meta[3 * (size_t)B + at] = n_valid[i];
    meta[4 * (size_t)B + at] = s_lo[i];
  }
}

// Launches the sort on `stream`; cudaErrorInvalidValue where its staging of
// the minibatch would not fit in shared memory.
inline cudaError_t launch_grouped_sort(const void* w_idx, const void* start,
                                       const void* n_valid, const void* s_lo, int B, int W,
                                       void* meta, void* seg, cudaStream_t stream) {
  const size_t smem = 3 * (size_t)B * sizeof(int);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        grouped_sort_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  grouped_sort_kernel<<<W, kSortThreads, smem, stream>>>(
      (const int32_t*)w_idx, (const int32_t*)start, (const int32_t*)n_valid,
      (const int32_t*)s_lo, B, W, (int32_t*)meta, (int32_t*)seg);
  return cudaGetLastError();
}

// The window row l of a sample in one of its two tables and where it lies
// there: l in [la, lb) reads row clamp(base + l, 0, n - 1), as the per-sample
// kernels read it (timeline: [0, n_valid), base start, n = S; PE table:
// [n_valid, L), base s_lo, n = P). Rows grow with l.
struct Span {
  int base, la, lb, n;

  __device__ __forceinline__ int row(int l) const { return min(max(base + l, 0), n - 1); }
  // The first l in [la, lb) whose row is >= x (lb if none).
  __device__ __forceinline__ int first_at(int x) const {
    if (x <= 0) return la;
    if (x > n - 1) return lb;
    return min(max(x - base, la), lb);
  }
  // The rows [a, b) the span covers, or an empty [kNoSpan, -kNoSpan).
  __device__ __forceinline__ int lo() const { return la < lb ? row(la) : kNoSpan; }
  __device__ __forceinline__ int hi() const { return la < lb ? row(lb - 1) + 1 : -kNoSpan; }
};

// A warp of the grouped kernels takes one head of four samples of a run:
// kLanes lanes a sample, each holding DPL dims of the head in registers (dims
// part * DPL + [0, valid)), and walks the window rows in chunks of kLanes
// rows. VEC: DPL is a multiple of 4 and the lane's dims start 16-byte aligned
// in shared memory.
constexpr int kLanes = 8;
constexpr float kLog2e = 1.4426950408889634f;

// This lane's share of a . x over its dims.
template <int DPL, bool VEC>
__device__ __forceinline__ float dot_part(const float* a, const float (&x)[DPL], int valid) {
  float s = 0.f;
  if constexpr (VEC) {
#pragma unroll
    for (int i = 0; i < DPL; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(a + i);
      s = fmaf(x[i], v.x, fmaf(x[i + 1], v.y, fmaf(x[i + 2], v.z, fmaf(x[i + 3], v.w, s))));
    }
  } else {
#pragma unroll
    for (int i = 0; i < DPL; ++i)
      if (i < valid) s = fmaf(x[i], a[i], s);
  }
  return s;
}

// The same with x in shared memory.
template <int DPL, bool VEC>
__device__ __forceinline__ float dot_part(const float* a, const float* x, int valid) {
  float s = 0.f;
  if constexpr (VEC) {
#pragma unroll
    for (int i = 0; i < DPL; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(a + i);
      const float4 y = *reinterpret_cast<const float4*>(x + i);
      s = fmaf(y.x, v.x, fmaf(y.y, v.y, fmaf(y.z, v.z, fmaf(y.w, v.w, s))));
    }
  } else {
#pragma unroll
    for (int i = 0; i < DPL; ++i)
      if (i < valid) s = fmaf(x[i], a[i], s);
  }
  return s;
}

// x += c * a over this lane's dims.
template <int DPL, bool VEC>
__device__ __forceinline__ void axpy_part(float c, const float* a, float (&x)[DPL], int valid) {
  if constexpr (VEC) {
#pragma unroll
    for (int i = 0; i < DPL; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(a + i);
      x[i] = fmaf(c, v.x, x[i]);
      x[i + 1] = fmaf(c, v.y, x[i + 1]);
      x[i + 2] = fmaf(c, v.z, x[i + 2]);
      x[i + 3] = fmaf(c, v.w, x[i + 3]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < DPL; ++i)
      if (i < valid) x[i] = fmaf(c, a[i], x[i]);
  }
}

// The 8 lanes of a sample each hold partial sums v[r] of 8 rows; returns, in
// lane `part`, the full sum of row `part` (a reduce-scatter: 7 shuffles for
// 8 rows).
__device__ __forceinline__ float scatter8(float (&v)[kLanes], int part) {
#pragma unroll
  for (int half = 4; half >= 1; half >>= 1) {
    const bool up = part & half;
#pragma unroll
    for (int k = 0; k < half; ++k) {
      const float send = up ? v[k] : v[k + half];
      const float keep = up ? v[k + half] : v[k];
      v[k] = keep + __shfl_xor_sync(kFull, send, half);
    }
  }
  return v[0];
}

// The sum and the max over the 8 lanes of a sample.
__device__ __forceinline__ float sum8(float x) {
#pragma unroll
  for (int off = 1; off < kLanes; off <<= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}
__device__ __forceinline__ float max8(float x) {
#pragma unroll
  for (int off = 1; off < kLanes; off <<= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, off));
  return x;
}

// The most of x over the warp (a sample's tile rows, the loop bound).
__device__ __forceinline__ int warp_max_int(int x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = max(x, __shfl_xor_sync(kFull, x, off));
  return x;
}

// Online-softmax step in base 2 for one chunk: m is the running max, s2 this
// lane's scaled score (-inf where its row is past the window). Returns the
// factor that rescales the sums (1 while nothing has been seen) and sets u =
// 2^(s2 - m_new) (0 past the window).
__device__ __forceinline__ float online_step(float& m, float s2, float& u) {
  const float m_new = fmaxf(m, max8(s2));
  const float alpha = m_new == -INFINITY ? 1.f : exp2f(m - m_new);
  u = s2 == -INFINITY ? 0.f : exp2f(s2 - m_new);
  m = m_new;
  return alpha;
}

// The grouped kernels' dims a lane for a head width up to kMaxHeadWidth:
// float4 reads where the width is a multiple of 32 (DPL = width / 8, a
// multiple of 4), else scalar reads of 2, 4 or 16 dims a lane, the fewest
// that cover it (ptxas 12.9 crashes on some scalar instances of 8 and 32);
// 0 past kMaxHeadWidth.
constexpr int kMaxHeadWidth = 128;
inline int lane_dims(int hd, bool* vec) {
  *vec = hd % 32 == 0;
  if (hd > kMaxHeadWidth) return 0;
  if (*vec) return hd / 8;
  const int need = (hd + 7) / 8;
  return need <= 2 ? 2 : need <= 4 ? 4 : 16;
}

// A kernel's instance for (dims a lane, float4 reads, ring depth): K has a
// function-pointer type Fn and a static get<DPL, VEC, DEPTH>(). Null where
// none exists.
template <class K, int DPL, bool VEC>
typename K::Fn by_depth(int depth) {
  switch (depth) {
    case 2: return K::template get<DPL, VEC, 2>();
    case 4: return K::template get<DPL, VEC, kMaxDepth>();
    default: return nullptr;
  }
}

template <class K>
typename K::Fn pick_instance(int hd, int depth) {
  bool vec;
  const int dpl = lane_dims(hd, &vec);
  if (vec) {
    switch (dpl) {
      case 4: return by_depth<K, 4, true>(depth);
      case 8: return by_depth<K, 8, true>(depth);
      case 12: return by_depth<K, 12, true>(depth);
      case 16: return by_depth<K, 16, true>(depth);
      default: return nullptr;
    }
  }
  switch (dpl) {
    case 2: return by_depth<K, 2, false>(depth);
    case 4: return by_depth<K, 4, false>(depth);
    case 16: return by_depth<K, 16, false>(depth);
    default: return nullptr;
  }
}

// Ints of a run's setup in shared memory: a head, five fields of each of up
// to R samples, and the tile list. A window of L rows meets at most
// ceil(L / rows) + 1 tiles of one table.
constexpr int kRunHead = 8;
constexpr int kRunFields = 5;
__host__ __device__ inline int run_tile_cap(int R, int L, int rows) {
  return 2 * R * ((L + rows - 1) / rows + 1);
}
__host__ __device__ inline size_t run_ints(int R, int L, int rows) {
  return kRunHead + kRunFields * (size_t)R + run_tile_cap(R, L, rows);
}

// A run's setup, views of shared memory.
struct Run {
  int* head;  // w (-1: no run), j0, n samples, n timeline tiles, n tiles, hi0, hi1
  int* b;     // [R] original row
  int* wr;    // [R] w_idx as given
  int* st;    // [R] start
  int* nv;    // [R] n_valid clamped to [0, L]
  int* slo;   // [R] s_lo
  int* tiles; // [run_tile_cap] first table row of each tile

  __device__ static Run at(int* p, int R) {
    int* f = p + kRunHead;
    return Run{p, f, f + R, f + 2 * R, f + 3 * R, f + 4 * R, f + kRunFields * R};
  }
  __device__ __forceinline__ Span timeline(int i, int S) const { return Span{st[i], 0, nv[i], S}; }
  __device__ __forceinline__ Span pe(int i, int L, int P) const {
    return Span{slo[i], nv[i], L, P};
  }
};

// Warp 0: appends to `tiles` (from `at`) the first row of each tile
// [r0, min(r0 + rows, hi)), r0 = lo + k rows, that meets one of the spans
// [span(i).lo(), span(i).hi()) of n samples. Returns the new count.
template <class SpanOf>
__device__ __forceinline__ int list_tiles(int lo, int hi, int rows, int n, const SpanOf& span,
                                          int* tiles, int at) {
  const int lane = threadIdx.x & 31;
  for (int base = lo; base < hi; base += 32 * rows) {
    const int r0 = base + lane * rows, r1 = min(r0 + rows, hi);
    bool meets = false;
    if (r0 < hi)
      for (int i = 0; i < n; ++i) {
        const Span s = span(i);
        meets |= s.lo() < r1 && s.hi() > r0;
      }
    const unsigned m = __ballot_sync(kFull, meets);
    if (meets) tiles[at + __popc(m & ((1u << lane) - 1u))] = r0;
    at += __popc(m);
  }
  return at;
}

// Called by all threads first: finds CTA x's run, reads its samples' fields
// from the sorted `meta`, and lists the tiles of the union of their windows:
// timeline rows of the worker, then PE rows, skipping tiles that no window
// meets. Returns false (in every thread) where the CTA has no run.
__device__ bool run_setup(const Run& run, int x, const int32_t* __restrict__ meta,
                          const int32_t* __restrict__ seg, int B, int W, int S, int P, int L,
                          int R, int rows) {
  const int lane = threadIdx.x & 31;
  if (threadIdx.x < 32) {
    // f(w) = seg[w] / R + w grows with w: the run's worker is the last w
    // with f(w) <= x.
    int below = 0;
    for (int base = 0; base < W; base += 32) {
      const int w = base + lane;
      below += __popc(__ballot_sync(kFull, w < W && seg[w] / R + w <= x));
    }
    if (lane == 0) {
      const int w = below - 1;
      const int j0 = seg[w] + (x - (seg[w] / R + w)) * R;
      const int end = seg[w + 1];
      run.head[0] = j0 < end ? w : -1;
      run.head[1] = j0;
      run.head[2] = min(R, end - j0);
    }
  }
  __syncthreads();
  if (run.head[0] < 0) return false;
  const int j0 = run.head[1], n = run.head[2];
  if ((int)threadIdx.x < n) {
    const int i = threadIdx.x, j = j0 + i;
    run.b[i] = meta[j];
    run.wr[i] = meta[(size_t)B + j];
    run.st[i] = meta[2 * (size_t)B + j];
    run.nv[i] = min(max((int)meta[3 * (size_t)B + j], 0), L);
    run.slo[i] = meta[4 * (size_t)B + j];
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    int lo0 = kNoSpan, hi0 = 0, lo1 = kNoSpan, hi1 = 0;
    for (int i = 0; i < n; ++i) {
      const Span t = run.timeline(i, S), p = run.pe(i, L, P);
      if (t.la < t.lb) {
        lo0 = min(lo0, t.lo());
        hi0 = max(hi0, t.hi());
      }
      if (p.la < p.lb) {
        lo1 = min(lo1, p.lo());
        hi1 = max(hi1, p.hi());
      }
    }
    lo0 = min(lo0, hi0);
    lo1 = min(lo1, hi1);
    const int n0 = list_tiles(lo0, hi0, rows, n, [&](int i) { return run.timeline(i, S); },
                              run.tiles, 0);
    const int n1 = list_tiles(lo1, hi1, rows, n, [&](int i) { return run.pe(i, L, P); },
                              run.tiles, n0);
    if (lane == 0) {
      run.head[3] = n0;
      run.head[4] = n1;
      run.head[5] = hi0;
      run.head[6] = hi1;
    }
  }
  __syncthreads();
  return true;
}

}  // namespace
