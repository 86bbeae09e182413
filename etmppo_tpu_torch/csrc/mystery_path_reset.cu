// Mystery Path Grid's auto-reset in the device rollout
// (envs/mystery_path.py, MysteryPathGridEnv.reset_done).
//
// Replaces no TPU kernel: the JAX package resets every worker at every step
// and keeps the reset where an episode ended (jnp.where over the state), which
// XLA fuses. In PyTorch that path is some 370 elementwise kernels a step, a
// Python loop of 3S - 1 walk moves over (W,) tensors among them, so a captured
// update holds about 190,000 nodes of it. This kernel does the same in one
// launch and rebuilds only the workers whose episode ended.
//
// One block per worker w:
//   done[w] false: copies the worker's state row and frame through.
//   done[w] true:  thread 0 runs the biased walk of 3S - 1 moves into shared
//                  memory (forced forward once the moves left equal the
//                  forward distance left, lateral moves clamped to the arena,
//                  nothing moves once the far edge is reached), exactly as
//                  MysteryPathGridEnv._generate_path; then the block writes
//                  on_path and progress_idx (the first index of each cell
//                  along the walk, -1 off the path), origin, goal, pos =
//                  origin, the zeroed counters, fall_pos = -1, and renders the
//                  fresh frame as MysteryPathGridEnv._observe does: the
//                  checkerboard, the origin and goal marks where shown, no
//                  fall mark (its timer is 0), the agent at the origin,
//                  clamped to [0, 1].
// Every value is an integer or a float32 constant, so the outputs equal the
// PyTorch path's to the bit.
//
// The launch reads and writes fresh output buffers that the wrapper allocates
// (nothing in place), on the caller's stream, allocates nothing and does not
// synchronise.
#include <cuda_runtime.h>

#include <cstdint>

constexpr int kSide = 84;                     // frames are 84 x 84 x 3, HWC
constexpr int kChannels = 3;
constexpr int kFrame = kSide * kSide * kChannels;
constexpr int kMaxSize = kSide;               // a tile of 84 / S >= 1 pixel
constexpr int kMaxWalk = 3 * kMaxSize;
constexpr int kThreads = 256;
// MysteryPathGridEnv._colors
__constant__ float kOriginRGB[3] = {0.2f, 0.8f, 0.2f};
__constant__ float kGoalRGB[3] = {0.9f, 0.8f, 0.1f};
__constant__ float kAgentRGB[3] = {0.1f, 0.3f, 0.95f};

struct ResetArgs {
  const unsigned char* done;     // (W,) bool
  const long long* edge;         // (W,) draws
  const long long* lateral0;     // (W,)
  const long long* moves;        // (W, 3S - 1)
  // the state after the step, and its frame
  const unsigned char* on_path;  // (W, S, S) bool
  const long long* progress;     // (W, S, S)
  const long long* origin;       // (W, 2)
  const long long* goal;         // (W, 2)
  const long long* pos;          // (W, 2)
  const long long* best;         // (W,)
  const long long* fall_pos;     // (W, 2)
  const long long* fall_timer;   // (W,)
  const long long* t;            // (W,)
  const float* reward_sum;       // (W,)
  const long long* length;       // (W,)
  const float* obs;              // (W, 84, 84, 3)
  // outputs, in the same order
  unsigned char* on_path_out;
  long long* progress_out;
  long long* origin_out;
  long long* goal_out;
  long long* pos_out;
  long long* best_out;
  long long* fall_pos_out;
  long long* fall_timer_out;
  long long* t_out;
  float* reward_sum_out;
  long long* length_out;
  float* obs_out;
  int size;
  int show_origin;
  int show_goal;
};

// (forward, lateral) -> (x, y) by edge: 0 left->right, 1 top->bottom,
// 2 right->left, 3 bottom->top (MysteryPathGridEnv._to_xy).
__device__ __forceinline__ void to_xy(long long edge, long long fwd,
                                      long long lat, int S, long long* x,
                                      long long* y) {
  const long long far = S - 1 - fwd;
  *x = edge == 0 ? fwd : (edge == 2 ? far : lat);
  *y = edge == 1 ? fwd : (edge == 3 ? far : lat);
}

// A frame row, by float4 where both rows are 16-byte aligned.
__device__ __forceinline__ void copy_frame(const float* src, float* dst) {
  if (((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst)) &
       15) == 0) {
    const float4* s = reinterpret_cast<const float4*>(src);
    float4* d = reinterpret_cast<float4*>(dst);
    for (int i = threadIdx.x; i < kFrame / 4; i += blockDim.x) d[i] = s[i];
  } else {
    for (int i = threadIdx.x; i < kFrame; i += blockDim.x) dst[i] = src[i];
  }
}

__global__ void __launch_bounds__(kThreads)
    mystery_path_reset_kernel(ResetArgs a) {
  const int w = blockIdx.x;
  const int S = a.size;
  const int cells = S * S;
  const size_t frame = (size_t)w * kFrame;

  if (!a.done[w]) {
    for (int c = threadIdx.x; c < cells; c += blockDim.x) {
      a.on_path_out[(size_t)w * cells + c] = a.on_path[(size_t)w * cells + c];
      a.progress_out[(size_t)w * cells + c] = a.progress[(size_t)w * cells + c];
    }
    if (threadIdx.x < 2) {
      const int i = 2 * w + threadIdx.x;
      a.origin_out[i] = a.origin[i];
      a.goal_out[i] = a.goal[i];
      a.pos_out[i] = a.pos[i];
      a.fall_pos_out[i] = a.fall_pos[i];
    }
    if (threadIdx.x == 0) {
      a.best_out[w] = a.best[w];
      a.fall_timer_out[w] = a.fall_timer[w];
      a.t_out[w] = a.t[w];
      a.reward_sum_out[w] = a.reward_sum[w];
      a.length_out[w] = a.length[w];
    }
    copy_frame(a.obs + frame, a.obs_out + frame);
    return;
  }

  __shared__ long long walk[kMaxWalk];  // cell y * S + x at each index
  __shared__ long long ends[4];         // origin (x, y), goal (x, y)
  const int n_moves = 3 * S - 1;
  if (threadIdx.x == 0) {
    const long long edge = a.edge[w];
    const long long* moves = a.moves + (size_t)w * n_moves;
    long long fwd = 0, lat = a.lateral0[w], x, y;
    bool finished = false;
    to_xy(edge, fwd, lat, S, &x, &y);
    ends[0] = x;
    ends[1] = y;
    walk[0] = y * S + x;
    for (int i = 0; i < n_moves; ++i) {
      const bool force_fwd = (n_moves - i) <= (S - 1) - fwd;
      const long long move = force_fwd ? 0 : moves[i];
      const long long d_lat = move == 1 ? 1 : (move == 2 ? -1 : 0);
      if (!finished) {
        lat += d_lat;
        lat = lat < 0 ? 0 : (lat > S - 1 ? S - 1 : lat);
      }
      if (!finished && move == 0) fwd += 1;
      finished = finished || fwd >= S - 1;
      to_xy(edge, fwd, lat, S, &x, &y);
      walk[i + 1] = y * S + x;
    }
    ends[2] = x;
    ends[3] = y;
  }
  __syncthreads();

  const int n_walk = n_moves + 1;
  for (int c = threadIdx.x; c < cells; c += blockDim.x) {
    long long first = -1;
    for (int i = 0; i < n_walk; ++i) {
      if (walk[i] == c) {
        first = i;
        break;
      }
    }
    a.on_path_out[(size_t)w * cells + c] = first >= 0;
    a.progress_out[(size_t)w * cells + c] = first;
  }
  if (threadIdx.x < 2) {
    const int i = 2 * w + threadIdx.x;
    a.origin_out[i] = ends[threadIdx.x];
    a.goal_out[i] = ends[2 + threadIdx.x];
    a.pos_out[i] = ends[threadIdx.x];
    a.fall_pos_out[i] = -1;
  }
  if (threadIdx.x == 0) {
    a.best_out[w] = 0;
    a.fall_timer_out[w] = 0;
    a.t_out[w] = 0;
    a.reward_sum_out[w] = 0.0f;
    a.length_out[w] = 0;
  }

  const int tile = kSide / S;
  const int off = (kSide - tile * S) / 2;
  for (int i = threadIdx.x; i < kFrame; i += blockDim.x) {
    const int p = i / kChannels, ch = i - p * kChannels;
    const int yy = p / kSide, xx = p - yy * kSide;
    const bool in_arena = xx >= off && xx < off + S * tile && yy >= off &&
                          yy < off + S * tile;
    int cx = (xx - off) / tile, cy = (yy - off) / tile;
    cx = cx < 0 ? 0 : (cx > S - 1 ? S - 1 : cx);
    cy = cy < 0 ? 0 : (cy > S - 1 ? S - 1 : cy);
    float v = in_arena && (cx + cy) % 2 == 0 ? 0.18f : 0.24f;
    const bool at_origin = in_arena && cx == ends[0] && cy == ends[1];
    if (a.show_origin && at_origin) v = kOriginRGB[ch];
    if (a.show_goal && in_arena && cx == ends[2] && cy == ends[3])
      v = kGoalRGB[ch];
    if (at_origin) v = kAgentRGB[ch];  // the agent stands on the origin
    a.obs_out[frame + i] = fminf(fmaxf(v, 0.0f), 1.0f);
  }
}

// Launches the reset of `n_workers` workers of an arena `size` cells wide on
// `stream`: 4 inputs (done, edge, lateral0, moves), the state's 11 fields and
// its frame, then the 11 fields and the frame out. Returns the CUDA error of
// the launch (0: launched).
extern "C" int mystery_path_reset(
    const void* done, const void* edge, const void* lateral0,
    const void* moves, const void* on_path, const void* progress,
    const void* origin, const void* goal, const void* pos, const void* best,
    const void* fall_pos, const void* fall_timer, const void* t,
    const void* reward_sum, const void* length, const void* obs,
    void* on_path_out, void* progress_out, void* origin_out, void* goal_out,
    void* pos_out, void* best_out, void* fall_pos_out, void* fall_timer_out,
    void* t_out, void* reward_sum_out, void* length_out, void* obs_out,
    int n_workers, int size, int show_origin, int show_goal, void* stream) {
  const void* pointers[] = {
      done,         edge,          lateral0,       moves,     on_path,
      progress,     origin,        goal,           pos,       best,
      fall_pos,     fall_timer,    t,              reward_sum, length,
      obs,          on_path_out,   progress_out,   origin_out, goal_out,
      pos_out,      best_out,      fall_pos_out,   fall_timer_out, t_out,
      reward_sum_out, length_out,  obs_out};
  for (const void* p : pointers)
    if (p == nullptr) return (int)cudaErrorInvalidValue;
  if (n_workers < 1 || size < 1 || size > kMaxSize)
    return (int)cudaErrorInvalidValue;
  ResetArgs a;
  a.done = static_cast<const unsigned char*>(done);
  a.edge = static_cast<const long long*>(edge);
  a.lateral0 = static_cast<const long long*>(lateral0);
  a.moves = static_cast<const long long*>(moves);
  a.on_path = static_cast<const unsigned char*>(on_path);
  a.progress = static_cast<const long long*>(progress);
  a.origin = static_cast<const long long*>(origin);
  a.goal = static_cast<const long long*>(goal);
  a.pos = static_cast<const long long*>(pos);
  a.best = static_cast<const long long*>(best);
  a.fall_pos = static_cast<const long long*>(fall_pos);
  a.fall_timer = static_cast<const long long*>(fall_timer);
  a.t = static_cast<const long long*>(t);
  a.reward_sum = static_cast<const float*>(reward_sum);
  a.length = static_cast<const long long*>(length);
  a.obs = static_cast<const float*>(obs);
  a.on_path_out = static_cast<unsigned char*>(on_path_out);
  a.progress_out = static_cast<long long*>(progress_out);
  a.origin_out = static_cast<long long*>(origin_out);
  a.goal_out = static_cast<long long*>(goal_out);
  a.pos_out = static_cast<long long*>(pos_out);
  a.best_out = static_cast<long long*>(best_out);
  a.fall_pos_out = static_cast<long long*>(fall_pos_out);
  a.fall_timer_out = static_cast<long long*>(fall_timer_out);
  a.t_out = static_cast<long long*>(t_out);
  a.reward_sum_out = static_cast<float*>(reward_sum_out);
  a.length_out = static_cast<long long*>(length_out);
  a.obs_out = static_cast<float*>(obs_out);
  a.size = size;
  a.show_origin = show_origin;
  a.show_goal = show_goal;
  mystery_path_reset_kernel<<<n_workers, kThreads, 0,
                              (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
