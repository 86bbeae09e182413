// Mortar Mayhem Grid's auto-reset in the device rollout
// (envs/mortar_mayhem.py, MortarMayhemGridEnv.reset_done).
//
// Replaces no TPU kernel: the JAX package resets every worker at every step
// and keeps the reset where an episode ended (jnp.where over the state), which
// XLA fuses. In PyTorch that path is some 230 small kernels a step: the pick
// of the ten commands is a Python loop over (W, A) tensors, then the targets,
// a full render of all W frames and a where per state field, so a captured
// update holds about 120,000 nodes of it. This kernel does the same in one
// launch and rebuilds only the workers whose episode ended.
//
// A worker's frame is split into kParts equal runs of pixels, one block
// (w, part) each, so that one worker's reset runs on kParts SMs:
//   done[w] false: the block copies its part of the worker's frame through,
//                  and block (w, 0) the worker's state row.
//   done[w] true:  thread 0 of block (w, 0) picks the C commands from the
//                  worker's C uniforms as
//                  MortarMayhemGridEnv.commands_from_uniforms does: from the
//                  tile reached so far, the allowed commands are those whose
//                  next tile stays in the arena; pick = (long)(u * n_allowed),
//                  one float32 multiply as PyTorch promotes it; the command
//                  is the pick-th allowed one in id order (0 if there is
//                  none, as the argmax of no match gives); the walk moves on
//                  to its tile, which is the command's target. Block (w, 0)
//                  also writes pos = the centre and the zeroed counters.
//                  Every block picks command 0 the same way (its glyph is
//                  shown) and renders its part of the fresh frame as
//                  MortarMayhemGridEnv._observe does at t = 0: the
//                  checkerboard, no explosion, the agent's tile, command 0's
//                  glyph in the strip at the top, clamped to [0, 1].
// Every value is an integer, a float32 constant or one float32 product, so
// the outputs equal the PyTorch path's to the bit.
//
// The launch reads and writes fresh output buffers that the wrapper allocates
// (nothing in place), on the caller's stream, allocates nothing and does not
// synchronise.
#include <cuda_runtime.h>

#include <cstdint>

constexpr int kSide = 84;                     // frames are 84 x 84 x 3, HWC
constexpr int kChannels = 3;
constexpr int kFrame = kSide * kSide * kChannels;
constexpr int kMaxArena = kSide;              // a tile of 84 / A >= 1 pixel
constexpr int kMaxAllowed = 9;
constexpr int kGlyph = 20;                    // the command strip's glyphs
constexpr int kStripRow = 1;
constexpr int kStripCol = kSide / 2 - kGlyph / 2;
constexpr int kPixels = kSide * kSide;
constexpr int kParts = 12;                    // blocks a worker
constexpr int kPartPixels = kPixels / kParts;
constexpr int kPartFloats = kChannels * kPartPixels;
// A part is a whole number of pixels and of float4s, so that it starts
// 16-byte aligned wherever the frame does.
static_assert(kPixels % kParts == 0 && kPartFloats % 4 == 0, "parts");
constexpr int kThreads = 128;
// COMMAND_OFFSETS (x, y) by command id; MortarMayhemGridEnv._agent
__constant__ int kOffsetX[kMaxAllowed] = {0, 0, 1, 0, -1, 1, 1, -1, -1};
__constant__ int kOffsetY[kMaxAllowed] = {0, -1, 0, 1, 0, -1, 1, 1, -1};
__constant__ float kAgentRGB[3] = {0.1f, 0.3f, 0.95f};

struct ResetArgs {
  const unsigned char* done;     // (W,) bool
  const float* uniforms;         // (W, C) draws
  const float* glyphs;           // (9, 20, 20) MortarMayhemGridEnv._glyphs
  // the state after the step, and its frame
  const long long* pos;          // (W, 2)
  const long long* commands;     // (W, C)
  const long long* targets;      // (W, C, 2)
  const long long* t;            // (W,)
  const long long* commands_done;  // (W,)
  const unsigned char* failed;   // (W,) bool
  const float* reward_sum;       // (W,)
  const long long* length;       // (W,)
  const float* obs;              // (W, 84, 84, 3)
  // outputs, in the same order
  long long* pos_out;
  long long* commands_out;
  long long* targets_out;
  long long* t_out;
  long long* commands_done_out;
  unsigned char* failed_out;
  float* reward_sum_out;
  long long* length_out;
  float* obs_out;
  int n_commands;
  int arena;
  int allowed;
};

// The command that uniform u picks from tile (x, y) of an arena A wide.
__device__ __forceinline__ int pick_command(int x, int y, float u, int A,
                                            int allowed) {
  bool ok[kMaxAllowed];
  int n_ok = 0;
  for (int c = 0; c < allowed; ++c) {
    const int cx = x + kOffsetX[c], cy = y + kOffsetY[c];
    ok[c] = cx >= 0 && cx < A && cy >= 0 && cy < A;
    n_ok += ok[c];
  }
  const long long pick = (long long)__fmul_rn(u, (float)n_ok);
  for (int c = 0, rank = -1; c < allowed; ++c) {
    rank += ok[c];
    if (ok[c] && rank == pick) return c;
  }
  return 0;
}

__global__ void __launch_bounds__(kThreads)
    mortar_mayhem_reset_kernel(ResetArgs a) {
  const int w = blockIdx.x, part = blockIdx.y;
  const int C = a.n_commands;
  const size_t frame = (size_t)w * kFrame;
  const int first = part * kPartPixels;
  const int last = first + kPartPixels;

  if (!a.done[w]) {
    if (part == 0) {
      for (int i = threadIdx.x; i < 3 * C; i += blockDim.x) {
        if (i < C) {
          a.commands_out[(size_t)w * C + i] = a.commands[(size_t)w * C + i];
        } else {
          const size_t j = (size_t)w * 2 * C + (i - C);
          a.targets_out[j] = a.targets[j];
        }
      }
      if (threadIdx.x < 2) {
        const int i = 2 * w + threadIdx.x;
        a.pos_out[i] = a.pos[i];
      }
      if (threadIdx.x == 0) {
        a.t_out[w] = a.t[w];
        a.commands_done_out[w] = a.commands_done[w];
        a.failed_out[w] = a.failed[w];
        a.reward_sum_out[w] = a.reward_sum[w];
        a.length_out[w] = a.length[w];
      }
    }
    // The part's floats, by float4 where both frames are 16-byte aligned.
    const float* src = a.obs + frame + (size_t)kChannels * first;
    float* dst = a.obs_out + frame + (size_t)kChannels * first;
    if (((reinterpret_cast<uintptr_t>(src) |
          reinterpret_cast<uintptr_t>(dst)) & 15) == 0) {
      const float4* s4 = reinterpret_cast<const float4*>(src);
      float4* d4 = reinterpret_cast<float4*>(dst);
      for (int i = threadIdx.x; i < kPartFloats / 4; i += blockDim.x)
        d4[i] = s4[i];
    } else {
      for (int i = threadIdx.x; i < kPartFloats; i += blockDim.x)
        dst[i] = src[i];
    }
    return;
  }

  const int A = a.arena;
  const int centre = A / 2;
  const float* u = a.uniforms + (size_t)w * C;
  if (part == 0 && threadIdx.x == 0) {
    long long* commands = a.commands_out + (size_t)w * C;
    long long* targets = a.targets_out + (size_t)w * 2 * C;
    int x = centre, y = centre;
    for (int i = 0; i < C; ++i) {
      const int command = pick_command(x, y, u[i], A, a.allowed);
      x += kOffsetX[command];
      y += kOffsetY[command];
      commands[i] = command;
      targets[2 * i] = x;
      targets[2 * i + 1] = y;
    }
  }
  if (part == 0 && threadIdx.x < 2) a.pos_out[2 * w + threadIdx.x] = centre;
  if (part == 0 && threadIdx.x == 0) {
    a.t_out[w] = 0;
    a.commands_done_out[w] = 0;
    a.failed_out[w] = 0;
    a.reward_sum_out[w] = 0.0f;
    a.length_out[w] = 0;
  }

  const float* glyph =
      a.glyphs + pick_command(centre, centre, u[0], A, a.allowed) * kGlyph *
                     kGlyph;
  const int tile = kSide / A;
  const int off = (kSide - tile * A) / 2;
  for (int p = first + threadIdx.x; p < last; p += blockDim.x) {
    const int yy = p / kSide, xx = p - yy * kSide;
    const bool in_arena = xx >= off && xx < off + A * tile && yy >= off &&
                          yy < off + A * tile;
    int cx = (xx - off) / tile, cy = (yy - off) / tile;
    cx = cx < 0 ? 0 : (cx > A - 1 ? A - 1 : cx);
    cy = cy < 0 ? 0 : (cy > A - 1 ? A - 1 : cy);
    const float base = in_arena && (cx + cy) % 2 == 0 ? 0.18f : 0.24f;
    const bool agent = in_arena && cx == centre && cy == centre;
    const int gy = yy - kStripRow, gx = xx - kStripCol;
    const bool strip = gy >= 0 && gy < kGlyph && gx >= 0 && gx < kGlyph;
    const float g = strip ? glyph[gy * kGlyph + gx] : 0.0f;
    float* out = a.obs_out + frame + (size_t)kChannels * p;
    for (int ch = 0; ch < kChannels; ++ch) {
      float v = agent ? kAgentRGB[ch] : base;
      if (strip) v = fmaxf(v, g);
      out[ch] = fminf(fmaxf(v, 0.0f), 1.0f);
    }
  }
}

// Launches the reset of `n_workers` workers, each with `n_commands` commands
// among the first `allowed` ids in an arena `arena` tiles wide, on `stream`:
// 3 inputs (done, uniforms, glyphs), the state's 8 fields and its frame,
// then the 8 fields and the frame out. Returns the CUDA error of the launch
// (0: launched).
extern "C" int mortar_mayhem_reset(
    const void* done, const void* uniforms, const void* glyphs,
    const void* pos, const void* commands, const void* targets, const void* t,
    const void* commands_done, const void* failed, const void* reward_sum,
    const void* length, const void* obs, void* pos_out, void* commands_out,
    void* targets_out, void* t_out, void* commands_done_out, void* failed_out,
    void* reward_sum_out, void* length_out, void* obs_out, int n_workers,
    int n_commands, int arena, int allowed, void* stream) {
  const void* pointers[] = {
      done,       uniforms,      glyphs,         pos,           commands,
      targets,    t,             commands_done,  failed,        reward_sum,
      length,     obs,           pos_out,        commands_out,  targets_out,
      t_out,      commands_done_out, failed_out, reward_sum_out, length_out,
      obs_out};
  for (const void* p : pointers)
    if (p == nullptr) return (int)cudaErrorInvalidValue;
  if (n_workers < 1 || n_commands < 1 || arena < 1 || arena > kMaxArena ||
      allowed < 1 || allowed > kMaxAllowed)
    return (int)cudaErrorInvalidValue;
  ResetArgs a;
  a.done = static_cast<const unsigned char*>(done);
  a.uniforms = static_cast<const float*>(uniforms);
  a.glyphs = static_cast<const float*>(glyphs);
  a.pos = static_cast<const long long*>(pos);
  a.commands = static_cast<const long long*>(commands);
  a.targets = static_cast<const long long*>(targets);
  a.t = static_cast<const long long*>(t);
  a.commands_done = static_cast<const long long*>(commands_done);
  a.failed = static_cast<const unsigned char*>(failed);
  a.reward_sum = static_cast<const float*>(reward_sum);
  a.length = static_cast<const long long*>(length);
  a.obs = static_cast<const float*>(obs);
  a.pos_out = static_cast<long long*>(pos_out);
  a.commands_out = static_cast<long long*>(commands_out);
  a.targets_out = static_cast<long long*>(targets_out);
  a.t_out = static_cast<long long*>(t_out);
  a.commands_done_out = static_cast<long long*>(commands_done_out);
  a.failed_out = static_cast<unsigned char*>(failed_out);
  a.reward_sum_out = static_cast<float*>(reward_sum_out);
  a.length_out = static_cast<long long*>(length_out);
  a.obs_out = static_cast<float*>(obs_out);
  a.n_commands = n_commands;
  a.arena = arena;
  a.allowed = allowed;
  mortar_mayhem_reset_kernel<<<dim3(n_workers, kParts), kThreads, 0,
                               (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
