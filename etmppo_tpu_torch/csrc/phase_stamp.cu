// The device stamps of the phase clock (utils/profiling.py, PhaseClock).
//
// Replaces no TPU kernel: the JAX package times nothing inside its fused
// chunk. The clock has to, because inside a replayed CUDA graph the host runs
// no code at a phase boundary, so only a kernel in the graph can say when the
// card reached it. A stamp is one thread that reads the card's global timer
// (%globaltimer, ns) and updates the clock's buffer of int64, P phases wide:
//
//   buf[i]         phase i's nanoseconds so far in this update (its sum)
//   buf[P + i]     when phase i last opened
//   buf[2 * P + i] when phase i last closed
//
// phase_stamp_kernel<C, O> closes phase C (adds the time since it opened to
// its sum) and opens phase O, -1 being none; opening phase 0 (the update)
// zeroes every sum first. Bound by the launch: a stamp reads and writes three
// 8-byte words, and a replayed graph starts it right after the node before
// it. Each (C, O) is its own template instance, so every boundary has a name
// of its own in a device trace, and a repeated boundary (a rollout step, a
// minibatch) adds into its sum on the device, with no copy to the host.
#include <cuda_runtime.h>

#include <array>
#include <utility>

constexpr int kPhases = 11;  // len(utils.profiling.PHASES)

template <int C, int O>
__global__ void phase_stamp_kernel(long long* buf) {
  long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  if constexpr (C >= 0) {
    buf[C] += now - buf[kPhases + C];
    buf[2 * kPhases + C] = now;
  }
  if constexpr (O == 0) {
    for (int i = 0; i < kPhases; ++i) buf[i] = 0;
  }
  if constexpr (O >= 0) buf[kPhases + O] = now;
}

using StampFn = void (*)(long long*);

// Row c of the table: the instances that close phase c - 1, for every open.
template <int C, int... O>
std::array<StampFn, sizeof...(O)> stamp_row(std::integer_sequence<int, O...>) {
  return {{&phase_stamp_kernel<C - 1, O - 1>...}};
}

template <int... C>
std::array<std::array<StampFn, kPhases + 1>, sizeof...(C)> stamp_table(
    std::integer_sequence<int, C...>) {
  return {{stamp_row<C>(std::make_integer_sequence<int, kPhases + 1>{})...}};
}

// Launches the stamp that closes phase `close` and opens phase `open` on
// `stream`. `phases` is the caller's count of phases, which must be this
// file's. Returns the CUDA error of the launch (0: launched).
extern "C" int phase_stamp(void* buf, int close, int open, int phases,
                           void* stream) {
  static const auto table =
      stamp_table(std::make_integer_sequence<int, kPhases + 1>{});
  if (buf == nullptr || phases != kPhases || close < -1 || close >= kPhases ||
      open < -1 || open >= kPhases)
    return (int)cudaErrorInvalidValue;
  long long* words = static_cast<long long*>(buf);
  void* args[] = {&words};
  return (int)cudaLaunchKernel((const void*)table[close + 1][open + 1],
                               dim3(1), dim3(1), args, 0,
                               (cudaStream_t)stream);
}
