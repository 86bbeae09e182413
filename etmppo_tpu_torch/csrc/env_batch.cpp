// Native batched environment engine (C++17, no external deps).
//
// The reference's host-side environment path is one Python process per env
// with pipe RPC (worker.py) — throughput-bound by interpreter overhead and
// the GIL.  This engine steps a whole batch of environments in native code
// with a std::thread pool behind a C ABI consumed via ctypes
// (etmppo_tpu/envs/native.py), mirroring the HostEnvBatch API
// (reset_all / step with auto-reset and per-episode info).
//
// Implemented environments (exact ports of the framework's JAX envs, which
// themselves match the reference wrappers — see envs/cartpole.py,
// envs/poc_memory.py):
//   0: CartPole (mask_velocity=false)   1: CartPoleMasked
//   2: PocMemoryEnv (step_size 0.2, freeze, max 32 steps)
//
// Build: g++ -O2 -shared -fPIC -std=c++17 -pthread env_batch.cpp -o libetmppo_envs.so

#include <algorithm>
#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <functional>
#include <mutex>
#include <random>
#include <thread>
#include <vector>

namespace {

constexpr int kInfoFields = 4;  // done_flag, reward, length, success

struct EpisodeInfo {
  float done = 0.0f;
  float reward = 0.0f;
  float length = 0.0f;
  float success = 0.0f;
};

class Env {
 public:
  virtual ~Env() = default;
  virtual int obs_dim() const = 0;
  virtual int n_actions() const = 0;
  virtual int max_episode_steps() const = 0;
  virtual void reset(std::mt19937& rng, float* obs) = 0;
  // Steps; on done auto-resets and writes the NEW episode's first obs.
  virtual void step(int action, std::mt19937& rng, float* obs, float* reward,
                    uint8_t* done, EpisodeInfo* info) = 0;
};

// --- CartPole (gym CartPole-v0 dynamics; cartpole_env.py semantics) --------
class CartPole : public Env {
 public:
  explicit CartPole(bool mask_velocity) : mask_(mask_velocity) {}
  int obs_dim() const override { return 4; }
  int n_actions() const override { return 2; }
  int max_episode_steps() const override { return 200; }

  void reset(std::mt19937& rng, float* obs) override {
    std::uniform_real_distribution<float> u(-0.05f, 0.05f);
    for (int i = 0; i < 4; ++i) s_[i] = u(rng);
    t_ = 0;
    raw_return_ = 0.0f;
    write_obs(obs);
  }

  void step(int action, std::mt19937& rng, float* obs, float* reward,
            uint8_t* done, EpisodeInfo* info) override {
    const float g = 9.8f, mc = 1.0f, mp = 0.1f, total = mc + mp, len = 0.5f,
                pml = mp * len, fmag = 10.0f, tau = 0.02f;
    float x = s_[0], xd = s_[1], th = s_[2], thd = s_[3];
    float force = action == 1 ? fmag : -fmag;
    float costh = std::cos(th), sinth = std::sin(th);
    float temp = (force + pml * thd * thd * sinth) / total;
    float thacc = (g * sinth - costh * temp) /
                  (len * (4.0f / 3.0f - mp * costh * costh / total));
    float xacc = temp - pml * thacc * costh / total;
    s_[0] = x + tau * xd;
    s_[1] = xd + tau * xacc;
    s_[2] = th + tau * thd;
    s_[3] = thd + tau * thacc;
    ++t_;
    raw_return_ += 1.0f;
    bool term = std::fabs(s_[0]) > 2.4f ||
                std::fabs(s_[2]) > 12.0f * 2.0f * float(M_PI) / 360.0f;
    bool d = term || t_ >= max_episode_steps();
    *reward = 1.0f / 100.0f;  // scaled training reward (cartpole_env.py:36)
    *done = d ? 1 : 0;
    if (d) {
      info->done = 1.0f;
      info->reward = raw_return_;  // raw episode return
      info->length = float(t_);
      info->success = 0.0f;
      reset(rng, obs);
    } else {
      write_obs(obs);
    }
  }

  void set_state(const float* state) { std::memcpy(s_, state, 4 * sizeof(float)); }

 private:
  void write_obs(float* obs) const {
    obs[0] = s_[0];
    obs[1] = mask_ ? 0.0f : s_[1];
    obs[2] = s_[2];
    obs[3] = mask_ ? 0.0f : s_[3];
  }
  bool mask_;
  float s_[4] = {0, 0, 0, 0};
  int t_ = 0;
  float raw_return_ = 0.0f;
};

// --- PocMemoryEnv (poc_memory_env.py semantics; factory settings) ----------
class PocMemory : public Env {
 public:
  int obs_dim() const override { return 3; }
  int n_actions() const override { return 2; }
  int max_episode_steps() const override { return 32; }

  void reset(std::mt19937& rng, float* obs) override {
    static const int starts[5] = {-2, -1, 0, 1, 2};
    ticks_ = starts[std::uniform_int_distribution<int>(0, 4)(rng)];
    bool flip = std::uniform_int_distribution<int>(0, 1)(rng) == 1;
    goals_[0] = flip ? 1.0f : -1.0f;
    goals_[1] = -goals_[0];
    t_ = 0;
    ret_ = 0.0f;
    write_obs(obs, /*show=*/true);
  }

  void step(int action, std::mt19937& rng, float* obs, float* reward,
            uint8_t* done, EpisodeInfo* info) override {
    const int kGoal = 5;           // 1.0 / step_size
    const float bonus = 1.0f + 6 * 0.1f;  // min_steps * time_penalty
    bool time_done = t_ >= max_episode_steps() - 1;
    bool show = t_ < 2;
    bool frozen = show;            // freeze=true during show phase
    int move = action == 1 ? 1 : -1;
    if (!frozen) ticks_ += move;

    float r;
    bool success = false, at_goal = false;
    if (frozen) {
      r = 0.0f;
    } else if (ticks_ == -kGoal || ticks_ == kGoal) {
      at_goal = true;
      float goal = ticks_ < 0 ? goals_[0] : goals_[1];
      r = goal == 1.0f ? bonus : -bonus;
      success = goal == 1.0f;
    } else {
      r = -0.1f;
    }
    ++t_;
    ret_ += r;
    bool d = time_done || (!frozen && at_goal);
    *reward = r;
    *done = d ? 1 : 0;
    if (d) {
      info->done = 1.0f;
      info->reward = ret_;
      info->length = float(t_);
      info->success = success ? 1.0f : 0.0f;
      reset(rng, obs);
    } else {
      write_obs(obs, show);
    }
  }

 private:
  void write_obs(float* obs, bool show) const {
    obs[0] = show ? goals_[0] : 0.0f;
    obs[1] = float(ticks_) * 0.2f;
    obs[2] = show ? goals_[1] : 0.0f;
  }
  int ticks_ = 0;
  float goals_[2] = {-1.0f, 1.0f};
  int t_ = 0;
  float ret_ = 0.0f;
};

// --- thread-pool batch ------------------------------------------------------
class EnvBatch {
 public:
  EnvBatch(int env_type, int n_envs, uint64_t seed, int n_threads)
      : n_envs_(n_envs) {
    for (int i = 0; i < n_envs; ++i) {
      envs_.emplace_back(make_env(env_type));
      rngs_.emplace_back(seed + uint64_t(i) * 0x9E3779B97F4A7C15ull);
    }
    n_threads_ = std::max(1, n_threads);
  }

  int obs_dim() const { return envs_[0]->obs_dim(); }
  int n_actions() const { return envs_[0]->n_actions(); }
  int max_episode_steps() const { return envs_[0]->max_episode_steps(); }

  void reset_all(float* obs) {
    parallel_for([&](int i) {
      envs_[i]->reset(rngs_[i], obs + size_t(i) * envs_[i]->obs_dim());
    });
  }

  void step(const int32_t* actions, float* obs, float* rewards, uint8_t* dones,
            float* infos) {
    parallel_for([&](int i) {
      EpisodeInfo info;
      envs_[i]->step(actions[i], rngs_[i],
                     obs + size_t(i) * envs_[i]->obs_dim(), rewards + i,
                     dones + i, &info);
      float* out = infos + size_t(i) * kInfoFields;
      out[0] = info.done;
      out[1] = info.reward;
      out[2] = info.length;
      out[3] = info.success;
    });
  }

 private:
  static Env* make_env(int env_type) {
    switch (env_type) {
      case 0: return new CartPole(false);
      case 1: return new CartPole(true);
      case 2: return new PocMemory();
      default: return nullptr;
    }
  }

  void parallel_for(const std::function<void(int)>& fn) {
    if (n_threads_ <= 1 || n_envs_ < 2 * n_threads_) {
      for (int i = 0; i < n_envs_; ++i) fn(i);
      return;
    }
    std::atomic<int> next{0};
    std::vector<std::thread> threads;
    for (int t = 0; t < n_threads_; ++t) {
      threads.emplace_back([&]() {
        int i;
        while ((i = next.fetch_add(1)) < n_envs_) fn(i);
      });
    }
    for (auto& th : threads) th.join();
  }

  int n_envs_;
  int n_threads_;
  std::vector<std::unique_ptr<Env>> envs_;
  std::vector<std::mt19937> rngs_;
};

}  // namespace

extern "C" {

void* etmppo_create(int env_type, int n_envs, uint64_t seed, int n_threads) {
  return new EnvBatch(env_type, n_envs, seed, n_threads);
}

void etmppo_destroy(void* handle) { delete static_cast<EnvBatch*>(handle); }

void etmppo_spec(void* handle, int* obs_dim, int* n_actions, int* max_steps) {
  auto* b = static_cast<EnvBatch*>(handle);
  *obs_dim = b->obs_dim();
  *n_actions = b->n_actions();
  *max_steps = b->max_episode_steps();
}

void etmppo_reset_all(void* handle, float* obs) {
  static_cast<EnvBatch*>(handle)->reset_all(obs);
}

void etmppo_step(void* handle, const int32_t* actions, float* obs,
                 float* rewards, uint8_t* dones, float* infos) {
  static_cast<EnvBatch*>(handle)->step(actions, obs, rewards, dones, infos);
}

int etmppo_info_fields() { return kInfoFields; }

}  // extern "C"
