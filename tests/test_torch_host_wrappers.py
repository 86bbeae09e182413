"""The port's host-bridge env wrappers against the JAX package's, case for
case with ``tests/test_host_wrappers.py``.

memory-gym and gym-minigrid are not installed, so, as there, the wrappers
run against in-process stubs of the packages' API surface. Each case drives
the port's wrapper and the JAX package's through the same calls, with the
global generators they draw reset seeds from seeded alike, and asserts
equal results and the reference's behaviour (environments/memory_gym_env.py,
minigrid_env.py): observation scaling to [0, 1], layout transposition,
per-reset seed sampling, reset-option forwarding, reward/length episode
info, and the Memory-task view/tile/step-cap selection.
"""
import importlib
import random
import sys
import types

import numpy as np
import pytest

gymnasium = pytest.importorskip("gymnasium")

MODULES = ("etmppo_tpu_torch.envs", "etmppo_tpu.envs")
STUB_ID = "StubMemGymTorchPort-v0"


class _RecordingMGEnv(gymnasium.Env):
    """Mimics a memory-gym env: uint8 (H, W, C) obs, MultiDiscrete actions,
    max_episode_steps attribute, (obs, info) resets with seed/options."""

    observation_space = gymnasium.spaces.Box(
        0, 255, shape=(6, 4, 3), dtype=np.uint8)
    action_space = gymnasium.spaces.MultiDiscrete([2, 3])
    max_episode_steps = 7

    def __init__(self):
        self.seeds = []
        self.options = []
        self.actions = []

    def _obs(self):
        h, w, c = self.observation_space.shape
        return np.arange(h * w * c, dtype=np.uint8).reshape(h, w, c)

    def reset(self, seed=None, options=None):
        self.seeds.append(seed)
        self.options.append(options)
        self.t = 0
        return self._obs(), {}

    def step(self, action):
        self.actions.append(action)
        self.t += 1
        done = self.t >= 3
        info = {"extra": 1.0} if done else {}
        return self._obs(), float(self.t), done, False, info


@pytest.fixture()
def mg_wrappers(monkeypatch):
    """(port's, JAX package's) MemoryGymWrapper over a stub memory_gym."""
    monkeypatch.setitem(sys.modules, "memory_gym",
                        types.ModuleType("memory_gym"))
    if STUB_ID not in gymnasium.registry:
        gymnasium.register(id=STUB_ID,
                           entry_point=lambda **kw: _RecordingMGEnv())
    names = [m + ".memory_gym_wrapper" for m in MODULES]
    for name in names:
        monkeypatch.delitem(sys.modules, name, raising=False)
    yield tuple(importlib.import_module(n).MemoryGymWrapper for n in names)
    # Drop the stub-bound modules: a later import must find no memory_gym.
    for name in names:
        sys.modules.pop(name, None)


def _both(classes, *args):
    """One wrapper of each package, their reset seeds drawn alike."""
    made = []
    for cls in classes:
        random.seed(0)
        np.random.seed(0)
        made.append(cls(*args))
    return made


def test_memory_gym_obs_layout_and_scaling(mg_wrappers):
    for w in _both(mg_wrappers, STUB_ID, {"start-seed": 5, "num-seeds": 1}):
        assert w.observation_space.shape == (3, 4, 6)
        obs = w.reset()
        raw = _RecordingMGEnv().reset()[0]
        assert obs.shape == (3, 6, 4)
        np.testing.assert_allclose(
            obs, np.transpose(raw, (2, 0, 1)) / 255.0, rtol=0, atol=0)
        assert obs.min() >= 0.0 and obs.max() <= 1.0


def test_memory_gym_seed_sampling_and_options(mg_wrappers):
    params = {"start-seed": 100, "num-seeds": 10, "agent_scale": 0.25}
    seen = []
    for w in _both(mg_wrappers, STUB_ID, params):
        random.seed(1)
        for _ in range(50):
            w.reset()
        env = w._env.unwrapped
        seeds = [s for s in env.seeds if s is not None]
        assert all(100 <= s <= 109 for s in seeds)
        assert len(set(seeds)) > 1
        opts = [o for o in env.options if o is not None]
        assert opts and all(o == {"agent_scale": 0.25} for o in opts)
        seen.append((env.seeds, env.options))
    assert seen[0] == seen[1]


def test_memory_gym_step_and_episode_info(mg_wrappers):
    results = []
    for w in _both(mg_wrappers, STUB_ID, {"start-seed": 0, "num-seeds": 1}):
        w.reset()
        obs, r1, done, info = w.step(np.asarray([1]))
        assert (r1, done, info) == (1.0, False, None)
        assert w._env.unwrapped.actions[-1] == 1
        obs, r2, done, info = w.step([0, 2])
        assert list(w._env.unwrapped.actions[-1]) == [0, 2]
        obs, r3, done, info = w.step([1, 1])
        assert done
        assert info["reward"] == r1 + r2 + r3
        assert info["length"] == 3
        assert info["extra"] == 1.0
        results.append((obs, info))
    np.testing.assert_array_equal(results[0][0], results[1][0])
    assert results[0][1] == results[1][1]


def test_memory_gym_max_episode_steps_through_wrapper_chain(mg_wrappers):
    for w in _both(mg_wrappers, STUB_ID, {"start-seed": 0, "num-seeds": 1}):
        assert w.max_episode_steps == 7


def test_memory_gym_multidiscrete_action_space(mg_wrappers):
    for w in _both(mg_wrappers, STUB_ID, {"start-seed": 0, "num-seeds": 1}):
        assert w.action_space.n == 6


class _StubGridEnv:
    """Base env: records seeds; obs produced by the (stub) wrapper chain."""

    class _Space:
        def __init__(self, n=None, shape=None):
            self.n = n
            self.shape = shape

    def __init__(self):
        self.action_space = self._Space(n=7)
        self.seeds = []
        self.view_size = None
        self.tile_size = None

    def seed(self, s):
        self.seeds.append(int(s))

    def _obs(self):
        hw = self.view_size * self.tile_size
        rng = np.random.default_rng(self.seeds[-1] if self.seeds else 0)
        return rng.integers(0, 256, size=(hw, hw, 3)).astype(np.uint8)

    def reset(self):
        self.t = 0
        return self._obs()

    def step(self, action):
        self.t += 1
        return self._obs(), 0.5, False, {}

    def close(self):
        pass


@pytest.fixture()
def minigrid_wrappers(monkeypatch):
    """(port's, JAX package's) MinigridHostWrapper over stub gym and
    gym_minigrid modules."""
    gym_mod = types.ModuleType("gym")

    class Discrete:
        def __init__(self, n):
            self.n = n

    class Box:
        def __init__(self, low, high, shape, dtype):
            self.shape = shape
            self.dtype = dtype

    spaces_mod = types.ModuleType("gym.spaces")
    spaces_mod.Discrete = Discrete
    spaces_mod.Box = Box
    gym_mod.spaces = spaces_mod
    gym_mod.make = lambda name: _StubGridEnv()

    def view_size_wrapper(env, view_size):
        env.view_size = view_size
        return env

    def rgb_wrapper(env, tile_size):
        env.tile_size = tile_size
        return env

    wrappers_mod = types.ModuleType("gym_minigrid.wrappers")
    wrappers_mod.ViewSizeWrapper = view_size_wrapper
    wrappers_mod.RGBImgPartialObsWrapper = rgb_wrapper
    wrappers_mod.ImgObsWrapper = lambda env: env
    gm_mod = types.ModuleType("gym_minigrid")
    gm_mod.wrappers = wrappers_mod

    monkeypatch.setitem(sys.modules, "gym", gym_mod)
    monkeypatch.setitem(sys.modules, "gym.spaces", spaces_mod)
    monkeypatch.setitem(sys.modules, "gym_minigrid", gm_mod)
    monkeypatch.setitem(sys.modules, "gym_minigrid.wrappers", wrappers_mod)
    names = [m + ".minigrid_host_wrapper" for m in MODULES]
    for name in names:
        sys.modules.pop(name, None)
    yield tuple(importlib.import_module(n).MinigridHostWrapper
                for n in names)
    # Drop the stub-bound modules so no later import sees stale bindings.
    for name in names:
        sys.modules.pop(name, None)


def test_minigrid_memory_task_configuration(minigrid_wrappers):
    for w in _both(minigrid_wrappers, "MiniGrid-MemoryS9-v0"):
        assert (w._env.view_size, w.tile_size) == (3, 28)
        assert w.max_episode_steps == 96
        assert w.action_space.n == 3
        assert w.observation_space.shape == (3, 84, 84)


def test_minigrid_other_task_configuration(minigrid_wrappers):
    for w in _both(minigrid_wrappers, "MiniGrid-Empty-5x5-v0"):
        assert (w._env.view_size, w.tile_size) == (7, 8)
        assert w.max_episode_steps == 64
        assert w.action_space.n == 7
        assert w.observation_space.shape == (3, 56, 56)


def test_minigrid_obs_scaling_layout_and_seeding(minigrid_wrappers):
    seen = []
    for w in _both(minigrid_wrappers, "MiniGrid-MemoryS9-v0"):
        np.random.seed(2)
        for _ in range(20):
            obs = w.reset()
        seeds = w._env.seeds
        assert len(seeds) == 20 and all(0 <= s <= 999 for s in seeds)
        assert len(set(seeds)) > 1
        raw = w._env._obs()
        np.testing.assert_allclose(obs, np.transpose(raw, (2, 0, 1)) / 255.0)
        assert obs.dtype == np.float32
        seen.append((seeds, obs))
    assert seen[0][0] == seen[1][0]
    np.testing.assert_array_equal(seen[0][1], seen[1][1])


def test_minigrid_step_cap_and_episode_info(minigrid_wrappers):
    for w in _both(minigrid_wrappers, "MiniGrid-MemoryS9-v0"):
        w.reset()
        for t in range(96):
            obs, reward, done, info = w.step(np.asarray([2]))
            assert done == (t == 95)
            assert (info is None) == (t != 95)
        assert info["length"] == 96
        assert info["reward"] == pytest.approx(0.5 * 96)
