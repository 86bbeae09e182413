"""The port's host-environment bridge (``envs/host.py``) against the JAX
package's, on the JAX tests' mock envs: the same envs and actions through
both pools give equal outputs, and each pool meets the JAX tests' checks.

Every pool is closed by the ``pools`` fixture, and every wait on a worker's
pipe is bounded (``_bounded``), so a hung worker fails a test instead of
hanging the run.
"""
import sys

import numpy as np
import pytest

from etmppo_tpu.config import EnvConfig as JaxEnvConfig
from etmppo_tpu.envs import host as jax_host
from etmppo_tpu.envs.factory import create_env as jax_create_env
from etmppo_tpu_torch.config import EnvConfig
from etmppo_tpu_torch.envs import host
from etmppo_tpu_torch.envs.factory import HOST_ENV_TYPES, create_env

EP_LEN = 5
MAX_EP = 6
ANSWER_S = 30.0


class _Hung(Exception):
    """A worker did not answer in time (not an OSError, which the bridge
    takes for a crash)."""


class _Space:
    def __init__(self, shape=None, n=None):
        self.shape = shape
        self.n = n


def _mock_obs(t):
    return np.asarray([np.sin(t), np.cos(t), t / 10.0], np.float32)


class MockPyEnv:
    """The JAX tests' deterministic, action-independent mock env."""

    observation_space = _Space(shape=(3,))
    action_space = _Space(n=2)
    max_episode_steps = MAX_EP

    def reset(self):
        self.t = 0
        return _mock_obs(0.0)

    def step(self, action):
        self.t += 1
        obs = _mock_obs(float(self.t))
        reward = 0.1 * self.t
        done = self.t >= EP_LEN
        info = {"reward": reward * 2, "length": float(self.t)} if done else None
        return obs, np.float32(reward), done, info

    def close(self):
        pass


class EchoImageEnv:
    """CHW image obs that carry the step and the last action, episodes of
    3 + (the first action) steps, and an extra info key."""

    observation_space = _Space(shape=(3, 4, 5))
    action_space = _Space(n=3)
    max_episode_steps = 8

    def _obs(self, action):
        obs = np.zeros((3, 4, 5), np.float32)
        obs[0] = self.t
        obs[1] = action
        obs[2, :, 0] = np.arange(4)
        return obs

    def reset(self):
        self.t, self.first = 0, None
        return self._obs(-1)

    def step(self, action):
        self.t += 1
        a = int(action[0])
        self.first = a if self.first is None else self.first
        done = self.t >= 3 + self.first
        info = ({"reward": float(self.t), "length": float(self.t),
                 "extra": 1.0} if done else None)
        return self._obs(a), np.float32(a), done, info

    def close(self):
        pass


class BadEnv(MockPyEnv):
    def step(self, action):
        raise RuntimeError("boom in env")


class FlakyEnv(MockPyEnv):
    crashed = False

    def step(self, action):
        if self.t == 2 and not FlakyEnv.crashed:
            FlakyEnv.crashed = True
            raise RuntimeError("transient env crash")
        return super().step(action)


def _bounded(batch):
    """Bounds every wait of ``batch`` on a worker's answer."""
    recv = batch._recv

    def bounded_recv(pipe):
        if not pipe.poll(ANSWER_S):
            raise _Hung("a host env worker did not answer")
        return recv(pipe)
    batch._recv = bounded_recv
    return batch


@pytest.fixture()
def pools():
    """Makes pools of both packages; closes all of them at the end."""
    made = []

    def make(module, make_env, n_procs):
        batch = _bounded(module.HostEnvBatch(make_env=make_env,
                                             n_procs=n_procs))
        made.append(batch)
        return batch
    yield make
    procs = [p for batch in made for p in batch._procs]
    for batch in made:
        batch.close()
    assert procs and not any(p.is_alive() for p in procs)


def _assert_steps_equal(a, b):
    obs_a, r_a, d_a, i_a = a
    obs_b, r_b, d_b, i_b = b
    np.testing.assert_array_equal(obs_a, obs_b)
    np.testing.assert_array_equal(r_a, r_b)
    np.testing.assert_array_equal(d_a, d_b)
    assert obs_a.dtype == obs_b.dtype and r_a.dtype == r_b.dtype
    assert i_a == i_b


def test_batch_api_and_auto_reset(pools):
    """As the JAX test: the spec, rewards, dones at the episode's end, the
    episode info there and the next episode's first obs after it; the two
    pools step alike."""
    ours = pools(host, MockPyEnv, 2)
    theirs = pools(jax_host, MockPyEnv, 2)
    for batch in (ours, theirs):
        assert batch.observation_shape == (3,)
        assert batch.action_branches == (2,)
        assert batch.max_episode_steps == MAX_EP
        assert batch.info_keys == ("reward", "length")
        batch.start(4)
    obs = ours.reset_all()
    np.testing.assert_array_equal(obs, theirs.reset_all())
    assert obs.shape == (4, 3)
    actions = np.zeros((4, 1), np.int64)
    for t in range(1, 2 * EP_LEN + 1):
        step = ours.step(actions)
        _assert_steps_equal(step, theirs.step(actions))
        obs, rewards, dones, infos = step
        k = (t - 1) % EP_LEN + 1
        np.testing.assert_allclose(rewards, 0.1 * k, rtol=1e-6)
        if k == EP_LEN:
            assert dones.all()
            assert all(i is not None and i["length"] == EP_LEN
                       for i in infos)
            np.testing.assert_allclose(obs, np.tile(_mock_obs(0), (4, 1)),
                                       rtol=1e-6)
        else:
            assert not dones.any() and all(i is None for i in infos)


def test_image_obs_to_hwc_and_actions_routed(pools):
    """CHW obs come out HWC, each env gets its own row's action, and an
    env's own info keys reach the caller."""
    ours = pools(host, EchoImageEnv, 3)
    theirs = pools(jax_host, EchoImageEnv, 3)
    for batch in (ours, theirs):
        assert batch.observation_shape == (4, 5, 3)
        assert batch.action_branches == (3,)
        batch.start(6)
    np.testing.assert_array_equal(ours.reset_all(), theirs.reset_all())
    rng = np.random.default_rng(0)
    for _ in range(12):
        actions = rng.integers(0, 3, (6, 1))
        step = ours.step(actions)
        _assert_steps_equal(step, theirs.step(actions))
        obs, rewards, dones, infos = step
        assert obs.shape == (6, 4, 5, 3)
        np.testing.assert_array_equal(rewards, actions[:, 0])
        live = ~dones
        np.testing.assert_array_equal(obs[live, 0, 0, 1], actions[live, 0])
        for d, info in zip(dones, infos):
            assert (info is not None) == d
            if d:
                assert info["extra"] == 1.0


@pytest.mark.parametrize("make_env", [MockPyEnv, EchoImageEnv])
def test_step_group_matches_step(pools, make_env):
    """Two groups stepped one after the other give what one step of all
    envs gives, in both packages."""
    serial = pools(host, make_env, 2)
    grouped = pools(host, make_env, 4)
    jax_grouped = pools(jax_host, make_env, 4)
    serial.start(8)
    grouped.start(8, n_groups=2)
    jax_grouped.start(8, n_groups=2)
    assert len(grouped._group_pipes) == 2
    assert not set(grouped._group_pipes[0]) & set(grouped._group_pipes[1])
    obs = serial.reset_all()
    np.testing.assert_array_equal(obs, grouped.reset_all())
    np.testing.assert_array_equal(obs, jax_grouped.reset_all())
    rng = np.random.default_rng(1)
    for _ in range(10):
        actions = rng.integers(0, 2, (8, 1))
        whole = serial.step(actions)
        for batch in (grouped, jax_grouped):
            parts = [batch.step_group(g, actions[4 * g:4 * g + 4])
                     for g in range(2)]
            _assert_steps_equal(whole, (
                np.concatenate([p[0] for p in parts]),
                np.concatenate([p[1] for p in parts]),
                np.concatenate([p[2] for p in parts]),
                parts[0][3] + parts[1][3]))
    with pytest.raises(ValueError, match="equal groups"):
        pools(host, make_env, 2).start(5, n_groups=2)


def test_worker_exception_propagates(pools):
    for module in (host, jax_host):
        batch = pools(module, BadEnv, 1)
        batch.start(2)
        batch.reset_all()
        with pytest.raises(RuntimeError, match="boom in env"):
            batch.step(np.zeros((2, 1), np.int64), restart_on_failure=False)


def test_worker_crash_recovery(pools):
    """As the JAX test: a crashing worker is respawned and its envs report a
    truncated episode (done, no info, the first obs), then step on; the two
    pools report alike."""
    runs = []
    for module in (host, jax_host):
        batch = pools(module, FlakyEnv, 1)
        batch.start(2)
        batch.reset_all()
        actions = np.zeros((2, 1), np.int64)
        steps, crashed_step = [], None
        for t in range(1, 8):
            step = batch.step(actions)
            steps.append(step)
            obs, rewards, dones, infos = step
            if dones.all() and t < EP_LEN and crashed_step is None:
                crashed_step = t
                assert infos == [None, None]
                np.testing.assert_array_equal(rewards, 0.0)
                np.testing.assert_allclose(
                    obs, np.tile(_mock_obs(0), (2, 1)), rtol=1e-6)
        assert crashed_step is not None
        steps.append(batch.step(actions))
        assert np.isfinite(steps[-1][1]).all()
        runs.append(steps)
    for a, b in zip(*runs):
        _assert_steps_equal(a, b)


@pytest.mark.parametrize("obs", [
    np.zeros((3, 84, 84)), np.zeros((84, 84, 3)), np.zeros((1, 5, 7)),
    np.zeros((4, 6, 6)), np.zeros((3, 2, 2)), np.zeros((5,)),
    np.arange(60).reshape(3, 4, 5)], ids=str)
def test_to_hwc(obs):
    ours, theirs = host._to_hwc(obs), jax_host._to_hwc(obs)
    assert ours.dtype == theirs.dtype == np.float32
    np.testing.assert_array_equal(ours, theirs)


@pytest.mark.parametrize("env_type", HOST_ENV_TYPES)
def test_factory_needs_the_env_packages(env_type, monkeypatch):
    """Every host type reaches the pool, whose probe needs the env's
    package; neither package is installed here. Both packages raise an
    ImportError naming it. (A wrapper module imported against a stub
    package by another test is dropped first.)"""
    for package in ("etmppo_tpu_torch", "etmppo_tpu"):
        for wrapper in ("memory_gym_wrapper", "minigrid_host_wrapper"):
            monkeypatch.delitem(sys.modules, f"{package}.envs.{wrapper}",
                                raising=False)
    package = "gym-minigrid" if env_type.startswith("Minigrid") \
        else "memory-gym"
    with pytest.raises(ImportError, match=package) as ours:
        create_env(EnvConfig(type=env_type), 4, "cpu")
    with pytest.raises(ImportError, match=package) as theirs:
        jax_create_env(JaxEnvConfig(type=env_type))
    assert str(ours.value).split(" (")[0] == str(theirs.value).split(" (")[0]
    with pytest.raises(ValueError, match="Unknown host environment type"):
        host._python_env_factory(EnvConfig(type="Pong"))()
