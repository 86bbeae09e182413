"""The port's host rollout (``training/host_rollout.py``) against the JAX
package's, against the port's device rollout, and pipelined against serial.

* Against JAX: the same parameters (through ``interop``), the same host envs
  (the JAX tests' mock env through each package's process pool, and the
  native PocMemory engine, bit-equal in the two packages) and JAX's actions
  injected through ``HostRolloutFn.sample_actions``. Obs, dones, episode
  steps, actions and episode infos are equal; values, log-probs, the memory
  tape and the carried memory, which come out of a transformer forward in
  each framework, agree to rtol 1e-4 / atol 1e-5, and advantages, a
  discounted sum of them, to 1e-4 (the tolerances of
  ``tests/test_host_env.py``).
* A deterministic, action-independent mock env, as a Python env and as its
  on-device twin, gives the same batches through the host and the device
  rollout, and through the serial and the pipelined host rollout, to the
  same tolerances, though the actions drawn differ.
"""
import dataclasses
from typing import NamedTuple

import numpy as np
import pytest
import torch

import jax

from etmppo_tpu.config import load_config as jax_load_config
from etmppo_tpu.envs.host import HostEnvBatch as JaxHostEnvBatch
from etmppo_tpu.envs.native import NativeEnvBatch as JaxNativeEnvBatch
from etmppo_tpu.models.actor_critic import ActorCriticModel as JModel
from etmppo_tpu.training.host_rollout import HostRolloutFn as JHostRolloutFn
from etmppo_tpu_torch.config import config_from_dict
from etmppo_tpu_torch.envs.core import TorchEnv
from etmppo_tpu_torch.envs.host import HostEnvBatch
from etmppo_tpu_torch.envs.native import NativeEnvBatch
from etmppo_tpu_torch.interop import load_flax_params
from etmppo_tpu_torch.models.actor_critic import ActorCriticModel
from etmppo_tpu_torch.ops import distributions
from etmppo_tpu_torch.training.host_rollout import (HostRolloutFn,
                                                    HostRolloutState)
from etmppo_tpu_torch.training.rollout import RolloutFn

torch.set_num_threads(1)

EP_LEN = 5
MAX_EP = 6
CLOSE = dict(rtol=1e-4, atol=1e-5)
ADV = dict(rtol=1e-4, atol=1e-4)


class _Space:
    def __init__(self, shape=None, n=None):
        self.shape = shape
        self.n = n


def _mock_obs(t):
    return np.asarray([np.sin(t), np.cos(t), t / 10.0], np.float32)


class MockPyEnv:
    """The JAX tests' mock env behind the reference's Python protocol."""

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


class MockState(NamedTuple):
    t: torch.Tensor     # (W,) int64 step of the episode


class MockTorchEnv(TorchEnv):
    """The same dynamics as a batched on-device env."""

    observation_shape = (3,)
    action_branches = (2,)
    max_episode_steps = MAX_EP
    info_keys = ("reward", "length")

    def __init__(self, n_workers):
        self.n_workers = n_workers
        self.device = torch.device("cpu")

    def sample_reset_draws(self, generator):
        return None

    def _obs(self, t):
        tf = t.double()
        return torch.stack([tf.sin(), tf.cos(), tf / 10.0], -1).float()

    def reset(self, draws):
        t = torch.zeros(self.n_workers, dtype=torch.int64)
        return MockState(t), self._obs(t)

    def step(self, state, actions, draws=None):
        t = state.t + 1
        reward = (0.1 * t.double()).float()
        return MockState(t), self._obs(t), reward, t >= EP_LEN, {
            "reward": (0.2 * t.double()).float(), "length": t.float()}


def _jax_cfg(**overrides):
    """The JAX tests' ``_cfg()``."""
    cfg = jax_load_config("etmppo_tpu/configs/poc_memory_env.yaml")
    fields = dict(
        n_workers=4, worker_steps=12, n_mini_batch=2, epochs=1,
        hidden_layer_size=16,
        transformer=dataclasses.replace(
            cfg.transformer, num_blocks=2, embed_dim=16, num_heads=2,
            memory_length=4))
    fields.update(overrides)
    return dataclasses.replace(cfg, **fields)


def _models(jcfg, obs_shape, branches, max_ep):
    """The JAX model and its parameters, and the port's model with them."""
    jmodel = JModel(config=jcfg, obs_shape=obs_shape,
                    action_branches=branches, max_episode_steps=max_ep)
    params = jmodel.init_params(jax.random.PRNGKey(0))
    model = ActorCriticModel(config_from_dict(dataclasses.asdict(jcfg)),
                             obs_shape, branches, max_ep, device="cpu")
    load_flax_params(model, params)
    return jmodel, params, model


class _Injected(HostRolloutFn):
    """The port's host rollout with given actions (W, T, branches)."""

    actions = None

    def sample_actions(self, logits, step, group):
        a = self.actions[self.group_rows(group), step]
        return a, torch.stack([distributions.log_prob(l, a[:, i])
                               for i, l in enumerate(logits)], dim=-1)


@pytest.fixture()
def closing():
    """Closes every env handed to it at the end of the test."""
    envs = []
    yield lambda env: envs.append(env) or env
    for env in envs:
        env.close()


def _assert_batches(ours, theirs, exact=("obs", "dones", "episode_steps")):
    """``theirs``: a port batch, or a JAX batch (numpy-convertible)."""
    get = lambda b, name: np.asarray(getattr(b, name))
    for name in exact:
        np.testing.assert_array_equal(get(ours, name), get(theirs, name),
                                      err_msg=name)
    for name in ("values", "tape"):
        np.testing.assert_allclose(get(ours, name), get(theirs, name),
                                   err_msg=name, **CLOSE)
    np.testing.assert_allclose(get(ours, "advantages"),
                               get(theirs, "advantages"), **ADV)


def _assert_states(ours, theirs):
    np.testing.assert_array_equal(np.asarray(ours.obs), np.asarray(theirs.obs))
    np.testing.assert_array_equal(np.asarray(ours.episode_step),
                                  np.asarray(theirs.episode_step))
    np.testing.assert_allclose(np.asarray(ours.memory),
                               np.asarray(theirs.memory), **CLOSE)


def _against_jax(jcfg, jenv, env, rollouts: int):
    """``rollouts`` rollouts of JAX's host rollout on ``jenv``, then of the
    port's on ``env`` with JAX's actions; both compared after each."""
    jmodel, params, model = _models(jcfg, env.observation_shape,
                                    env.action_branches,
                                    env.max_episode_steps)
    groups = jcfg.host_pipeline_groups
    jfn = JHostRolloutFn(jcfg, jenv, jmodel, pipeline=groups > 1)
    fn = _Injected(config_from_dict(dataclasses.asdict(jcfg)), env, model,
                   None, pipeline=groups > 1)
    assert fn.n_groups == jfn.n_groups
    jstate = jfn.init_state(jax.random.PRNGKey(1))
    state = fn.init_state()
    assert fn.n_groups == jfn.n_groups
    _assert_states(state, jstate)
    saw_done = False
    for _ in range(rollouts):
        jstate, jbatch = jfn(params, jstate)
        fn.actions = torch.tensor(np.asarray(jbatch.actions)).long()
        state, batch = fn(state)
        _assert_batches(batch, jbatch, exact=("obs", "dones",
                                              "episode_steps", "actions"))
        np.testing.assert_allclose(batch.log_probs, jbatch.log_probs, **CLOSE)
        np.testing.assert_allclose(batch.snapshot, jbatch.snapshot, **CLOSE)
        assert batch.episode_infos.keys() == jbatch.episode_infos.keys()
        for k, v in jbatch.episode_infos.items():
            np.testing.assert_array_equal(batch.episode_infos[k], v)
        _assert_states(state, jstate)
        saw_done |= bool(np.asarray(jbatch.dones).any())
    assert saw_done
    return state


@pytest.mark.parametrize("groups", [1, 2])
def test_matches_jax_on_the_mock_env(groups, closing):
    """Two rollouts of 12 steps with 5-step episodes: resets inside the
    rollout, at its end (folded into ``_finish``) and memory carried from
    one rollout into the next."""
    jcfg = _jax_cfg(host_pipeline_groups=groups)
    jenv = closing(JaxHostEnvBatch(make_env=MockPyEnv, n_procs=2))
    env = closing(HostEnvBatch(make_env=MockPyEnv, n_procs=2))
    state = _against_jax(jcfg, jenv, env, rollouts=2)
    assert isinstance(state, HostRolloutState)
    assert isinstance(state.obs, np.ndarray)


def test_matches_jax_on_native_poc_memory_at_full_width(closing):
    """PocMemory's YAML at full width (16 x 128, GTrXL 4 x 64, memory 32)
    on the native engine of each package (seed 0, as the factories give
    it): the engines give the same bits, so the whole batch compares."""
    jcfg = jax_load_config("etmppo_tpu/configs/poc_memory_env.yaml")
    assert (jcfg.n_workers, jcfg.worker_steps) == (16, 128)
    jenv = closing(JaxNativeEnvBatch("PocMemoryEnv-native"))
    env = closing(NativeEnvBatch("PocMemoryEnv-native"))
    _against_jax(jcfg, jenv, env, rollouts=1)


def _port_model(cfg):
    return ActorCriticModel(cfg, (3,), (2,), MAX_EP, device="cpu",
                            generator=torch.Generator().manual_seed(0))


def test_host_rollout_matches_the_device_rollout(closing):
    cfg = config_from_dict(dataclasses.asdict(_jax_cfg()))
    model = _port_model(cfg)
    dev_fn = RolloutFn(cfg, MockTorchEnv(cfg.n_workers), model,
                       torch.Generator().manual_seed(1))
    host_fn = HostRolloutFn(
        cfg, closing(HostEnvBatch(make_env=MockPyEnv, n_procs=2)), model,
        torch.Generator().manual_seed(2))
    dev_state, host_state = dev_fn.init_state(), host_fn.init_state()
    for _ in range(2):
        dev_state, dev_batch = dev_fn(dev_state)
        host_state, host_batch = host_fn(host_state)
        np.testing.assert_allclose(host_batch.obs, dev_batch.obs, atol=1e-6)
        _assert_batches(host_batch, dev_batch, exact=("dones",
                                                      "episode_steps"))
        done = dev_batch.dones
        for k in ("reward", "length"):
            np.testing.assert_allclose(host_batch.episode_infos[k][done],
                                       dev_batch.episode_infos[k][done],
                                       rtol=1e-6)
        np.testing.assert_array_equal(host_state.episode_step,
                                      dev_state.episode_step)
        np.testing.assert_allclose(host_state.memory, dev_state.memory,
                                   **CLOSE)
        np.testing.assert_allclose(host_state.obs, dev_state.obs, atol=1e-6)


@pytest.mark.parametrize("groups", [2, 4])
def test_pipelined_matches_serial(groups, closing):
    """G-group pipelining gives the serial path's batches on the
    action-independent mock env (the two draw different actions)."""
    cfg = config_from_dict(dataclasses.asdict(
        _jax_cfg(host_pipeline_groups=groups)))
    model = _port_model(cfg)
    runs = []
    for pipeline in (False, True):
        fn = HostRolloutFn(
            cfg, closing(HostEnvBatch(make_env=MockPyEnv, n_procs=2)), model,
            torch.Generator().manual_seed(1), pipeline=pipeline)
        state = fn.init_state()
        assert fn.n_groups == (groups if pipeline else 1)
        batches = []
        for _ in range(2):
            state, batch = fn(state)
            batches.append(batch)
        runs.append((state, batches))
    (s_state, s_batches), (p_state, p_batches) = runs
    for s, p in zip(s_batches, p_batches):
        _assert_batches(p, s)
        np.testing.assert_allclose(p.snapshot, s.snapshot, **CLOSE)
    _assert_states(p_state, s_state)


def test_group_count_steps_down_and_needs_step_group(closing):
    cfg = config_from_dict(dataclasses.asdict(
        _jax_cfg(n_workers=6, host_pipeline_groups=4)))
    model = ActorCriticModel(cfg, (3,), (2,), MAX_EP, device="cpu")
    pool = HostEnvBatch(make_env=MockPyEnv, n_procs=2)
    assert HostRolloutFn(cfg, pool, model, None).n_groups == 3
    assert HostRolloutFn(cfg, pool, model, None, pipeline=False).n_groups == 1
    fn = HostRolloutFn(cfg, closing(NativeEnvBatch("PocMemoryEnv-native")),
                       ActorCriticModel(cfg, (3,), (2,), 32, device="cpu"),
                       torch.Generator().manual_seed(0))
    assert fn.n_groups == 1           # the engine has no step_group
    fn.n_groups = 3                   # and start(W, n_groups=...) falls back
    state = fn.init_state()
    assert fn.n_groups == 1 and state.obs.shape == (6, 3)


class LongEnv(MockPyEnv):
    """Declares MAX_EP steps but runs 2 * MAX_EP + 1."""

    def step(self, action):
        self.t += 1
        done = self.t >= 2 * MAX_EP + 1
        info = {"reward": 1.0, "length": float(self.t)} if done else None
        return _mock_obs(float(self.t)), np.float32(1.0), done, info


def test_episodes_past_max_episode_steps_are_truncated(closing):
    """An episode that runs past ``max_episode_steps`` ends for the agent
    there (done, no info); the env's own end still counts as a done."""
    cfg = config_from_dict(dataclasses.asdict(_jax_cfg(worker_steps=20)))
    fn = HostRolloutFn(cfg, closing(HostEnvBatch(make_env=LongEnv,
                                                 n_procs=2)),
                       _port_model(cfg), torch.Generator().manual_seed(1),
                       pipeline=False)
    state, batch = fn(fn.init_state())
    steps = batch.episode_steps[0].tolist()
    # truncated at 6, 12, then the env's own end after 13 steps (1 more)
    assert steps == [0, 1, 2, 3, 4, 5] * 2 + [0] + list(range(6)) + [0]
    assert batch.dones[0].tolist() == [
        s == MAX_EP - 1 for s in steps[:12]] + [True] + [
        s == MAX_EP - 1 for s in steps[13:]]
    lengths = batch.episode_infos["length"][0]
    assert lengths[12] == 2 * MAX_EP + 1 and lengths[:12].eq(0).all()
    assert int(batch.episode_steps.max()) == MAX_EP - 1
    assert int(state.episode_step.max()) < MAX_EP
