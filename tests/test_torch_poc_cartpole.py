"""etmppo_tpu_torch's PocMemory and CartPole vs the JAX package's envs, a
PocMemory rollout against JAX's, and the port's PocMemory learning check.

* The envs: the port's resets are handed the values the JAX resets drew
  (PocMemory: the start tick and the goal order; CartPole: the initial
  physics), so both start from the same states. PocMemory is integer ticks
  and float32 constants: observations, rewards, dones, infos and states are
  equal step by step. CartPole integrates cos/sin in float32, where XLA may
  fuse or reorder: each step is taken from the same state on both sides and
  agrees to rtol 1e-6 (atol 1e-7), ``done`` exactly except where x or theta
  lies within 1e-6 of its threshold.
* The rollout: the port's PocMemory rollout, handed JAX's actions and reset
  draws (its steps draw nothing), collects JAX's trajectories: values,
  log-probs, memory items and advantages to 1e-4, as in
  tests/test_torch_training.py.
* Learning: 30 updates of ``POC_MEMORY`` on the CPU (seed 0) reach a
  success rate of at least 0.9 and a mean return over 0.5, the bar of
  tests/test_e2e_learning.py.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from etmppo_tpu.config import load_config as jax_load_config
from etmppo_tpu.envs.cartpole import CartPole as JCartPole
from etmppo_tpu.envs.cartpole import THETA_THRESHOLD, X_THRESHOLD
from etmppo_tpu.envs.factory import create_env as jax_create_env
from etmppo_tpu.envs.poc_memory import PocMemoryEnv as JPoc
from etmppo_tpu.models.actor_critic import ActorCriticModel as JModel
from etmppo_tpu.training.rollout import RolloutFn as JRolloutFn
from etmppo_tpu_torch.config import (CARTPOLE_MASKED, POC_MEMORY, EnvConfig,
                                     config_from_dict)
from etmppo_tpu_torch.envs.cartpole import CartPole, CartPoleState
from etmppo_tpu_torch.envs.factory import create_env
from etmppo_tpu_torch.envs.poc_memory import (PocMemoryEnv,
                                              PocMemoryResetDraws,
                                              PocMemoryState)
from etmppo_tpu_torch.interop import load_flax_params
from etmppo_tpu_torch.models.actor_critic import ActorCriticModel
from etmppo_tpu_torch.ops import distributions
from etmppo_tpu_torch.training.rollout import RolloutFn
from etmppo_tpu_torch.training.trainer import PPOTrainer

torch.set_num_threads(1)

W = 32


def _np(x):
    return np.array(x)


def _keys(seed, n):
    return jax.random.split(jax.random.PRNGKey(seed), n)


# --- PocMemory ---------------------------------------------------------


def _poc_draws(env: PocMemoryEnv, states) -> PocMemoryResetDraws:
    """The values a JAX PocMemory reset drew, read back from its states."""
    start = np.searchsorted(env.start_ticks.numpy(), _np(states.ticks))
    return PocMemoryResetDraws(torch.as_tensor(start).long(),
                               torch.as_tensor(_np(states.goals)[:, 0] == 1.0))


def _assert_poc_state(got: PocMemoryState, want):
    for name in got._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      _np(getattr(want, name)), err_msg=name)


def test_poc_memory_factory_and_start_ticks():
    env = create_env(EnvConfig(type="PocMemoryEnv"), 4, "cpu")
    jenv = jax_create_env(EnvConfig(type="PocMemoryEnv"))
    assert isinstance(env, PocMemoryEnv) and env.n_workers == 4
    assert env.max_episode_steps == jenv.max_episode_steps == 32
    assert env.freeze and env.observation_shape == (3,)
    assert env.action_branches == (2,)
    np.testing.assert_array_equal(env.start_ticks.numpy(), jenv.start_ticks)
    draws = env.sample_reset_draws(torch.Generator().manual_seed(0))
    assert draws.start.max() < len(env.start_ticks)


def test_poc_memory_steps_match():
    """Random actions for 80 steps with JAX's auto-reset where done: every
    episode ends at a goal or at the 32-step limit."""
    jenv = JPoc(glob=False, freeze=True, max_episode_steps=32)
    env = PocMemoryEnv(glob=False, freeze=True, max_episode_steps=32,
                       n_workers=W, device="cpu")
    jstate, jobs = jax.vmap(jenv.reset)(_keys(0, W))
    state, obs = env.reset(_poc_draws(env, jstate))
    np.testing.assert_array_equal(obs.numpy(), _np(jobs))
    _assert_poc_state(state, jstate)
    step = jax.jit(jax.vmap(jenv.step))
    reset = jax.jit(jax.vmap(jenv.reset))
    rng = np.random.default_rng(0)
    saw = dict(success=False, failure=False, timeout=False)
    for t in range(80):
        actions = rng.integers(0, 2, (W, 1))
        jstate, jobs, jrew, jdone, jinfo = step(jstate, jnp.asarray(actions),
                                                _keys(t, W))
        state, obs, rew, done, info = env.step(state, torch.as_tensor(actions))
        np.testing.assert_array_equal(obs.numpy(), _np(jobs))
        np.testing.assert_array_equal(rew.numpy(), _np(jrew))
        np.testing.assert_array_equal(done.numpy(), _np(jdone))
        for k in env.info_keys:
            np.testing.assert_array_equal(info[k].numpy(), _np(jinfo[k]))
        _assert_poc_state(state, jstate)
        d = _np(jdone)
        saw["success"] |= bool((d & (_np(jinfo["success"]) == 1)).any())
        saw["failure"] |= bool((d & (_np(jrew) < -1)).any())
        saw["timeout"] |= bool((d & (_np(jinfo["length"]) == 32)).any())
        # auto-reset the finished workers on both sides, from JAX's draws
        rstate, _ = reset(_keys(1000 + t, W))
        tstate, _ = env.reset(_poc_draws(env, rstate))
        jstate = jax.tree.map(
            lambda new, old: jnp.where(
                jnp.asarray(d).reshape((W,) + (1,) * (old.ndim - 1)), new,
                old), rstate, jstate)
        state = type(state)(*(torch.where(
            done.reshape((W,) + (1,) * (a.dim() - 1)), a, b)
            for a, b in zip(tstate, state)))
    assert all(saw.values()), saw


# --- CartPole ----------------------------------------------------------


def _cartpole_state(states) -> CartPoleState:
    t = lambda x: torch.as_tensor(_np(x))
    return CartPoleState(t(states.physics), t(states.step_count).long(),
                         t(states.reward_sum), t(states.length).long())


@pytest.mark.parametrize("masked", [False, True])
def test_cartpole_factory(masked):
    name = "CartPoleMasked" if masked else "CartPole"
    env = create_env(EnvConfig(type=name), 3, "cpu")
    assert isinstance(env, CartPole) and env.mask_velocity == masked
    assert env.max_episode_steps == 200 and env.info_keys == ("reward",
                                                              "length")
    draws = env.sample_reset_draws(torch.Generator().manual_seed(0))
    assert draws.shape == (3, 4) and draws.abs().max() <= 0.05


@pytest.mark.parametrize("masked", [False, True])
def test_cartpole_steps_match(masked):
    """Random actions until every worker has ended an episode; each step is
    taken from JAX's state on both sides. 64 workers, up to 200 steps."""
    n = 64
    jenv = JCartPole(mask_velocity=masked)
    env = CartPole(masked, n_workers=n, device="cpu")
    jstate, jobs = jax.vmap(jenv.reset)(_keys(1, n))
    state, obs = env.reset(torch.as_tensor(_np(jstate.physics)))
    np.testing.assert_array_equal(obs.numpy(), _np(jobs))
    step = jax.jit(jax.vmap(jenv.step))
    rng = np.random.default_rng(1)
    ended = np.zeros(n, bool)
    near_edge = 0
    for t in range(200):
        actions = rng.integers(0, 2, (n, 1))
        jnext, jobs, jrew, jdone, jinfo = step(jstate, jnp.asarray(actions),
                                               _keys(t, n))
        state, obs, rew, done, info = env.step(_cartpole_state(jstate),
                                               torch.as_tensor(actions))
        np.testing.assert_allclose(state.physics.numpy(), _np(jnext.physics),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(obs.numpy(), _np(jobs), rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_array_equal(rew.numpy(), _np(jrew))
        for k in env.info_keys:
            np.testing.assert_array_equal(info[k].numpy(), _np(jinfo[k]))
        x, theta = _np(jnext.physics)[:, 0], _np(jnext.physics)[:, 2]
        edge = ((np.abs(np.abs(x) - X_THRESHOLD) < 1e-6)
                | (np.abs(np.abs(theta) - THETA_THRESHOLD) < 1e-6))
        near_edge += int(edge.sum())
        np.testing.assert_array_equal(done.numpy()[~edge], _np(jdone)[~edge])
        ended |= _np(jdone)
        jstate = jnext
        if ended.all():
            break
    assert ended.all() and near_edge <= 2
    if masked:
        assert not obs[:, 1].any() and not obs[:, 3].any()


# --- PocMemory rollout against JAX's -------------------------------------


def _jax_reset_keys(n, steps):
    """The reset keys of JAX's RolloutFn from ``init_state(PRNGKey(1))``:
    the initial reset's, then per step ``split(rng, 4)`` -> (rng, action,
    step, reset)."""
    rng, reset_rng = jax.random.split(jax.random.PRNGKey(1))
    resets = [jax.random.split(reset_rng, n)]
    for _ in range(steps):
        rng, _, _, reset_rng = jax.random.split(rng, 4)
        resets.append(jax.random.split(reset_rng, n))
    return resets


class _InjectedRollout(RolloutFn):
    """The port's rollout with JAX's actions and reset draws (PocMemory's
    steps draw nothing)."""

    def __init__(self, *args, actions, reset_draws):
        super().__init__(*args, generator=None)
        self.actions = actions
        self._resets = iter(reset_draws)
        self.t0 = 0

    def reset_draws(self):
        return next(self._resets)

    def sample_actions(self, logits, step):
        a = self.actions[:, self.t0 + step]
        return a, torch.stack([distributions.log_prob(l, a[:, i])
                               for i, l in enumerate(logits)], dim=-1)


def test_poc_memory_rollout_matches_jax():
    """Two rollouts of 64 steps at POC_MEMORY's width (4 workers): episodes
    end at goals and at the limit, and the second rollout carries memory
    in."""
    T, rollouts, n = 64, 2, 4
    jcfg = dataclasses.replace(
        jax_load_config("etmppo_tpu/configs/poc_memory_env.yaml"),
        n_workers=n, worker_steps=T)
    jenv = jax_create_env(jcfg.environment)
    jmodel = JModel(config=jcfg, obs_shape=jenv.observation_shape,
                    action_branches=jenv.action_branches,
                    max_episode_steps=jenv.max_episode_steps)
    params = jmodel.init_params(jax.random.PRNGKey(0))
    jfn = JRolloutFn(jcfg, jenv, jmodel)
    jstate = jfn.init_state(jax.random.PRNGKey(1))
    jbatches = []
    for _ in range(rollouts):
        jstate, jb = jfn(params, jstate)
        jbatches.append(jb)

    tcfg = config_from_dict(dataclasses.asdict(jcfg))
    env = PocMemoryEnv(glob=False, freeze=True, max_episode_steps=32,
                       n_workers=n, device="cpu")
    model = ActorCriticModel(tcfg, env.observation_shape, env.action_branches,
                             env.max_episode_steps, device="cpu")
    load_flax_params(model, params)
    reset = jax.jit(jax.vmap(jenv.reset))
    resets = _jax_reset_keys(n, rollouts * T)
    draws = [_poc_draws(env, reset(k)[0]) for k in resets]
    actions = torch.cat([torch.as_tensor(_np(b.actions)).long()
                         for b in jbatches], dim=1)
    fn = _InjectedRollout(tcfg, env, model, actions=actions,
                          reset_draws=draws)
    state = fn.init_state()
    for r, jb in enumerate(jbatches):
        fn.t0 = r * T
        state, tb = fn(state)
        for name in ("obs", "episode_steps", "dones"):
            np.testing.assert_array_equal(getattr(tb, name).numpy(),
                                          _np(getattr(jb, name)),
                                          err_msg=name)
        for name in ("values", "log_probs", "tape", "snapshot", "advantages"):
            np.testing.assert_allclose(getattr(tb, name).numpy(),
                                       _np(getattr(jb, name)), rtol=1e-4,
                                       atol=1e-4, err_msg=name)
        done = _np(jb.dones)
        for k, v in jb.episode_infos.items():
            np.testing.assert_allclose(tb.episode_infos[k].numpy()[done],
                                       _np(v)[done], rtol=1e-6)
    dones = np.concatenate([_np(b.dones) for b in jbatches], 1)
    assert dones.sum() >= 4 and _np(jbatches[1].snapshot).any()


# --- learning ----------------------------------------------------------


def test_poc_memory_learns(tmp_path):
    """The port's counterpart of tests/test_e2e_learning.py: 30 updates of
    POC_MEMORY on the CPU, seed 0."""
    cfg = dataclasses.replace(
        config_from_dict(POC_MEMORY), updates=30,
        summary_dir=str(tmp_path), checkpoint_dir=str(tmp_path))
    trainer = PPOTrainer(cfg, run_id="learn", device="cpu",
                         enable_metrics=False)
    result = {}
    for _ in range(cfg.updates):
        result = trainer.train_one_update()
    assert result["success_percent"] >= 0.9, result
    assert result["reward_mean"] > 0.5, result


def test_cartpole_trains_two_updates(tmp_path):
    """Masked CartPole's info has no ``success``: the update line and the
    metrics CSV do without it."""
    raw = dict(CARTPOLE_MASKED, updates=2, n_workers=4, worker_steps=64,
               n_mini_batch=2, epochs=1, hidden_layer_size=32,
               transformer=dict(CARTPOLE_MASKED["transformer"], num_blocks=2,
                                embed_dim=32),
               summary_dir=str(tmp_path), checkpoint_dir=str(tmp_path))
    trainer = PPOTrainer(config_from_dict(raw), run_id="cp", device="cpu")
    try:
        result = trainer.run_training(print_every=0)
    finally:
        trainer.close()
    assert "success" not in result and result["length_mean"] > 0
    assert all(np.isfinite(v) for v in result.values())
    with open(trainer.writer.csv_path) as f:
        header = f.readline()
    assert "episode/length_mean" in header and "success" not in header
