"""``obs_uint8`` in etmppo_tpu_torch against the JAX package.

The rollout stores each observation as ``round(obs * 255)`` in uint8 and
the update divides every minibatch's observations by 255. XLA's
float-to-uint8 cast saturates; PyTorch's wraps (-0.2 * 255 rounds to -51,
which wraps to 205), so the port clamps to [0, 255] first. PocMemory (+-1)
and CartPole (signed positions) have negative observations, which both
packages store as 0.

* The quantization equals JAX's on negatives, values between the levels and
  values over 1.
* PocMemory and CartPole rollouts (handed JAX's actions and reset draws)
  store JAX's uint8 observations exactly; the rollout is the float one.
* The update on JAX's uint8 batch matches JAX's: one minibatch's stats and
  gradient-norm groups to rtol 1e-4, the float32 tolerance of
  tests/test_torch_gathered_loss.py.
* The counterpart of tests/test_fused.py:92-105: uint8 and float storage
  train to nearly the same losses.
* A host env refuses ``obs_uint8``: the JAX package's host rollout stores
  float observations and its update still divides them by 255.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from etmppo_tpu.config import load_config as jax_load_config
from etmppo_tpu.envs.factory import create_env as jax_create_env
from etmppo_tpu.envs.native import NativeEnvBatch as JaxNativeEnvBatch
from etmppo_tpu.models.actor_critic import ActorCriticModel as JModel
from etmppo_tpu.training import ppo as jppo
from etmppo_tpu.training.host_rollout import HostRolloutFn as JHostRolloutFn
from etmppo_tpu.training.rollout import RolloutFn as JRolloutFn
from etmppo_tpu_torch.config import POC_MEMORY, config_from_dict
from etmppo_tpu_torch.envs.factory import create_env
from etmppo_tpu_torch.envs.poc_memory import PocMemoryResetDraws
from etmppo_tpu_torch.interop import load_flax_params
from etmppo_tpu_torch.models.actor_critic import ActorCriticModel
from etmppo_tpu_torch.ops import distributions
from etmppo_tpu_torch.training.ppo import PPOUpdate
from etmppo_tpu_torch.training.rollout import (RolloutBatch, RolloutFn,
                                               quantize_obs)
from etmppo_tpu_torch.training.trainer import PPOTrainer

torch.set_num_threads(1)

LR, CLIP, BETA = 3e-4, 0.2, 0.001
VALUES = [-1.0, -0.2, 0.0, 0.5 / 255, 1.5 / 255, 0.2, 1.0, 1.2]


def test_quantization_saturates_as_jax_does():
    obs = np.array(VALUES, np.float32)
    want = np.asarray(jnp.round(jnp.asarray(obs) * 255.0).astype(jnp.uint8))
    np.testing.assert_array_equal(want, [0, 0, 0, 0, 2, 51, 255, 255])
    got = quantize_obs(torch.as_tensor(obs))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    # PyTorch's own cast wraps, which the clamp is there to prevent
    wrapped = torch.round(torch.as_tensor(obs) * 255).to(torch.uint8)
    assert wrapped.numpy().tolist() == [1, 205, 0, 0, 2, 51, 255, 50]


# --- rollouts against JAX's -------------------------------------------------

def _jax_config(name):
    path = {"poc": "etmppo_tpu/configs/poc_memory_env.yaml",
            "cartpole": "etmppo_tpu/configs/cartpole.yaml"}[name]
    cfg = jax_load_config(path)
    return dataclasses.replace(
        cfg, n_workers=4, worker_steps=64, n_mini_batch=1, epochs=1,
        hidden_layer_size=16, obs_uint8=True,
        transformer=dataclasses.replace(cfg.transformer, num_blocks=2,
                                        embed_dim=16))


def _draws(name, env, states):
    """The port's reset draws for the states a JAX reset made."""
    if name == "cartpole":
        return torch.as_tensor(np.asarray(states.physics))
    start = np.searchsorted(env.start_ticks.numpy(), np.asarray(states.ticks))
    return PocMemoryResetDraws(torch.as_tensor(start).long(), torch.as_tensor(
        np.asarray(states.goals)[:, 0] == 1.0))


class _Injected(RolloutFn):
    """The port's rollout with JAX's actions and reset draws (neither env
    draws in its step)."""

    def __init__(self, *args, actions, reset_draws):
        super().__init__(*args, generator=None)
        self.actions = actions
        self._resets = iter(reset_draws)

    def reset_draws(self):
        return next(self._resets)

    def sample_actions(self, logits, step):
        a = self.actions[:, step]
        return a, torch.stack([distributions.log_prob(l, a[:, i])
                               for i, l in enumerate(logits)], dim=-1)


def _rollouts(name):
    """JAX's rollout with ``obs_uint8``, and the port's with JAX's actions
    and reset draws; the JAX model and parameters."""
    jcfg = _jax_config(name)
    jenv = jax_create_env(jcfg.environment)
    jmodel = JModel(config=jcfg, obs_shape=jenv.observation_shape,
                    action_branches=jenv.action_branches,
                    max_episode_steps=jenv.max_episode_steps)
    params = jmodel.init_params(jax.random.PRNGKey(0))
    jfn = JRolloutFn(jcfg, jenv, jmodel)
    _, jbatch = jfn(params, jfn.init_state(jax.random.PRNGKey(1)))

    n, T = jcfg.n_workers, jcfg.worker_steps
    rng, reset_rng = jax.random.split(jax.random.PRNGKey(1))
    keys = [jax.random.split(reset_rng, n)]
    for _ in range(T):
        rng, _, _, reset_rng = jax.random.split(rng, 4)
        keys.append(jax.random.split(reset_rng, n))
    tcfg = config_from_dict(dataclasses.asdict(jcfg))
    env = create_env(tcfg.environment, n, "cpu")
    reset = jax.jit(jax.vmap(jenv.reset))
    model = ActorCriticModel(tcfg, env.observation_shape, env.action_branches,
                             env.max_episode_steps, device="cpu")
    load_flax_params(model, params)
    fn = _Injected(tcfg, env, model,
                   actions=torch.tensor(np.asarray(jbatch.actions)).long(),
                   reset_draws=[_draws(name, env, reset(k)[0])
                                for k in keys])
    _, batch = fn(fn.init_state())
    return jcfg, jmodel, params, jbatch, tcfg, env, model, batch


@pytest.fixture(scope="module", params=["poc", "cartpole"])
def rollouts(request):
    return _rollouts(request.param)


def test_rollout_stores_jax_uint8_obs(rollouts):
    *_, jbatch, _, _, _, batch = rollouts
    assert batch.obs.dtype == torch.uint8
    assert np.asarray(jbatch.obs).dtype == np.uint8
    np.testing.assert_array_equal(batch.obs.numpy(), np.asarray(jbatch.obs))
    # the envs' negative observations are stored as 0
    assert (batch.obs == 0).any() and (batch.obs > 0).any()
    np.testing.assert_array_equal(batch.dones.numpy(),
                                  np.asarray(jbatch.dones))
    for name in ("values", "log_probs", "tape", "advantages"):
        np.testing.assert_allclose(getattr(batch, name).numpy(),
                                   np.asarray(getattr(jbatch, name)),
                                   rtol=1e-4, atol=1e-4, err_msg=name)


def test_update_on_the_uint8_batch_matches_jax(rollouts):
    """One minibatch (the whole batch, 1 epoch) of JAX's uint8 batch:
    stats and gradient-norm groups."""
    jcfg, jmodel, params, jbatch, tcfg, env, _, _ = rollouts
    jupdate = jppo.PPOUpdateFn(jcfg, jmodel, env.max_episode_steps)
    rng = jax.random.PRNGKey(3)
    perm = np.asarray(jax.random.permutation(jax.random.split(rng, 1)[0],
                                             jcfg.batch_size))
    jparams = jax.tree.map(jnp.copy, params)
    _, _, j_stats, j_groups = jupdate(jparams, jupdate.init_opt_state(jparams),
                                      jbatch, rng, LR, CLIP, BETA)

    model = ActorCriticModel(tcfg, env.observation_shape, env.action_branches,
                             env.max_episode_steps, device="cpu")
    load_flax_params(model, params)
    update = PPOUpdate(tcfg, model, env.max_episode_steps, generator=None)
    t = lambda x: torch.tensor(np.asarray(x))
    batch = RolloutBatch(
        obs=t(jbatch.obs), actions=t(jbatch.actions).long(),
        log_probs=t(jbatch.log_probs), values=t(jbatch.values),
        advantages=t(jbatch.advantages),
        episode_steps=t(jbatch.episode_steps).long(), dones=t(jbatch.dones),
        tape=t(jbatch.tape), snapshot=t(jbatch.snapshot), episode_infos={})
    assert batch.obs.dtype == torch.uint8
    mb = update.minibatch(update.prepare(batch)[2], torch.as_tensor(perm))
    assert mb["obs"].dtype == torch.float32
    torch.testing.assert_close(mb["obs"], batch.obs.reshape(
        (-1,) + tuple(batch.obs.shape[2:]))[torch.as_tensor(perm)] / 255.0)
    t_stats, t_groups = update(batch, LR, CLIP, BETA,
                               perms=torch.as_tensor(perm)[None])
    np.testing.assert_allclose(t_stats.numpy(), np.asarray(j_stats),
                               rtol=1e-4, atol=1e-6)
    for k, v in j_groups.items():
        np.testing.assert_allclose(float(t_groups[k]), float(v), rtol=1e-4,
                                   err_msg=k)


# --- training ------------------------------------------------------------


def _tiny(tmp_path, **overrides):
    """The JAX package's tests/test_fused.py config, on the port."""
    raw = dict(POC_MEMORY, n_workers=4, worker_steps=16, n_mini_batch=2,
               epochs=2, hidden_layer_size=16,
               transformer=dict(POC_MEMORY["transformer"], num_blocks=2,
                                embed_dim=16, num_heads=2, memory_length=8),
               summary_dir=str(tmp_path), checkpoint_dir=str(tmp_path))
    raw.update(overrides)
    return raw


def test_obs_uint8_storage_trains(tmp_path):
    """uint8 and float storage from the same seeds: the same rollouts (the
    policy sees float obs) and nearly the same losses; PocMemory's -1 is
    stored as 0, so the updates see other inputs."""
    results = []
    for obs_uint8 in (False, True):
        trainer = PPOTrainer(config_from_dict(_tiny(tmp_path,
                                                    obs_uint8=obs_uint8)),
                             device="cpu", enable_metrics=False)
        results.append([trainer.train_one_update() for _ in range(2)])
    for a, b in zip(*results):
        assert math.isfinite(b["loss"])
        assert abs(a["loss"] - b["loss"]) < 0.05
    assert results[0][0]["value_mean"] == results[1][0]["value_mean"]


def test_host_env_refuses_obs_uint8(tmp_path):
    """The port refuses; the JAX package's host batch under ``obs_uint8``
    holds float32 observations, which its update would divide by 255."""
    with pytest.raises(ValueError, match="obs_uint8"):
        PPOTrainer(config_from_dict(_tiny(
            tmp_path, obs_uint8=True,
            environment={"type": "PocMemoryEnv-native"})), device="cpu",
            enable_metrics=False)

    jcfg = dataclasses.replace(_jax_config("poc"), worker_steps=8,
                               environment=dataclasses.replace(
                                   _jax_config("poc").environment,
                                   type="PocMemoryEnv-native"))
    jenv = JaxNativeEnvBatch("PocMemoryEnv-native")
    try:
        jmodel = JModel(config=jcfg, obs_shape=jenv.observation_shape,
                        action_branches=jenv.action_branches,
                        max_episode_steps=jenv.max_episode_steps)
        params = jmodel.init_params(jax.random.PRNGKey(0))
        jfn = JHostRolloutFn(jcfg, jenv, jmodel, pipeline=False)
        _, jbatch = jfn(params, jfn.init_state(jax.random.PRNGKey(1)))
    finally:
        jenv.close()
    obs = np.asarray(jbatch.obs)
    assert jcfg.obs_uint8 and obs.dtype == np.float32
    assert obs.min() < 0          # not quantized: -1 stays -1
