"""etmppo_tpu_torch's batched Mortar Mayhem Grid vs the JAX package's env,
and a tiny-width Mortar Mayhem trainer against the JAX package's.

* The env: the port is handed the commands JAX's ``_sample_commands`` drew,
  so both build the same targets; observations, rewards, dones, infos and
  states are then compared exactly over random actions and over runs that
  carry the commands out. Every value is an integer or a float32 constant,
  so there is no tolerance.
* ``MORTAR_MAYHEM_GRID`` is exactly ``mortar_mayhem_grid.yaml``.
* The trainer: a rollout of the port, handed JAX's actions and reset draws,
  collects JAX's trajectories (values, log-probs and memory items to 1e-4,
  as in tests/test_torch_training.py); one PPO update with the YAML's
  ``pallas_backward: true`` on that batch gives JAX's stats and clipped
  gradients to 1e-4 relative (JAX's Pallas kernels run in interpret mode).
"""
import dataclasses

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from etmppo_tpu.config import load_config as jax_load_config
from etmppo_tpu.envs.factory import create_env as jax_create_env
from etmppo_tpu.envs.mortar_mayhem import MortarMayhemGridEnv as JEnv
from etmppo_tpu.envs.mortar_mayhem import _glyphs as jax_glyphs
from etmppo_tpu.models.actor_critic import ActorCriticModel as JModel
from etmppo_tpu.ops import memory_index as jmi
from etmppo_tpu.training import ppo as jppo
from etmppo_tpu.training.rollout import RolloutFn as JRolloutFn
from etmppo_tpu_torch.config import (MORTAR_MAYHEM_GRID, config_from_dict,
                                     config_to_dict, load_config)
from etmppo_tpu_torch.envs.factory import create_env
from etmppo_tpu_torch.envs.mortar_mayhem import (MortarMayhemGridEnv,
                                                 MortarMayhemResetDraws,
                                                 glyphs)
from etmppo_tpu_torch.interop import flax_to_state_dict, load_flax_params
from etmppo_tpu_torch.models.actor_critic import ActorCriticModel
from etmppo_tpu_torch.ops import distributions
from etmppo_tpu_torch.training.ppo import PPOUpdate
from etmppo_tpu_torch.training.rollout import RolloutBatch, RolloutFn

torch.set_num_threads(1)

W = 16
YAML = "etmppo_tpu/configs/mortar_mayhem_grid.yaml"
PARAMS = {
    "flagship": jax_load_config(YAML).environment.reset_params,
    "diagonal_and_penalised": {"arena_size": 7, "allowed_commands": 9,
                               "command_count": [4, 6],
                               "explosion_duration": [3],
                               "explosion_delay": [4],
                               "reward_command_failure": -0.5,
                               "reward_command_success": 0.25,
                               "reward_episode_success": 1.0},
}


def _assert_state_equal(jstate, tstate):
    for name, value in zip(tstate._fields, tstate):
        np.testing.assert_array_equal(value.numpy(),
                                      np.asarray(getattr(jstate, name)),
                                      err_msg=name)


@pytest.fixture(scope="module", params=list(PARAMS))
def envs(request):
    jenv = JEnv(PARAMS[request.param])
    tenv = MortarMayhemGridEnv(PARAMS[request.param], W, "cpu")
    keys = jax.random.split(jax.random.PRNGKey(7), W)
    jstate, jobs = jax.jit(jax.vmap(jenv.reset))(keys)
    draws = MortarMayhemResetDraws(torch.tensor(np.asarray(jstate.commands)))
    tstate, tobs = tenv.reset(draws)
    return jenv, tenv, jstate, jobs, tstate, tobs


def test_glyphs_are_the_jax_envs():
    np.testing.assert_array_equal(glyphs(20), jax_glyphs(20))


def test_reset_matches(envs):
    jenv, tenv, jstate, jobs, tstate, tobs = envs
    _assert_state_equal(jstate, tstate)
    np.testing.assert_array_equal(tobs.numpy(), np.asarray(jobs))
    assert tenv.max_episode_steps == jenv.max_episode_steps


def _step_both(jenv, tenv, jstate, tstate, actions):
    step = jax.jit(jax.vmap(jenv.step))
    keys = jax.random.split(jax.random.PRNGKey(0), W)
    rewards, dones = [], []
    for t in range(actions.shape[1]):
        a = actions[:, t:t + 1]
        jstate, jobs, jr, jd, ji = step(jstate, jnp.asarray(a), keys)
        tstate, tobs, tr, td, ti = tenv.step(tstate, torch.as_tensor(a))
        np.testing.assert_array_equal(tobs.numpy(), np.asarray(jobs))
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        for k in ji:
            np.testing.assert_array_equal(ti[k].numpy(), np.asarray(ji[k]),
                                          err_msg=k)
        rewards.append(tr.numpy())
        dones.append(td.numpy())
    _assert_state_equal(jstate, tstate)
    return tstate, np.stack(rewards, 1), np.stack(dones, 1)


def test_random_steps_match_past_the_step_cap(envs):
    """130 random steps: the frozen announcement, failed verifications, and
    stepping on past the end of the episode."""
    jenv, tenv, jstate, _, tstate, _ = envs
    actions = np.random.default_rng(0).integers(
        0, tenv.allowed_commands, (W, 130))
    tstate, _, dones = _step_both(jenv, tenv, jstate, tstate, actions)
    assert (tstate.t == 130).all() and tstate.failed.any()
    assert dones.any(axis=1).all()


def _wrong_step(tenv):
    """The first verification step of the third command."""
    return (tenv.announce_steps + 2 * tenv.exec_steps_per_cmd
            + tenv.explosion_delay)


def _commanded_actions(tenv, state, n_steps):
    """Carries each command out at the first step of its window, then stays;
    workers with an odd index instead step off the target at the first
    verification step of their third command, and fail there."""
    actions = np.zeros((W, n_steps), np.int64)
    commands = state.commands.numpy()
    for i in range(tenv.command_count):
        actions[:, tenv.announce_steps + i * tenv.exec_steps_per_cmd] = \
            commands[:, i]
    # up (1) where the target is below the top row, else down (3)
    off = np.where(state.targets[:, 2, 1].numpy() > 0, 1, 3)
    actions[1::2, _wrong_step(tenv)] = off[1::2]
    return actions


def test_carrying_out_the_commands(envs):
    jenv, tenv, jstate, _, tstate, _ = envs
    C = tenv.command_count
    actions = _commanded_actions(tenv, tstate, tenv.max_episode_steps + 5)
    tstate, rewards, dones = _step_both(jenv, tenv, jstate, tstate, actions)
    end = tenv.max_episode_steps - 1
    good, bad = slice(0, None, 2), slice(1, None, 2)
    assert (tstate.commands_done[good] == C).all()
    assert not tstate.failed[good].any()
    assert dones[good, end].all() and not dones[good, :end].any()
    np.testing.assert_allclose(rewards[good, :end + 1].sum(1),
                               C * tenv.r_success + tenv.r_episode, rtol=1e-6)
    wrong = _wrong_step(tenv)
    assert tstate.failed[bad].all()
    assert dones[bad, wrong].all() and not dones[bad, :wrong].any()
    np.testing.assert_allclose(rewards[bad, :wrong].sum(1),
                               2 * tenv.r_success, rtol=1e-6)
    assert (rewards[bad, wrong] == np.float32(tenv.r_fail)).all()


def test_sampled_commands_keep_the_targets_in_the_arena():
    env = MortarMayhemGridEnv(PARAMS["flagship"], 512, "cpu")
    draws = env.sample_reset_draws(torch.Generator().manual_seed(0))
    assert draws.commands.shape == (512, env.command_count)
    state, obs = env.reset(draws)
    assert obs.shape == (512, 84, 84, 3)
    assert ((state.targets >= 0) & (state.targets < env.arena)).all()
    # From the centre of a 5x5 arena every command is allowed: uniform.
    first = torch.bincount(draws.commands[:, 0], minlength=5).float() / 512
    assert ((first - 0.2).abs() < 0.06).all()
    assert set(draws.commands.unique().tolist()) == set(range(5))


def test_factory_builds_the_env():
    cfg = config_from_dict(MORTAR_MAYHEM_GRID)
    env = create_env(cfg.environment, 4, "cpu")
    assert isinstance(env, MortarMayhemGridEnv)
    assert env.n_workers == 4 and env.observation_shape == (84, 84, 3)
    assert env.action_branches == (5,) and env.max_episode_steps == 120
    assert env.command_count == 10 and env.arena == 5


def test_config_dict_is_exactly_the_yaml():
    with open(YAML) as f:
        assert MORTAR_MAYHEM_GRID == yaml.safe_load(f)
    cfg = config_from_dict(MORTAR_MAYHEM_GRID)
    assert cfg == load_config(YAML)
    assert config_to_dict(cfg) == dataclasses.asdict(jax_load_config(YAML))
    assert cfg.use_pallas_attention and cfg.pallas_backward


# --- a tiny-width trainer ------------------------------------------------

LR, CLIP, BETA = 3e-4, 0.1, 0.001
T = 24


def _jax_config():
    cfg = jax_load_config(YAML)
    trx = dataclasses.replace(cfg.transformer, num_blocks=2, embed_dim=32,
                              num_heads=4, memory_length=10)
    return dataclasses.replace(cfg, n_workers=2, worker_steps=T,
                               n_mini_batch=1, epochs=1, hidden_layer_size=32,
                               transformer=trx)


def _torch_batch(batch) -> RolloutBatch:
    t = lambda x: torch.tensor(np.asarray(x))
    return RolloutBatch(
        obs=t(batch.obs), actions=t(batch.actions).long(),
        log_probs=t(batch.log_probs), values=t(batch.values),
        advantages=t(batch.advantages),
        episode_steps=t(batch.episode_steps).long(), dones=t(batch.dones),
        tape=t(batch.tape), snapshot=t(batch.snapshot),
        episode_infos={k: t(v) for k, v in batch.episode_infos.items()})


def _jax_reset_draws(env, n_workers, steps):
    """The commands of JAX's RolloutFn resets (init_state(PRNGKey(1)), then
    split(rng, 4) per step)."""
    reset = jax.jit(jax.vmap(env.reset))

    def draws(key):
        states, _ = reset(jax.random.split(key, n_workers))
        return MortarMayhemResetDraws(
            torch.tensor(np.asarray(states.commands)).long())

    rng, reset_rng = jax.random.split(jax.random.PRNGKey(1))
    out = [draws(reset_rng)]
    for _ in range(steps):
        rng, _, _, reset_rng = jax.random.split(rng, 4)
        out.append(draws(reset_rng))
    return out


class _InjectedRollout(RolloutFn):
    """The port's rollout with JAX's actions and reset draws."""

    def __init__(self, *args, actions, draws):
        super().__init__(*args, generator=None)
        self._actions = actions
        self._draws = iter(draws)

    def reset_draws(self):
        return next(self._draws)

    def sample_actions(self, logits, step):
        a = self._actions[:, step]
        return a, torch.stack([distributions.log_prob(l, a[:, i])
                               for i, l in enumerate(logits)], dim=-1)


@pytest.fixture(scope="module")
def trainer_step():
    jcfg = _jax_config()
    env = jax_create_env(jcfg.environment)
    jmodel = JModel(config=jcfg, obs_shape=env.observation_shape,
                    action_branches=env.action_branches,
                    max_episode_steps=env.max_episode_steps)
    params = jmodel.init_params(jax.random.PRNGKey(0))
    rollout_fn = JRolloutFn(jcfg, env, jmodel)
    state = rollout_fn.init_state(jax.random.PRNGKey(1))
    state, batch = rollout_fn(params, state)

    jupdate = jppo.PPOUpdateFn(jcfg, jmodel, env.max_episode_steps)
    L, B = jcfg.transformer.memory_length, jcfg.batch_size
    perm = np.asarray(jax.random.permutation(jax.random.PRNGKey(3), B))
    idx = jnp.asarray(perm)
    timeline = jmi.build_timeline(batch.snapshot, batch.tape,
                                  batch.episode_steps[:, 0], pad=L)
    slots = jmi.build_timeline_slots(batch.episode_steps, jupdate.max_ep,
                                     pad=L)
    tl = jmi.compute_timeline_sources(batch.episode_steps, batch.dones,
                                      jupdate.index_table, L)
    flat = lambda x: x.reshape((B,) + x.shape[2:])[idx]
    mb = dict(obs=flat(batch.obs), actions=flat(batch.actions),
              log_probs=flat(batch.log_probs), values=flat(batch.values),
              advantages=flat(batch.advantages), w_idx=idx // T,
              memory_mask=jupdate.mask_table[
                  jnp.clip(flat(batch.episode_steps), 0, L - 1)],
              tl_start=flat(tl.start), tl_n_valid=flat(tl.n_valid),
              tl_s_lo=flat(tl.s_lo))
    from etmppo_tpu.ops import pallas_window_attention as pwa
    mp = pytest.MonkeyPatch()
    mp.setattr(pwa, "BACKWARD_MODE", "pallas")
    try:
        (_, j_stats), j_grads = jax.value_and_grad(
            jupdate._loss_pallas, has_aux=True)(params, mb, timeline, slots,
                                                CLIP, BETA)
    finally:
        mp.undo()
    j_grads, _ = jppo.clip_grads_torch(j_grads, jcfg.max_grad_norm)

    tcfg = config_from_dict(dataclasses.asdict(jcfg))
    tenv = MortarMayhemGridEnv(jcfg.environment.reset_params,
                               jcfg.n_workers, "cpu")
    model = ActorCriticModel(tcfg, tenv.observation_shape,
                             tenv.action_branches, tenv.max_episode_steps,
                             device="cpu")
    load_flax_params(model, params)
    fn = _InjectedRollout(tcfg, tenv, model,
                          actions=torch.tensor(np.asarray(batch.actions)),
                          draws=_jax_reset_draws(env, jcfg.n_workers, T))
    _, t_batch = fn(fn.init_state())
    update = PPOUpdate(tcfg, model, tenv.max_episode_steps, generator=None)
    t_stats, _ = update(_torch_batch(batch), LR, CLIP, BETA,
                        perms=torch.tensor(perm)[None])
    return dict(j_batch=batch, t_batch=t_batch, j_stats=np.asarray(j_stats),
                j_grads=j_grads, t_stats=t_stats, model=model)


def test_rollout_matches_jax(trainer_step):
    jb, tb = trainer_step["j_batch"], trainer_step["t_batch"]
    np.testing.assert_array_equal(tb.obs.numpy(), np.asarray(jb.obs))
    np.testing.assert_array_equal(tb.dones.numpy(), np.asarray(jb.dones))
    np.testing.assert_array_equal(tb.episode_steps.numpy(),
                                  np.asarray(jb.episode_steps))
    for name in ("values", "log_probs", "tape", "advantages"):
        np.testing.assert_allclose(getattr(tb, name).numpy(),
                                   np.asarray(getattr(jb, name)),
                                   rtol=1e-4, atol=1e-4, err_msg=name)


def test_update_stats_match(trainer_step):
    np.testing.assert_allclose(trainer_step["t_stats"].numpy(),
                               trainer_step["j_stats"], rtol=1e-4, atol=1e-6)


def test_update_clipped_gradients_match(trainer_step):
    j_grads = flax_to_state_dict(trainer_step["j_grads"])
    for name, p in trainer_step["model"].named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), j_grads[name].numpy(),
                                   rtol=1e-4, atol=1e-7, err_msg=name)
