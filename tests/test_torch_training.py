"""etmppo_tpu_torch rollout and PPO update vs the JAX package, on a small
MiniGrid-Memory config with the flagship's architecture (CNN, post-LN TrXL,
relative PE, window-attention loss without the backward kernel).

* Rollout: the port is handed the JAX rollout's actions and reset draws, so
  both collect the same trajectories; values and memory items go through
  two conv-and-transformer forwards per step and agree to 1e-4.
* PPO: the same JAX rollout batch and the same per-epoch permutations go
  through both updates. Loss, stats and clipped gradients agree to 1e-4
  relative. The first AdamW step moves each parameter by about
  ``lr * sign(g)``: where |g| > 1e-6 the sign is certain and the parameters
  agree to 2e-6; where |g| <= 1e-6 the gradient is at the level of float
  noise, its sign may differ between the two, and the parameters agree to
  ``2 * lr``.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from etmppo_tpu.config import load_config as jax_load_config
from etmppo_tpu.envs.factory import create_env as jax_create_env
from etmppo_tpu.envs.minigrid_memory import KEY
from etmppo_tpu.models.actor_critic import ActorCriticModel as JModel
from etmppo_tpu.ops import memory_index as jmi
from etmppo_tpu.training import ppo as jppo
from etmppo_tpu.training.rollout import RolloutFn as JRolloutFn
from etmppo_tpu_torch.config import config_from_dict
from etmppo_tpu_torch.envs.minigrid_memory import (MinigridMemoryEnv,
                                                   MinigridResetDraws)
from etmppo_tpu_torch.interop import flax_to_state_dict, load_flax_params
from etmppo_tpu_torch.models.actor_critic import ActorCriticModel
from etmppo_tpu_torch.ops import distributions
from etmppo_tpu_torch.training.ppo import STAT_NAMES, PPOUpdate
from etmppo_tpu_torch.training.rollout import RolloutBatch, RolloutFn

torch.set_num_threads(1)
torch.backends.cudnn.allow_tf32 = False

LR, CLIP, BETA = 3e-4, 0.1, 0.001


def _jax_config(**overrides):
    cfg = jax_load_config("etmppo_tpu/configs/minigrid.yaml")
    trx = dataclasses.replace(cfg.transformer, num_blocks=2, embed_dim=32,
                              num_heads=4, memory_length=8)
    fields = dict(n_workers=2, worker_steps=16, n_mini_batch=1, epochs=1,
                  hidden_layer_size=32, transformer=trx,
                  pallas_backward=False)
    fields.update(overrides)
    return dataclasses.replace(cfg, **fields)


def _torch_config(jcfg):
    """The same config, built through the port's own config code."""
    return config_from_dict(dataclasses.asdict(jcfg))


def _jax_setup(jcfg, rollouts):
    env = jax_create_env(jcfg.environment)
    model = JModel(config=jcfg, obs_shape=env.observation_shape,
                   action_branches=env.action_branches,
                   max_episode_steps=env.max_episode_steps)
    params = model.init_params(jax.random.PRNGKey(0))
    rollout_fn = JRolloutFn(jcfg, env, model)
    state = rollout_fn.init_state(jax.random.PRNGKey(1))
    batches = []
    for _ in range(rollouts):
        state, batch = rollout_fn(params, state)
        batches.append(batch)
    return env, model, params, batches


def _torch_model(tcfg, env, params):
    model = ActorCriticModel(tcfg, env.observation_shape, env.action_branches,
                             env.max_episode_steps, device="cpu")
    load_flax_params(model, params)
    return model


def _torch_batch(batch) -> RolloutBatch:
    t = lambda x: torch.tensor(np.asarray(x))
    return RolloutBatch(
        obs=t(batch.obs), actions=t(batch.actions).long(),
        log_probs=t(batch.log_probs), values=t(batch.values),
        advantages=t(batch.advantages),
        episode_steps=t(batch.episode_steps).long(), dones=t(batch.dones),
        tape=t(batch.tape), snapshot=t(batch.snapshot),
        episode_infos={k: t(v) for k, v in batch.episode_infos.items()})


# --- rollout -----------------------------------------------------------


def _jax_reset_draws(env, W, rollouts, T):
    """The reset draws of JAX's RolloutFn (init_state(PRNGKey(1)), then
    split(rng, 4) per step), read back from the states they make."""
    reset = jax.jit(jax.vmap(env.reset))

    def draws(key):
        states, _ = reset(jax.random.split(key, W))
        grid = np.asarray(states.grid)
        return MinigridResetDraws(
            start_x=torch.tensor(np.asarray(states.pos)[:, 0]).long(),
            cue_is_key=torch.tensor(grid[:, env._cue[1], env._cue[0]] == KEY),
            top_is_key=torch.tensor(
                grid[:, env._obj_top[1], env._obj_top[0]] == KEY))

    rng, reset_rng = jax.random.split(jax.random.PRNGKey(1))
    out = [draws(reset_rng)]
    for _ in range(rollouts * T):
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


def test_rollout_matches_jax_with_injected_draws():
    """Two rollouts of 60 steps: the second carries memory in from the first
    and reaches the 96-step limit, so auto-reset, memory zeroing and the
    PE-only K/V cache reset are all exercised."""
    T, rollouts = 60, 2
    jcfg = _jax_config(worker_steps=T)
    env, _, params, jbatches = _jax_setup(jcfg, rollouts)
    tcfg = _torch_config(jcfg)
    tenv = MinigridMemoryEnv(jcfg.environment.name, jcfg.n_workers, "cpu")
    model = _torch_model(tcfg, tenv, params)
    actions = torch.cat([torch.tensor(np.asarray(b.actions)).long()
                         for b in jbatches], dim=1)
    draws = _jax_reset_draws(env, jcfg.n_workers, rollouts, T)
    fn = _InjectedRollout(tcfg, tenv, model, actions=actions, draws=draws)
    state = fn.init_state()
    saw_reset = False
    for r, jb in enumerate(jbatches):
        fn._actions = actions[:, r * T:(r + 1) * T]
        state, tb = fn(state)
        np.testing.assert_array_equal(tb.obs.numpy(), np.asarray(jb.obs))
        np.testing.assert_array_equal(tb.episode_steps.numpy(),
                                      np.asarray(jb.episode_steps))
        np.testing.assert_array_equal(tb.dones.numpy(), np.asarray(jb.dones))
        for name in ("values", "log_probs", "tape", "snapshot", "advantages"):
            np.testing.assert_allclose(getattr(tb, name).numpy(),
                                       np.asarray(getattr(jb, name)),
                                       rtol=1e-4, atol=1e-4, err_msg=name)
        for k, v in jb.episode_infos.items():
            done = np.asarray(jb.dones)
            np.testing.assert_allclose(tb.episode_infos[k].numpy()[done],
                                       np.asarray(v)[done], rtol=1e-6)
        saw_reset |= bool(np.asarray(jb.dones).any())
    assert saw_reset
    assert np.asarray(jbatches[1].snapshot).any()


# --- PPO update --------------------------------------------------------


def _jax_perms(rng, epochs, B):
    return np.stack([np.asarray(jax.random.permutation(k, B))
                     for k in jax.random.split(rng, epochs)])


def _jax_update(jupdate, params, batch, rng):
    """PPOUpdateFn donates its inputs: give it copies."""
    params = jax.tree.map(jnp.copy, params)
    return jupdate(params, jupdate.init_opt_state(params), batch, rng, LR,
                   CLIP, BETA)


def _jax_first_minibatch_grads(jcfg, model, update_fn, params, batch, idx):
    """JAX's loss, stats and clipped gradients of one minibatch, built the
    way PPOUpdateFn._update builds it."""
    L = jcfg.transformer.memory_length
    T = jcfg.worker_steps
    B = jcfg.batch_size
    max_ep = update_fn.max_ep
    timeline = jmi.build_timeline(batch.snapshot, batch.tape,
                                  batch.episode_steps[:, 0], pad=L)
    slots = jmi.build_timeline_slots(batch.episode_steps, max_ep, pad=L)
    tl = jmi.compute_timeline_sources(batch.episode_steps, batch.dones,
                                      update_fn.index_table, L)
    flat = lambda x: x.reshape((B,) + x.shape[2:])[idx]
    mb = dict(obs=flat(batch.obs), actions=flat(batch.actions),
              log_probs=flat(batch.log_probs), values=flat(batch.values),
              advantages=flat(batch.advantages), w_idx=idx // T,
              memory_mask=update_fn.mask_table[
                  jnp.clip(flat(batch.episode_steps), 0, L - 1)],
              tl_start=flat(tl.start), tl_n_valid=flat(tl.n_valid),
              tl_s_lo=flat(tl.s_lo))
    (loss, stats), grads = jax.value_and_grad(
        update_fn._loss_pallas, has_aux=True)(params, mb, timeline, slots,
                                              CLIP, BETA)
    grads, _ = jppo.clip_grads_torch(grads, jcfg.max_grad_norm)
    return np.asarray(stats), grads


@pytest.fixture(scope="module")
def one_step():
    """One AdamW step on the whole batch (1 epoch x 1 minibatch)."""
    jcfg = _jax_config()
    env, jmodel, params, batches = _jax_setup(jcfg, 2)
    batch = batches[-1]     # carries memory in: the timeline has snapshot rows
    jupdate = jppo.PPOUpdateFn(jcfg, jmodel, env.max_episode_steps)
    rng = jax.random.PRNGKey(3)
    perms = _jax_perms(rng, jcfg.epochs, jcfg.batch_size)
    j_stats_mb, j_grads = _jax_first_minibatch_grads(
        jcfg, jmodel, jupdate, params, batch, jnp.asarray(perms[0]))
    j_new, _, j_stats, j_groups = _jax_update(jupdate, params, batch, rng)

    tcfg = _torch_config(jcfg)
    model = _torch_model(tcfg, env, params)
    update = PPOUpdate(tcfg, model, env.max_episode_steps, generator=None)
    t_stats, t_groups = update(_torch_batch(batch), LR, CLIP, BETA,
                               perms=torch.as_tensor(perms))
    return dict(params=params, j_new=j_new, j_stats=np.asarray(j_stats),
                j_stats_mb=j_stats_mb, j_grads=j_grads, j_groups=j_groups,
                model=model, t_stats=t_stats, t_groups=t_groups)


def test_loss_and_stats_match(one_step):
    np.testing.assert_allclose(one_step["t_stats"].numpy(),
                               one_step["j_stats_mb"], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(one_step["t_stats"].numpy(),
                               one_step["j_stats"], rtol=1e-4, atol=1e-6)


def test_clipped_gradients_match(one_step):
    j_grads = flax_to_state_dict(one_step["j_grads"])
    for name, p in one_step["model"].named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), j_grads[name].numpy(),
                                   rtol=1e-4, atol=1e-7, err_msg=name)


def test_grad_norm_groups_match(one_step):
    j_groups = {k: float(v) for k, v in one_step["j_groups"].items()}
    t_groups = {k: float(v) for k, v in one_step["t_groups"].items()}
    assert set(t_groups) == set(j_groups)
    for k in j_groups:
        np.testing.assert_allclose(t_groups[k], j_groups[k], rtol=1e-4,
                                   err_msg=k)


def test_params_after_one_adamw_step_match(one_step):
    j_new = flax_to_state_dict(one_step["j_new"])
    j_grads = flax_to_state_dict(one_step["j_grads"])
    for name, p in one_step["model"].named_parameters():
        diff = np.abs(p.detach().numpy() - j_new[name].numpy())
        clear = np.abs(j_grads[name].numpy()) > 1e-6
        assert diff[clear].max(initial=0.0) <= 2e-6, name
        assert diff[~clear].max(initial=0.0) <= 2 * LR, name


def test_full_update_matches():
    """2 epochs x 2 minibatches: stats and gradient-norm groups are means
    over the four steps. Later steps start from parameters that may differ
    by up to 2 * lr on noise-level entries, hence 1e-3; every parameter ends
    within 2 * lr per step, and 99% of them within 1e-5."""
    jcfg = _jax_config(epochs=2, n_mini_batch=2)
    env, jmodel, params, (batch,) = _jax_setup(jcfg, 1)
    jupdate = jppo.PPOUpdateFn(jcfg, jmodel, env.max_episode_steps)
    rng = jax.random.PRNGKey(5)
    perms = _jax_perms(rng, jcfg.epochs, jcfg.batch_size)
    j_new, _, j_stats, j_groups = _jax_update(jupdate, params, batch, rng)

    tcfg = _torch_config(jcfg)
    model = _torch_model(tcfg, env, params)
    update = PPOUpdate(tcfg, model, env.max_episode_steps, generator=None)
    t_stats, t_groups = update(_torch_batch(batch), LR, CLIP, BETA,
                               perms=torch.as_tensor(perms))
    np.testing.assert_allclose(t_stats.numpy(), np.asarray(j_stats),
                               rtol=1e-3, atol=1e-6)
    for k, v in j_groups.items():
        np.testing.assert_allclose(float(t_groups[k]), float(v), rtol=1e-3)
    j_new = flax_to_state_dict(j_new)
    diffs = np.concatenate([
        np.abs(p.detach().numpy() - j_new[n].numpy()).ravel()
        for n, p in model.named_parameters()])
    assert diffs.max() <= 2 * LR * 4
    assert np.quantile(diffs, 0.99) <= 1e-5


def test_update_draws_its_own_permutations():
    jcfg = _jax_config(epochs=2, n_mini_batch=2)
    env, _, params, (batch,) = _jax_setup(jcfg, 1)
    tcfg = _torch_config(jcfg)
    model = _torch_model(tcfg, env, params)
    update = PPOUpdate(tcfg, model, env.max_episode_steps,
                       generator=torch.Generator().manual_seed(0))
    stats, groups = update(_torch_batch(batch), LR, CLIP, BETA)
    assert stats.shape == (len(STAT_NAMES),) and torch.isfinite(stats).all()
    assert all(torch.isfinite(v) for v in groups.values())
