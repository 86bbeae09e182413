"""etmppo_tpu_torch's Searing Spotlights vs the JAX package's env, and a
tiny-width Searing Spotlights rollout against JAX's.

* Reset: the port is handed the five values the JAX reset derived (agent,
  coin, exit, spotlights, targets, already in their ranges), so both states
  are equal.
* Step: each step is taken from the same state on both sides, with the
  candidate targets the JAX step drew from its key. States agree to rtol
  1e-6 (positions pass through a norm and ``delta / (dist + 1e-9)``, which
  XLA may fuse or reorder); rewards, dones and infos exactly.
* Observations: a pixel is lit where its centre lies strictly inside a
  disk, ``dx^2 + dy^2 < r^2``, which XLA may compute with a fused
  multiply-add. So observations are equal except at pixels whose centre
  lies within 1e-5 of a disk's edge; those are counted and bounded.
* The rollout: the port's rollout, handed JAX's actions, per-step target
  draws (JAX splits each step's key into one per worker) and reset draws,
  collects JAX's trajectories at a tiny width (TrXL 2 x 32): values,
  log-probs, memory items and advantages to 1e-4, observations as above.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from etmppo_tpu.config import load_config as jax_load_config
from etmppo_tpu.envs.factory import create_env as jax_create_env
from etmppo_tpu.envs import searing_spotlights as jss
from etmppo_tpu.models.actor_critic import ActorCriticModel as JModel
from etmppo_tpu.training.rollout import RolloutFn as JRolloutFn
from etmppo_tpu_torch.config import (SEARING_SPOTLIGHTS,
                                     SEARING_SPOTLIGHTS_SHAPED, EnvConfig,
                                     config_from_dict)
from etmppo_tpu_torch.envs.factory import create_env
from etmppo_tpu_torch.envs.searing_spotlights import (
    N_SPOTS, SearingSpotlightsEnv, SearingSpotlightsResetDraws,
    SearingSpotlightsState)
from etmppo_tpu_torch.interop import load_flax_params
from etmppo_tpu_torch.models.actor_critic import ActorCriticModel
from etmppo_tpu_torch.ops import distributions
from etmppo_tpu_torch.training.rollout import RolloutFn

torch.set_num_threads(1)

W = 48
EDGE = 1e-5
PARAMS = {
    "yaml": {"start-seed": 0, "num-seeds": 100000},
    "shaped": SEARING_SPOTLIGHTS_SHAPED["environment"]["reset_params"],
    "deadly": {"agent_health": 10.0, "spot_damage": 5.0, "reward_death": -1.0,
               "reward_coin": 0.5, "reward_exit": 2.0,
               "reward_damage": -0.1},
}


def _np(x):
    return np.array(x)


def _draws(states) -> SearingSpotlightsResetDraws:
    """The values a JAX reset derived, read back from its states."""
    t = lambda x: torch.as_tensor(_np(x))
    return SearingSpotlightsResetDraws(
        pos=t(states.pos), coin=t(states.coin_pos), exit=t(states.exit_pos),
        spots=t(states.spot_pos), targets=t(states.spot_target))


def _torch_state(states) -> SearingSpotlightsState:
    fields = {name: torch.as_tensor(_np(getattr(states, name)))
              for name in SearingSpotlightsState._fields}
    fields["t"] = fields["t"].long()
    fields["length"] = fields["length"].long()
    return SearingSpotlightsState(**fields)


def _step_draws(keys):
    return jax.vmap(lambda k: jax.random.uniform(k, (N_SPOTS, 2)))(keys)


def _edge_pixels(states) -> np.ndarray:
    """(W, 84, 84) bool: pixel centres within EDGE of any disk's edge, in
    float64."""
    c = (np.arange(84) + 0.5) / 84.0
    disks = [(states.exit_pos, jss.EXIT_RADIUS),
             (states.coin_pos, jss.COIN_RADIUS),
             (states.pos, jss.AGENT_RADIUS)] + [
        (np.asarray(states.spot_pos)[:, i], jss.SPOT_RADIUS)
        for i in range(N_SPOTS)]
    edge = np.zeros((len(states.pos), 84, 84), bool)
    for centre, radius in disks:
        centre = np.asarray(centre, np.float64)
        dist = np.sqrt((c[None, None, :] - centre[:, 0, None, None]) ** 2
                       + (c[None, :, None] - centre[:, 1, None, None]) ** 2)
        edge |= np.abs(dist - radius) < EDGE
    return edge


def assert_obs_match(got, want, states) -> int:
    """Observations equal off the disks' edges; returns the number of
    differing pixels (all on an edge)."""
    differ = (_np(got) != _np(want)).any(-1)
    assert not (differ & ~_edge_pixels(states)).any()
    return int(differ.sum())


def test_factory_and_configs():
    for raw, damage in ((SEARING_SPOTLIGHTS, 0.0),
                        (SEARING_SPOTLIGHTS_SHAPED, -0.01)):
        cfg = config_from_dict(raw)
        env = create_env(cfg.environment, 4, "cpu")
        assert isinstance(env, SearingSpotlightsEnv) and env.n_workers == 4
        assert env.observation_shape == (84, 84, 3)
        assert env.action_branches == (3, 3)
        assert env.max_episode_steps == 256 and env.r_damage == damage
    draws = env.sample_reset_draws(torch.Generator().manual_seed(0))
    assert (draws.pos >= 0.15).all() and (draws.pos < 0.85).all()
    assert (draws.coin >= 0.1).all() and (draws.exit < 0.9).all()
    assert draws.spots.shape == draws.targets.shape == (4, N_SPOTS, 2)
    step = env.sample_step_draws(torch.Generator().manual_seed(0))
    assert step.shape == (4, N_SPOTS, 2)
    # The host type goes to the process pool, which needs memory-gym, as in
    # the JAX package.
    with pytest.raises(ImportError, match="memory-gym"):
        create_env(EnvConfig(type="SearingSpotlights-host"), 4, "cpu")


def test_steps_without_draws_consume_no_generator_state():
    """Only an env that draws in its step takes from the generator there."""
    from etmppo_tpu_torch.envs.mystery_path import MysteryPathGridEnv
    gen = torch.Generator().manual_seed(0)
    before = gen.get_state()
    assert MysteryPathGridEnv({}, 2, "cpu").sample_step_draws(gen) is None
    assert torch.equal(gen.get_state(), before)
    env = SearingSpotlightsEnv({}, 2, "cpu")
    with pytest.raises(ValueError, match="step draws"):
        env.step(env.reset(env.sample_reset_draws(gen))[0],
                 torch.ones(2, 2, dtype=torch.int64))


@pytest.mark.parametrize("params", list(PARAMS))
def test_steps_match(params):
    """256 steps of random actions with JAX's auto-reset where done, each
    step from JAX's state and with its target draws."""
    p = PARAMS[params]
    jenv = jss.SearingSpotlightsEnv(p)
    env = SearingSpotlightsEnv(p, W, "cpu")
    reset = jax.jit(jax.vmap(jenv.reset))
    step = jax.jit(jax.vmap(jenv.step))
    jstate, jobs = reset(jax.random.split(jax.random.PRNGKey(0), W))
    state, obs = env.reset(_draws(jstate))
    for name in state._fields:
        np.testing.assert_array_equal(getattr(state, name).numpy(),
                                      _np(getattr(jstate, name)),
                                      err_msg=name)
    flips = assert_obs_match(obs, jobs, jstate)
    rng = np.random.default_rng(0)
    seen = dict(coin=False, exit=False, hit=False, death=False, limit=False,
                retarget=False)
    for t in range(256):
        actions = rng.integers(0, 3, (W, 2))
        keys = jax.random.split(jax.random.PRNGKey(100 + t), W)
        jnext, jobs, jrew, jdone, jinfo = step(jstate, jnp.asarray(actions),
                                               keys)
        state, obs, rew, done, info = env.step(
            _torch_state(jstate), torch.as_tensor(actions),
            torch.as_tensor(_np(_step_draws(keys))))
        for name in state._fields:
            np.testing.assert_allclose(getattr(state, name).numpy(),
                                       _np(getattr(jnext, name)), rtol=1e-6,
                                       err_msg=name)
        np.testing.assert_array_equal(rew.numpy(), _np(jrew))
        np.testing.assert_array_equal(done.numpy(), _np(jdone))
        for k in env.info_keys:
            np.testing.assert_array_equal(info[k].numpy(), _np(jinfo[k]))
        flips += assert_obs_match(obs, jobs, jnext)
        d = _np(jdone)
        seen["coin"] |= bool((_np(jnext.coin_collected)
                              & ~_np(jstate.coin_collected)).any())
        seen["exit"] |= bool((d & (_np(jinfo["success"]) == 1)).any())
        seen["hit"] |= bool((_np(jnext.health) < _np(jstate.health)).any())
        seen["death"] |= bool((d & (_np(jnext.health) <= 0)).any())
        seen["limit"] |= bool((d & (_np(jnext.t) == 256)).any())
        seen["retarget"] |= bool((_np(jnext.spot_target)
                                  != _np(jstate.spot_target)).any())
        rstate, _ = reset(jax.random.split(jax.random.PRNGKey(1000 + t), W))
        jstate = jax.tree.map(
            lambda new, old: jnp.where(
                jnp.asarray(d).reshape((W,) + (1,) * (old.ndim - 1)), new,
                old), rstate, jnext)
    # on the edge only, and rare: 6 of the 87 million pixels (yaml, shaped)
    assert flips <= 64, flips
    want = ("coin", "exit", "hit", "death", "retarget") + (
        () if params == "deadly" else ("limit",))
    assert all(seen[k] for k in want), seen


def test_coin_and_exit_in_one_step():
    """Workers placed on the coin, with the exit beside it, collect the coin
    and leave in their first step: reward_coin + reward_exit, success."""
    n = 4
    jenv = jss.SearingSpotlightsEnv({})
    env = SearingSpotlightsEnv({}, n, "cpu")
    pos = np.random.default_rng(1).uniform(0.3, 0.7, (n, 2)).astype(
        np.float32)
    draws = SearingSpotlightsResetDraws(
        pos=torch.as_tensor(pos), coin=torch.as_tensor(pos),
        exit=torch.as_tensor(pos + np.float32(0.05)),
        spots=torch.zeros(n, N_SPOTS, 2), targets=torch.zeros(n, N_SPOTS, 2))
    state, _ = env.reset(draws)
    jstate = jss.SearingSpotlightsState(*(jnp.asarray(_np(x)) for x in state))
    actions = np.ones((n, 2), np.int64)          # stand still
    keys = jax.random.split(jax.random.PRNGKey(0), n)
    _, _, jrew, jdone, jinfo = jax.vmap(jenv.step)(jstate,
                                                   jnp.asarray(actions), keys)
    _, _, rew, done, info = env.step(state, torch.as_tensor(actions),
                                     torch.as_tensor(_np(_step_draws(keys))))
    np.testing.assert_array_equal(rew.numpy(), _np(jrew))
    np.testing.assert_array_equal(done.numpy(), _np(jdone))
    np.testing.assert_array_equal(info["success"].numpy(),
                                  _np(jinfo["success"]))
    assert done.all() and (info["success"] == 1).all()
    assert torch.equal(rew, torch.full((n,), 1.25))


# --- rollout against JAX's ---------------------------------------------


def _jax_rng_chain(n, steps):
    """The reset and step keys of JAX's RolloutFn from
    ``init_state(PRNGKey(1))``: the initial reset's keys, then per step
    ``split(rng, 4)`` -> (rng, action, step, reset)."""
    rng, reset_rng = jax.random.split(jax.random.PRNGKey(1))
    resets, step_keys = [jax.random.split(reset_rng, n)], []
    for _ in range(steps):
        rng, _, step_rng, reset_rng = jax.random.split(rng, 4)
        step_keys.append(jax.random.split(step_rng, n))
        resets.append(jax.random.split(reset_rng, n))
    return resets, step_keys


class _InjectedRollout(RolloutFn):
    """The port's rollout with JAX's actions, step draws and reset draws."""

    def __init__(self, *args, actions, reset_draws, step_draws):
        super().__init__(*args, generator=None)
        self.actions = actions
        self._resets = iter(reset_draws)
        self._steps = iter(step_draws)
        self.t0 = 0

    def reset_draws(self):
        return next(self._resets)

    def step_draws(self):
        return next(self._steps)

    def sample_actions(self, logits, step):
        a = self.actions[:, self.t0 + step]
        return a, torch.stack([distributions.log_prob(l, a[:, i])
                               for i, l in enumerate(logits)], dim=-1)


def test_rollout_matches_jax():
    """Two rollouts of 48 steps, 3 workers: the second carries memory in."""
    T, rollouts, n = 48, 2, 3
    cfg = jax_load_config("etmppo_tpu/configs/searing_spotlights_shaped.yaml")
    trx = dataclasses.replace(cfg.transformer, num_blocks=2, embed_dim=32,
                              memory_length=8)
    jcfg = dataclasses.replace(cfg, n_workers=n, worker_steps=T,
                               hidden_layer_size=32, transformer=trx)
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
    env = create_env(tcfg.environment, n, "cpu")
    model = ActorCriticModel(tcfg, env.observation_shape, env.action_branches,
                             env.max_episode_steps, device="cpu")
    load_flax_params(model, params)
    reset = jax.jit(jax.vmap(jenv.reset))
    resets, step_keys = _jax_rng_chain(n, rollouts * T)
    fn = _InjectedRollout(
        tcfg, env, model,
        actions=torch.cat([torch.as_tensor(_np(b.actions)).long()
                           for b in jbatches], dim=1),
        reset_draws=[_draws(reset(k)[0]) for k in resets],
        step_draws=[torch.as_tensor(_np(_step_draws(k))) for k in step_keys])
    state = fn.init_state()
    for r, jb in enumerate(jbatches):
        fn.t0 = r * T
        state, tb = fn(state)
        np.testing.assert_array_equal(tb.episode_steps.numpy(),
                                      _np(jb.episode_steps))
        np.testing.assert_array_equal(tb.dones.numpy(), _np(jb.dones))
        np.testing.assert_array_equal(tb.obs.numpy(), _np(jb.obs))
        for name in ("values", "log_probs", "tape", "snapshot", "advantages"):
            np.testing.assert_allclose(getattr(tb, name).numpy(),
                                       _np(getattr(jb, name)), rtol=1e-4,
                                       atol=1e-4, err_msg=name)
    np.testing.assert_array_equal(state.env_state.spot_target.numpy(),
                                  _np(jstate.env_state.spot_target))
    assert _np(jbatches[1].snapshot).any()
