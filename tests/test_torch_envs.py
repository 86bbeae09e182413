"""etmppo_tpu_torch MiniGrid-Memory vs the JAX package's env.

JAX's and PyTorch's generators differ, so the port's resets are handed the
values the JAX resets drew (start column, cue object, top object), and both
envs get the same actions. Observations, rewards, dones and episode infos
must then be equal step by step: the env is integer logic plus sprite
lookups. The reward is the same float32 expression on both sides, but XLA
may turn its division by a constant into a multiplication by the
reciprocal, so rewards and returns agree to one float32 ulp (rtol 1e-6).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from etmppo_tpu.envs.minigrid_memory import (
    KEY, MinigridMemoryEnv as JEnv, _process_vis_3x3)
from etmppo_tpu_torch.config import EnvConfig
from etmppo_tpu_torch.envs.core import select_state
from etmppo_tpu_torch.envs.factory import create_env
from etmppo_tpu_torch.envs.minigrid_memory import (
    FLOOR, UNSEEN, WALL, MinigridMemoryEnv, MinigridResetDraws,
    _visibility_table)

torch.set_num_threads(1)


def _jax_resets(env, seeds):
    keys = jnp.stack([jax.random.PRNGKey(s) for s in seeds])
    return jax.vmap(env.reset)(keys)


def _draws_of(env, states) -> MinigridResetDraws:
    """The values a JAX reset drew, read back from the states it made."""
    grid = np.asarray(states.grid)
    cue_x, cue_y = env._cue
    top_x, top_y = env._obj_top
    return MinigridResetDraws(
        start_x=torch.tensor(np.asarray(states.pos)[:, 0], dtype=torch.int64),
        cue_is_key=torch.as_tensor(grid[:, cue_y, cue_x] == KEY),
        top_is_key=torch.as_tensor(grid[:, top_y, top_x] == KEY))


def test_visibility_table_matches_process_vis():
    views = np.array([[FLOOR if not (p >> k) & 1 else WALL for k in range(9)]
                      for p in range(512)], np.int32).reshape(512, 3, 3)
    jax_seen = np.asarray(jax.vmap(_process_vis_3x3)(jnp.asarray(views)))
    table = _visibility_table()
    np.testing.assert_array_equal(table, jax_seen != UNSEEN)


@pytest.mark.parametrize("name", ["MiniGrid-MemoryS9-v0",
                                  "MiniGrid-MemoryS7-v0"])
def test_reset_matches(name):
    jenv = JEnv(name)
    tenv = MinigridMemoryEnv(name, n_workers=12, device="cpu")
    jstates, jobs = _jax_resets(jenv, range(12))
    tstate, tobs = tenv.reset(_draws_of(jenv, jstates))
    np.testing.assert_array_equal(tobs.numpy(), np.asarray(jobs))
    np.testing.assert_array_equal(tstate.grid.numpy(), np.asarray(jstates.grid))
    np.testing.assert_array_equal(tstate.pos.numpy(), np.asarray(jstates.pos))
    np.testing.assert_array_equal(tstate.success_pos.numpy(),
                                  np.asarray(jstates.success_pos))
    np.testing.assert_array_equal(tstate.failure_pos.numpy(),
                                  np.asarray(jstates.failure_pos))


def _scripted_actions(jenv, jstates, steps, seed):
    """Worker 0 walks to the matching object, worker 1 to the other one,
    worker 2 spins until the 96-step limit, the rest act at random."""
    W = jstates.pos.shape[0]
    rng = np.random.default_rng(seed)
    acts = rng.choice(3, size=(steps, W), p=[0.2, 0.2, 0.6])
    success_top = np.asarray(jstates.success_pos)[:, 1] < jenv.size // 2
    for w, to_success in ((0, True), (1, False)):
        top = success_top[w] == to_success
        plan = [2] * 10 + [0 if top else 1] + [2] * 2
        acts[:len(plan), w] = plan
    if W > 2:
        acts[:, 2] = 0
    return acts.astype(np.int32)


@pytest.mark.parametrize("name,seed", [("MiniGrid-MemoryS9-v0", 0),
                                       ("MiniGrid-MemoryS9-v0", 1),
                                       ("MiniGrid-MemoryS7-v0", 2)])
def test_steps_match(name, seed):
    W, steps = 8, 110
    jenv = JEnv(name)
    tenv = MinigridMemoryEnv(name, n_workers=W, device="cpu")
    jstate, _ = _jax_resets(jenv, range(100 * seed, 100 * seed + W))
    tstate, _ = tenv.reset(_draws_of(jenv, jstate))
    acts = _scripted_actions(jenv, jstate, steps, seed)
    jstep = jax.jit(jax.vmap(jenv.step))
    keys = jnp.stack([jax.random.PRNGKey(0)] * W)
    seen = {"success": 0, "failure": 0, "limit": 0}
    for t in range(steps):
        a = acts[t][:, None]
        jstate, jobs, jr, jd, jinfo = jstep(jstate, jnp.asarray(a), keys)
        tstate, tobs, tr, td, tinfo = tenv.step(tstate, torch.as_tensor(a))
        np.testing.assert_array_equal(tobs.numpy(), np.asarray(jobs))
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-6)
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        for k in jenv.info_keys:
            np.testing.assert_allclose(tinfo[k].numpy(), np.asarray(jinfo[k]),
                                       rtol=1e-6, err_msg=k)
        first = np.asarray(jstate.step_count) == t + 1
        done = np.asarray(jd) & first
        success = np.asarray(jinfo["success"]) == 1
        limit = np.asarray(jstate.step_count) == 96
        seen["success"] += int((done & success).sum())
        seen["failure"] += int((done & ~success & ~limit).sum())
        seen["limit"] += int((done & limit).sum())
    # the script reaches every way an episode can end
    assert min(seen.values()) >= 1, seen


def test_episode_ends_on_wrong_side_with_zero_reward():
    jenv = JEnv("MiniGrid-MemoryS9-v0")
    tenv = MinigridMemoryEnv("MiniGrid-MemoryS9-v0", n_workers=2, device="cpu")
    jstate, _ = _jax_resets(jenv, [5, 6])
    state, _ = tenv.reset(_draws_of(jenv, jstate))
    acts = _scripted_actions(jenv, jstate, 13, 0)
    total = torch.zeros(2)
    for t in range(13):
        state, _, r, d, info = tenv.step(state, torch.as_tensor(acts[t][:, None]))
        total += r
        if d.all():
            break
    assert d.all()
    assert total[0] > 0 and info["success"][0] == 1.0
    assert total[1] == 0 and info["success"][1] == 0.0


def test_select_state_picks_per_worker():
    env = MinigridMemoryEnv("MiniGrid-MemoryS9-v0", n_workers=3, device="cpu")
    gen = torch.Generator().manual_seed(0)
    a, _ = env.reset(env.sample_reset_draws(gen))
    b, _ = env.reset(env.sample_reset_draws(gen))
    b = b._replace(step_count=b.step_count + 5)
    mixed = select_state(torch.tensor([True, False, True]), b, a)
    assert mixed.step_count.tolist() == [5, 0, 5]
    assert torch.equal(mixed.grid[1], a.grid[1])


def test_reset_draws_cover_the_layouts():
    env = MinigridMemoryEnv("MiniGrid-MemoryS9-v0", n_workers=256, device="cpu")
    draws = env.sample_reset_draws(torch.Generator().manual_seed(0))
    assert set(draws.start_x.tolist()) == set(range(1, 7))
    assert draws.cue_is_key.any() and (~draws.cue_is_key).any()
    assert draws.top_is_key.any() and (~draws.top_is_key).any()


def test_factory():
    env = create_env(EnvConfig(type="Minigrid", name="MiniGrid-MemoryS9-v0"),
                     4, "cpu")
    assert env.observation_shape == (84, 84, 3) and env.n_workers == 4
    assert env.action_branches == (3,) and env.max_episode_steps == 96
    # The host type goes to the process pool, which needs gym-minigrid, as
    # in the JAX package.
    with pytest.raises(ImportError, match="gym-minigrid"):
        create_env(EnvConfig(type="Minigrid-host"), 4, "cpu")
