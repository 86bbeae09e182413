"""etmppo_tpu_torch's batched Mystery Path Grid vs the JAX package's env.

The port is handed the reset draws that JAX's ``_generate_path`` takes from
its keys (the edge, the starting lateral cell and the walk's moves), so both
build the same paths; observations, rewards, dones, infos and states are then
compared exactly over random actions and over walks along the path to the
goal. Every value is an integer or a float32 constant, so there is no
tolerance.
"""
import collections

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from etmppo_tpu.config import load_config as jax_load_config
from etmppo_tpu.envs.mystery_path import MysteryPathGridEnv as JEnv
from etmppo_tpu_torch.config import EnvConfig, MYSTERY_PATH_GRID, config_from_dict
from etmppo_tpu_torch.envs.factory import create_env
from etmppo_tpu_torch.envs.mystery_path import (MOVE_OFFSETS,
                                                MysteryPathGridEnv,
                                                MysteryPathResetDraws)

torch.set_num_threads(1)

W = 16
PARAMS = {
    "flagship": jax_load_config(
        "etmppo_tpu/configs/mystery_path_grid.yaml").environment.reset_params,
    "shown_and_rewarded": {"arena_size": 9, "cardinal_origin_choice": [1, 3],
                           "show_origin": True, "show_goal": True,
                           "reward_fall_off": -0.1,
                           "reward_path_progress": 0.05},
}


def _jax_draws(env: JEnv, keys) -> MysteryPathResetDraws:
    """The values ``_generate_path`` draws from each key."""
    S = env.size

    def one(key):
        k_edge, k_start, k_walk = jax.random.split(key, 3)
        edge = jax.random.choice(
            k_edge, jnp.asarray(env.origin_choices, jnp.int32))
        lateral0 = jax.random.randint(k_start, (), 0, S)
        moves = jax.vmap(lambda k: jax.random.choice(
            k, jnp.asarray([0, 1, 2]), p=jnp.asarray([0.5, 0.25, 0.25])))(
                jax.random.split(k_walk, env.max_path_len - 1))
        return edge, lateral0, moves

    return MysteryPathResetDraws(
        *(torch.tensor(np.asarray(x)).long() for x in jax.vmap(one)(keys)))


def _assert_state_equal(jstate, tstate):
    for name, value in zip(tstate._fields, tstate):
        np.testing.assert_array_equal(value.numpy(),
                                      np.asarray(getattr(jstate, name)),
                                      err_msg=name)


@pytest.fixture(scope="module", params=list(PARAMS))
def envs(request):
    jenv = JEnv(PARAMS[request.param])
    tenv = MysteryPathGridEnv(PARAMS[request.param], W, "cpu")
    keys = jax.random.split(jax.random.PRNGKey(7), W)
    jstate, jobs = jax.jit(jax.vmap(jenv.reset))(keys)
    tstate, tobs = tenv.reset(_jax_draws(jenv, keys))
    return jenv, tenv, jstate, jobs, tstate, tobs


def test_reset_matches(envs):
    _, _, jstate, jobs, tstate, tobs = envs
    _assert_state_equal(jstate, tstate)
    np.testing.assert_array_equal(tobs.numpy(), np.asarray(jobs))


def _step_both(jenv, tenv, jstate, tstate, actions):
    step = jax.jit(jax.vmap(jenv.step))
    keys = jax.random.split(jax.random.PRNGKey(0), W)
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
    _assert_state_equal(jstate, tstate)
    return jstate, tstate


def test_random_steps_match_past_the_step_cap(envs):
    """130 random steps: falls, feedback marks, progress and the 128-step
    cap."""
    jenv, tenv, jstate, _, tstate, _ = envs
    actions = np.random.default_rng(0).integers(0, 4, (W, 130))
    jstate, tstate = _step_both(jenv, tenv, jstate, tstate, actions)
    assert (tstate.t == 130).all() and (tstate.best_progress > 0).any()


def _path_actions(on_path, origin, goal):
    """Breadth-first moves along the path cells from origin to goal."""
    S = on_path.shape[0]
    start, end = tuple(origin), tuple(goal)
    prev = {start: None}
    queue = collections.deque([start])
    while queue:
        cell = queue.popleft()
        for a, (dx, dy) in enumerate(MOVE_OFFSETS):
            nxt = (cell[0] + dx, cell[1] + dy)
            if (0 <= nxt[0] < S and 0 <= nxt[1] < S and on_path[nxt[1], nxt[0]]
                    and nxt not in prev):
                prev[nxt] = (cell, a)
                queue.append(nxt)
    actions = []
    cell = end
    while prev[cell] is not None:
        cell, a = prev[cell]
        actions.append(a)
    return actions[::-1]


def test_walking_the_path_reaches_the_goal(envs):
    """Each worker follows its path, so every worker ends with success and
    reward_goal; workers that arrive early keep stepping in place."""
    jenv, tenv, jstate, _, tstate, _ = envs
    on_path = tstate.on_path.numpy()
    routes = [_path_actions(on_path[w], tstate.origin[w].numpy(),
                            tstate.goal[w].numpy()) for w in range(W)]
    n = max(map(len, routes))
    actions = np.zeros((W, n), np.int64)
    for w, route in enumerate(routes):
        actions[w, :len(route)] = route
        # after the goal: move back and forth along the last step
        back = (route[-1] + 2) % 4
        actions[w, len(route):] = [back, route[-1]] * ((n - len(route)) // 2) \
            + [back] * ((n - len(route)) % 2)
    step = jax.jit(jax.vmap(jenv.step))
    keys = jax.random.split(jax.random.PRNGKey(0), W)
    success = np.zeros(W, bool)
    for t in range(n):
        a = actions[:, t:t + 1]
        jstate, _, jr, _, ji = step(jstate, jnp.asarray(a), keys)
        tstate, _, tr, td, ti = tenv.step(tstate, torch.as_tensor(a))
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
        np.testing.assert_array_equal(ti["success"].numpy(),
                                      np.asarray(ji["success"]))
        arrived = np.array([t == len(r) - 1 for r in routes])
        assert (td.numpy()[arrived]).all()
        success |= ti["success"].numpy() > 0
    assert success.all()
    _assert_state_equal(jstate, tstate)


def test_sampled_draws_make_paths_across_the_arena():
    env = MysteryPathGridEnv(PARAMS["flagship"], 64, "cpu")
    draws = env.sample_reset_draws(torch.Generator().manual_seed(0))
    assert draws.moves.shape == (64, 3 * env.size - 1)
    assert set(draws.moves.unique().tolist()) <= {0, 1, 2}
    assert set(draws.edge.unique().tolist()) <= {0, 1, 2, 3}
    state, obs = env.reset(draws)
    assert obs.shape == (64, 84, 84, 3)
    S = env.size
    for w in range(64):
        o, g = state.origin[w].tolist(), state.goal[w].tolist()
        # the goal lies on the edge opposite the origin's
        assert abs(o[0] - g[0]) == S - 1 or abs(o[1] - g[1]) == S - 1
        assert _path_actions(state.on_path[w].numpy(), o, g)
        assert state.progress_idx[w, o[1], o[0]] == 0


def test_factory_builds_the_flagship_env():
    cfg = config_from_dict(MYSTERY_PATH_GRID)
    env = create_env(cfg.environment, 4, "cpu")
    assert isinstance(env, MysteryPathGridEnv)
    assert env.n_workers == 4 and env.observation_shape == (84, 84, 3)
    assert env.action_branches == (4,) and env.max_episode_steps == 128
    assert env.size == 7 and not env.show_goal and env.visual_feedback
    # The host type goes to the process pool, which needs memory-gym, as in
    # the JAX package.
    with pytest.raises(ImportError, match="memory-gym"):
        create_env(EnvConfig(type="MysteryPath-Grid-host"), 4, "cpu")


def test_reset_done_matches_the_jax_rollouts_auto_reset(envs):
    """64 random steps, each followed by the auto-reset: JAX's rollout
    resets every worker from its keys and keeps the reset where done (a
    ``where`` over the state and the frame); the port's ``reset_done`` is
    handed the draws of the same keys. The mask is done or'ed with a random
    fifth of the workers, so resets come at every step."""
    jenv, tenv, jstate, jobs, tstate, tobs = envs
    step = jax.jit(jax.vmap(jenv.step))
    reset = jax.jit(jax.vmap(jenv.reset))

    @jax.jit
    def keep(mask, new, old):
        return jax.tree.map(lambda a, b: jnp.where(
            mask.reshape((W,) + (1,) * (b.ndim - 1)), a, b), new, old)

    rng = np.random.default_rng(1)
    step_keys = jax.random.split(jax.random.PRNGKey(0), W)
    resets = 0
    for t in range(64):
        a = rng.integers(0, 4, (W, 1))
        jstate, jobs, _, jd, _ = step(jstate, jnp.asarray(a), step_keys)
        tstate, tobs, _, td, _ = tenv.step(tstate, torch.as_tensor(a))
        mask = np.asarray(jd) | (rng.random(W) < 0.2)
        keys = jax.random.split(jax.random.PRNGKey(1000 + t), W)
        jstate, jobs = keep(jnp.asarray(mask), reset(keys), (jstate, jobs))
        tstate, tobs = tenv.reset_done(torch.as_tensor(mask),
                                       _jax_draws(jenv, keys), tstate, tobs)
        np.testing.assert_array_equal(tobs.numpy(), np.asarray(jobs))
        resets += int(mask.sum())
    _assert_state_equal(jstate, tstate)
    assert resets > 64 * W // 8
