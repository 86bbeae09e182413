"""etmppo_tpu_torch's evaluation protocol against the JAX package's.

* ``interquartile_mean`` and ``stratified_bootstrap_ci`` are numpy only and
  copied: they must give the same bits.
* ``evaluate_params`` and ``evaluate_protocol`` match JAX per episode on a
  tiny PocMemory model saved by the JAX package and on the committed
  MiniGrid flagship (8 episodes). JAX's and PyTorch's generators differ, so
  both sides sample the argmax (the test swaps JAX's ``sample_multi`` and
  the port's ``Evaluation.sample_actions``), and the port's resets are handed
  the values the JAX resets drew, read back from the JAX states. Neither
  env draws in its step. Lengths and successes must be equal, rewards agree
  to rtol 1e-6: MiniGrid's reward divides by a constant, which XLA may turn
  into a multiplication by its reciprocal (one float32 ulp).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from etmppo_tpu import evaluate as jax_evaluate
from etmppo_tpu.config import load_config
from etmppo_tpu.envs.factory import create_env as jax_create_env
from etmppo_tpu.envs.minigrid_memory import KEY
from etmppo_tpu.models.actor_critic import ActorCriticModel as JModel
from etmppo_tpu.ops import distributions as jax_distributions
from etmppo_tpu.training.checkpoint import load_model as jax_load_model
from etmppo_tpu.training.checkpoint import save_model
from etmppo_tpu_torch import evaluate
from etmppo_tpu_torch.envs.minigrid_memory import MinigridResetDraws
from etmppo_tpu_torch.envs.poc_memory import (PocMemoryEnv,
                                              PocMemoryResetDraws)
from etmppo_tpu_torch.training.checkpoint import load_model

torch.set_num_threads(1)

FLAGSHIP = "models/minigrid-r3_s0.nn"


@pytest.mark.parametrize("n", [1, 3, 4, 50, 101, 1250])
def test_iqm_is_bit_equal(n):
    values = np.random.default_rng(n).normal(size=n)
    assert evaluate.interquartile_mean(values) == \
        jax_evaluate.interquartile_mean(values)


@pytest.mark.parametrize("seeds", [1, 2, 5])
def test_bootstrap_ci_is_bit_equal(seeds):
    rng = np.random.default_rng(seeds)
    per_seed = [rng.normal(loc=1.0, size=50 + 7 * i) for i in range(seeds)]
    got = evaluate.stratified_bootstrap_ci(per_seed, n_boot=300, seed=3)
    assert got == jax_evaluate.stratified_bootstrap_ci(per_seed, n_boot=300,
                                                       seed=3)


def _jax_argmax(key, logits):
    actions = jnp.stack([jnp.argmax(lg, axis=-1) for lg in logits], axis=-1)
    return actions.astype(jnp.int32), jnp.zeros(actions.shape)


def _port_argmax(self, logits, step):
    return torch.stack([lg.argmax(dim=-1) for lg in logits],
                       dim=-1).to(torch.int32)


def _jax_draws(self):
    """The values JAX's evaluation resets drew (``env_seed`` split into one
    key per episode), read back from its states, as the port's draws."""
    jenv = jax_create_env(self.config.environment)
    keys = jax.random.split(jax.random.PRNGKey(self.env_seed), self.episodes)
    states, _ = jax.vmap(jenv.reset)(keys)
    if self.config.environment.type == "PocMemoryEnv":
        start = np.searchsorted(self.env.start_ticks.numpy(),
                                np.asarray(states.ticks))
        return PocMemoryResetDraws(
            torch.as_tensor(start).long(),
            torch.as_tensor(np.asarray(states.goals)[:, 0] == 1.0))
    grid = np.asarray(states.grid)
    (cue_x, cue_y), (top_x, top_y) = jenv._cue, jenv._obj_top
    return MinigridResetDraws(
        start_x=torch.tensor(np.asarray(states.pos)[:, 0], dtype=torch.int64),
        cue_is_key=torch.as_tensor(grid[:, cue_y, cue_x] == KEY),
        top_is_key=torch.as_tensor(grid[:, top_y, top_x] == KEY))


@pytest.fixture
def argmax_both(monkeypatch):
    monkeypatch.setattr(jax_distributions, "sample_multi", _jax_argmax)
    monkeypatch.setattr(evaluate.Evaluation, "sample_actions", _port_argmax)
    monkeypatch.setattr(evaluate.Evaluation, "reset_draws", _jax_draws)


def _tiny_models(directory, n):
    cfg = load_config("etmppo_tpu/configs/poc_memory_env.yaml")
    cfg = dataclasses.replace(
        cfg, hidden_layer_size=16,
        transformer=dataclasses.replace(
            cfg.transformer, num_blocks=2, embed_dim=16, num_heads=2,
            memory_length=8))
    env = jax_create_env(cfg.environment)
    model = JModel(config=cfg, obs_shape=env.observation_shape,
                   action_branches=env.action_branches,
                   max_episode_steps=env.max_episode_steps)
    paths = []
    for s in range(n):
        path = str(directory / f"seed{s}.nn")
        save_model(path, model.init_params(jax.random.PRNGKey(s)), cfg)
        paths.append(path)
    return paths


def _assert_episodes_equal(got, want):
    assert set(got) == set(want)
    for key in ("length", "success"):
        np.testing.assert_array_equal(got[key], np.asarray(want[key]),
                                      err_msg=key)
    np.testing.assert_allclose(got["reward"], np.asarray(want["reward"]),
                               rtol=1e-6, atol=0)


@pytest.mark.parametrize("path", ["tiny", FLAGSHIP])
def test_evaluate_params_matches_jax(path, tmp_path, argmax_both):
    if path == "tiny":
        path = _tiny_models(tmp_path, 1)[0]
    episodes = 8
    params, jconfig = jax_load_model(path)
    want = jax_evaluate.evaluate_params(params, jconfig, episodes, seed=1,
                                        env_seed=5)
    model, config = load_model(path, "cpu")
    got = evaluate.evaluate_params(model, config, episodes, seed=1,
                                   env_seed=5)
    _assert_episodes_equal(got, want)
    assert (got["length"] >= 1).all()


def test_evaluate_protocol_matches_jax(tmp_path, argmax_both, capsys):
    paths = _tiny_models(tmp_path, 2)
    kw = dict(episodes=4, repeats=2, seed=7, n_boot=50)
    per_seed, aggregate = evaluate.evaluate_protocol(paths, device="cpu", **kw)
    want_per_seed, want_aggregate = jax_evaluate.evaluate_protocol(paths, **kw)
    for path in paths:
        _assert_episodes_equal(per_seed[path], want_per_seed[path])
        assert per_seed[path]["length"].shape == (8,)
    assert set(aggregate) == set(want_aggregate)
    for key in ("length", "success"):
        assert aggregate[key] == want_aggregate[key]
    np.testing.assert_allclose(aggregate["reward"], want_aggregate["reward"],
                               rtol=1e-6)
    assert evaluate.evaluate_model(paths[0], 4, seed=7, repeats=2,
                                   device="cpu") == pytest.approx(
        jax_evaluate.evaluate_model(paths[0], 4, seed=7, repeats=2),
        rel=1e-6)
    evaluate.main([f"--model={','.join(paths)}", "--episodes=2", "--cpu"])
    out = capsys.readouterr().out
    assert "# 2 training seeds x 2 env seeds x 1 repeats" in out
    assert "success: " in out and "[" in out


def test_unfinished_episodes_raise(tmp_path, monkeypatch):
    """An episode still running at max_episode_steps is an error."""
    model, config = load_model(_tiny_models(tmp_path, 1)[0], "cpu")
    step = PocMemoryEnv.step

    def never_done(self, *args, **kwargs):
        state, obs, reward, done, info = step(self, *args, **kwargs)
        return state, obs, reward, torch.zeros_like(done), info
    monkeypatch.setattr(PocMemoryEnv, "step", never_done)
    with pytest.raises(RuntimeError, match="must terminate"):
        evaluate.evaluate_params(model, config, 4, seed=0)


def test_evaluate_needs_a_gpu_by_default(tmp_path, monkeypatch):
    path = _tiny_models(tmp_path, 1)[0]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        evaluate.evaluate_model(path, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        evaluate.main([f"--model={path}", "--episodes=2"])
