"""etmppo_tpu_torch's PolicyServer against the JAX package's.

A tiny PocMemory model saved by the JAX package (as tests/test_serve.py
builds it, with no and with relative positional encoding) is loaded by both
servers (``greedy=True``), which get the same numpy-seeded observations,
resets, inactive masks and exhausted streams through ``step``,
``step_device`` and ``step_many``. Actions and step counters must be equal
and values agree to rtol 1e-4, atol 1e-5 (float32 sums in another order),
the frozen streams' values included: JAX clamps their window and their PE
slot implicitly, the port explicitly. Sampling draws from the same logits as
the raw-memory path (``model.forward`` over ``memory[index_table[t]]``), and
validation raises where JAX's does. One case runs the committed MiniGrid
flagship at full width.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax

from etmppo_tpu.config import load_config
from etmppo_tpu.envs.factory import create_env as jax_create_env
from etmppo_tpu.models.actor_critic import ActorCriticModel as JModel
from etmppo_tpu.serve import PolicyServer as JServer
from etmppo_tpu.training.checkpoint import save_model
from etmppo_tpu_torch.ops import distributions
from etmppo_tpu_torch.ops.memory_index import (build_memory_indices,
                                               build_memory_mask)
from etmppo_tpu_torch.serve import PolicyServer
from etmppo_tpu_torch.training.checkpoint import load_model

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5
FLAGSHIP = "models/minigrid-r3_s0.nn"


@pytest.fixture(scope="module", params=["", "relative"],
                ids=["pe-none", "pe-relative"])
def tiny_model(request, tmp_path_factory):
    cfg = load_config("etmppo_tpu/configs/poc_memory_env.yaml")
    cfg = dataclasses.replace(
        cfg, hidden_layer_size=16,
        transformer=dataclasses.replace(
            cfg.transformer, num_blocks=2, embed_dim=16, num_heads=2,
            memory_length=6, positional_encoding=request.param))
    env = jax_create_env(cfg.environment)
    model = JModel(config=cfg, obs_shape=env.observation_shape,
                   action_branches=env.action_branches,
                   max_episode_steps=env.max_episode_steps)
    params = model.init_params(jax.random.PRNGKey(0))
    path = str(tmp_path_factory.mktemp("serve") / "tiny.nn")
    save_model(path, params, cfg)
    return path, env


def _servers(path, M, **kw):
    jserver = JServer(path, max_streams=M, **kw)
    tserver = PolicyServer(path, max_streams=M, device="cpu", **kw)
    jserver.reset(range(M))
    tserver.reset(range(M))
    return jserver, tserver


def _same(j_out, t_out, jserver, tserver, where):
    (ja, jv), (ta, tv) = j_out, t_out
    np.testing.assert_array_equal(np.asarray(ta), np.asarray(ja), err_msg=where)
    np.testing.assert_allclose(np.asarray(tv), np.asarray(jv), rtol=RTOL,
                               atol=ATOL, err_msg=where)
    np.testing.assert_array_equal(tserver.steps, jserver.steps, err_msg=where)


def test_serve_matches_jax(tiny_model):
    """Resets, inactive masks, exhausted (frozen) streams, through all three
    step methods; the episode budget is 32 steps."""
    path, env = tiny_model
    M = 4
    max_ep = env.max_episode_steps
    jserver, tserver = _servers(path, M, greedy=True)
    rng = np.random.default_rng(7)
    shape = (M,) + tuple(env.observation_shape)

    def both(method, obs, **kw):
        out = [getattr(s, method)(obs, **kw) for s in (jserver, tserver)]
        _same(*out, jserver, tserver, f"{method} at {tserver.steps}")

    for t in range(10):
        active = None if t % 3 else np.array([True, t % 2 == 0, True, False])
        both("step", rng.normal(size=shape).astype(np.float32), active=active)
        if t == 5:
            jserver.reset([1, 3])
            tserver.reset([1, 3])
    # Streams 0, 2 and 3 reach the budget inside step_many and freeze there;
    # stream 1 sits out.
    active = np.array([True, False, True, True])
    both("step_many", rng.normal(size=(max_ep,) + shape).astype(np.float32),
         active=active)
    assert tserver.steps[0] == max_ep and tserver.steps[1] < max_ep
    for _ in range(3):
        both("step_device", rng.normal(size=shape).astype(np.float32))
    assert list(tserver.steps) == [max_ep, tserver.steps[1], max_ep, max_ep]
    for server in (jserver, tserver):
        with pytest.raises(ValueError, match="max_episode_steps"):
            server.step(np.zeros(shape, np.float32))
    both("step", rng.normal(size=shape).astype(np.float32),
         active=np.zeros(M, bool))
    jserver.reset(range(M))
    tserver.reset(range(M))
    both("step", rng.normal(size=shape).astype(np.float32))
    assert list(tserver.steps) == [1] * M


def _raw_path(model, config, max_ep, obs, memory, t):
    """The raw-memory step of every stream at episode step ``t``."""
    L = config.transformer.memory_length
    M = obs.shape[0]
    indices = torch.as_tensor(build_memory_indices(max_ep, L)[t]).long()
    mask = torch.as_tensor(build_memory_mask(L)[min(t, L - 1)])
    with torch.no_grad():
        logits, value, new_memory = model(
            obs, memory[:, indices], mask.expand(M, L),
            indices.expand(M, L))
    memory[:, t] = new_memory
    return logits, value


def test_sampling_matches_raw_path(tiny_model):
    """``greedy=False`` samples the raw path's logits with a generator in
    the same state as the server's (seeded ``seed``, consumed once per
    step)."""
    path, env = tiny_model
    M, T, seed = 3, 8, 123
    server = PolicyServer(path, max_streams=M, greedy=False, seed=seed,
                          device="cpu")
    server.reset(range(M))
    model, config = load_model(path, "cpu")
    trx = config.transformer
    memory = torch.zeros(M, env.max_episode_steps, trx.num_blocks,
                         trx.embed_dim)
    generator = torch.Generator().manual_seed(seed)
    rng = np.random.default_rng(11)
    for t in range(T):
        obs = torch.as_tensor(rng.normal(
            size=(M,) + tuple(env.observation_shape)).astype(np.float32))
        logits, value = _raw_path(model, config, env.max_episode_steps, obs,
                                  memory, t)
        want, _ = distributions.sample_multi(logits, generator)
        actions, values = server.step(obs)
        np.testing.assert_array_equal(actions, want.numpy())
        np.testing.assert_allclose(values, value.numpy(), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("case", ["obs shape", "active shape", "id too high",
                                  "id negative", "step_many shape",
                                  "step_many active"])
def test_validation_raises_where_jax_does(tiny_model, case):
    path, env = tiny_model
    M = 3
    shape = (M,) + tuple(env.observation_shape)
    for server in _servers(path, M, greedy=True):
        call = {
            "obs shape": lambda: server.step(np.zeros((M + 1,) + shape[1:])),
            "active shape": lambda: server.step(np.zeros(shape),
                                                active=[True]),
            "id too high": lambda: server.reset([M]),
            "id negative": lambda: server.reset([-1]),
            "step_many shape": lambda: server.step_many(np.zeros(shape)),
            "step_many active": lambda: server.step_many(
                np.zeros((2,) + shape), active=[True, False]),
        }[case]
        with pytest.raises(ValueError):
            call()


def test_flagship_matches_jax():
    """The committed MiniGrid flagship (CNN on 84x84x3, TrXL 3 x 384,
    memory 64) at full width: 2 streams, 4 steps."""
    M = 2
    jserver, tserver = _servers(FLAGSHIP, M, greedy=True)
    rng = np.random.default_rng(3)
    for t in range(4):
        obs = rng.uniform(size=(M,) + tuple(tserver.observation_shape)
                          ).astype(np.float32)
        _same(jserver.step(obs), tserver.step(obs), jserver, tserver,
              f"step {t}")


def test_server_needs_a_gpu_by_default(tiny_model, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PolicyServer(tiny_model[0])
