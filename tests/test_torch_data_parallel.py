"""Data parallelism in etmppo_tpu_torch on the CPU, with real 2-rank gloo
groups (``parallel.mesh.spawn``; the ranks run ``parallel.probe.train``):

* against the port on one device: the same seed gives the same rollout rows
  and, after two updates, the same stats and parameters to the tolerances of
  tests/test_torch_training.py; PocMemory with minibatches of 2 (some rank
  holds no sample of some minibatch) and MiniGrid's CNN path;
* against the JAX package's ``num_devices: 2`` run (its rollout and update
  on the conftest mesh, ``shard_worker_tree`` / ``replicate_tree``), the
  ranks handed JAX's draws and permutations;
* the checkpoint (one file, resumed at 2 ranks bit for bit and at 1
  device within tolerance), and the refusals.

The host env paths and the CLI: tests/test_torch_data_parallel_host.py.

Tolerances:

* ``ROWS_RTOL``/``ROWS_ATOL``: a rank computes its W/N rows where one device
  computes W; the CPU's matmuls and convolutions block by the batch's rows,
  so a forward differs in the last bit (about 1e-7 relative), which the
  memory carries through the rollout: values, log-probs and advantages
  agree to 1e-5 relative and 1e-6 absolute, the actions exactly.
* After the updates (tests/test_torch_training.py's full-update tolerances):
  stats to 1e-3 relative; every parameter within ``2 * lr`` per AdamW step
  (a noise-level gradient may change sign) and 99% of them within 1e-5.
* The ranks' parameters are bit-identical after every update.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from etmppo_tpu.config import ScheduleConfig
from etmppo_tpu.config import load_config as jax_load_config
from etmppo_tpu.envs.factory import create_env as jax_create_env
from etmppo_tpu.envs.minigrid_memory import KEY
from etmppo_tpu.models.actor_critic import ActorCriticModel as JModel
from etmppo_tpu.parallel.mesh import make_mesh as jax_make_mesh
from etmppo_tpu.parallel.mesh import replicate_tree as jax_replicate_tree
from etmppo_tpu.parallel.mesh import shard_worker_tree as jax_shard_tree
from etmppo_tpu.training import ppo as jppo
from etmppo_tpu.training.rollout import RolloutFn as JRolloutFn
from etmppo_tpu_torch.config import config_from_dict
from etmppo_tpu_torch.envs.minigrid_memory import MinigridResetDraws
from etmppo_tpu_torch.interop import flax_to_state_dict
from etmppo_tpu_torch.parallel import probe
from etmppo_tpu_torch.parallel.mesh import DataMesh, spawn
from etmppo_tpu_torch.training.host_rollout import HostRolloutFn
from etmppo_tpu_torch.training.ppo import STAT_NAMES
from etmppo_tpu_torch.training.trainer import PPOTrainer

torch.set_num_threads(1)

ROWS_RTOL, ROWS_ATOL = 1e-5, 1e-6
STATS_RTOL = 1e-3
LR, CLIP, BETA = 3e-4, 0.1, 0.001
FLOAT_ROWS = ("values", "log_probs", "advantages")
STAT_KEYS = STAT_NAMES
SPAWN = dict(device="cpu", timeout=300, collective_timeout=120)


def _constant(value):
    return {"initial": value, "final": value, "power": 1.0,
            "max_decay_steps": 1}


def _raw(tmp_path, **overrides):
    raw = dict(
        environment={"type": "PocMemoryEnv"}, updates=2, epochs=2,
        n_workers=4, worker_steps=8, n_mini_batch=16, hidden_layer_size=16,
        transformer={"num_blocks": 2, "embed_dim": 16, "num_heads": 2,
                     "memory_length": 4, "layer_norm": "pre", "gtrxl": True},
        learning_rate_schedule=_constant(LR), beta_schedule=_constant(BETA),
        clip_range_schedule=_constant(CLIP), num_devices=2,
        summary_dir=str(tmp_path / "summaries"),
        checkpoint_dir=str(tmp_path / "models"))
    raw.update(overrides)
    return raw


def _minigrid(tmp_path, **overrides):
    return _raw(tmp_path, **{**dict(
        environment={"type": "Minigrid", "name": "MiniGrid-MemoryS9-v0"},
        worker_steps=16, n_mini_batch=2, hidden_layer_size=32,
        transformer={"num_blocks": 2, "embed_dim": 32, "num_heads": 4,
                     "memory_length": 8, "positional_encoding": "relative",
                     "layer_norm": "post"},
        use_pallas_attention=True, pallas_backward=True), **overrides})


def _one_device(cfg):
    return dataclasses.replace(cfg, num_devices=1)


def _assert_replicated(ranks):
    for u, digest in enumerate(ranks[0]["digests"]):
        for r in ranks[1:]:
            assert torch.equal(r["digests"][u], digest), u
    for r in ranks[1:]:
        for u, params in enumerate(ranks[0]["params"]):
            for name, p in params.items():
                assert torch.equal(r["params"][u][name], p), (u, name)


def _assert_params_close(got, want, steps):
    diffs = np.concatenate([(got[n] - want[n]).abs().numpy().ravel()
                            for n in want])
    assert diffs.max() <= 2 * LR * steps
    assert np.quantile(diffs, 0.99) <= 1e-5


def _assert_rows(ranks, one, n_workers):
    """Each rank's batch rows against one device's rows of its workers."""
    per = n_workers // len(ranks)
    for r in ranks:
        rows = slice(r["rank"] * per, (r["rank"] + 1) * per)
        for name, got in r["batch"].items():
            want = one["batch"][name][rows]
            if name in FLOAT_ROWS:
                np.testing.assert_allclose(got.numpy(), want.numpy(),
                                           rtol=ROWS_RTOL, atol=ROWS_ATOL,
                                           err_msg=name)
            elif name != "margins":
                assert torch.equal(got, want), name


def _assert_stats(results, expected):
    for got, want in zip(results, expected, strict=True):
        for key in STAT_KEYS:
            np.testing.assert_allclose(got[key], want[key], rtol=STATS_RTOL,
                                       atol=1e-6, err_msg=key)


def _against_one_device(cfg):
    fields = ("actions", "dones", "episode_steps") + FLOAT_ROWS
    kwargs = dict(updates=cfg.updates, batch_fields=fields, threads=1)
    ranks = spawn(probe.train, 2, (cfg,), kwargs=kwargs, **SPAWN)
    one = probe.train(None, _one_device(cfg), **kwargs)
    _assert_replicated(ranks)
    _assert_rows(ranks, one, cfg.n_workers)
    steps = cfg.epochs * cfg.n_mini_batch
    for u in range(cfg.updates):
        _assert_params_close(ranks[0]["params"][u], one["params"][u],
                             steps * (u + 1))
        assert ranks[0]["results"][u] == ranks[1]["results"][u]
    _assert_stats(ranks[0]["results"], one["results"])
    return ranks, one


def test_two_ranks_match_one_device_with_empty_rank_minibatches(tmp_path):
    """PocMemory (the gathered-window loss) with global minibatches of 2
    samples: some rank holds no sample of some minibatch, launches nothing
    and adds zeros; the other holds both."""
    ranks, _ = _against_one_device(config_from_dict(_raw(tmp_path)))
    samples = np.array([r["rank_samples"] for r in ranks])  # rank, update, mb
    assert (samples.sum(axis=0) == 2).all()
    assert (samples == 0).any() and (samples == 1).any()


def test_two_ranks_match_one_device_on_the_cnn_path(tmp_path):
    """Counterpart of test_sharded_image_cnn_matches_single_device: MiniGrid
    (84x84x3 images, the conv encoder, post-LN TrXL with relative PE) on
    the window-attention loss, its kernel pair's plain versions on the
    CPU."""
    ranks, one = _against_one_device(config_from_dict(_minigrid(tmp_path)))
    for r in ranks:
        assert r["traffic"]["gradients"]["calls"] == 2 * 2 * 2
        assert r["traffic"]["advantages"]["calls"] == 2


# --- against the JAX package -------------------------------------------------


def _jax_reset_draws(env, W, rollouts, T):
    """The reset draws of JAX's RolloutFn (init_state(PRNGKey(1)), then
    split(rng, 4) per step), read back from the states they make (as
    tests/test_torch_training.py reads them)."""
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


def test_two_ranks_match_jax_num_devices_2(tmp_path):
    """JAX's rollout and update run on a 2-device mesh (the rollout state
    sharded by worker, the parameters replicated); the port's two ranks get
    JAX's parameters, reset draws, actions and permutations, each its rows.
    Rollout rows to tests/test_torch_training.py's rollout tolerance (1e-4),
    the update's stats and parameters to its full-update tolerances."""
    assert len(jax.devices()) >= 2
    base = jax_load_config("etmppo_tpu/configs/minigrid.yaml")
    jcfg = dataclasses.replace(
        base, updates=1, epochs=2, n_workers=4, worker_steps=16,
        n_mini_batch=2, hidden_layer_size=32, pallas_backward=False,
        transformer=dataclasses.replace(base.transformer, num_blocks=2,
                                        embed_dim=32, num_heads=4,
                                        memory_length=8),
        learning_rate_schedule=ScheduleConfig(LR, LR, 1.0, 1),
        beta_schedule=ScheduleConfig(BETA, BETA, 1.0, 1),
        clip_range_schedule=ScheduleConfig(CLIP, CLIP, 1.0, 1),
        num_devices=2, summary_dir=str(tmp_path), checkpoint_dir=str(tmp_path))
    cfg = config_from_dict(dataclasses.asdict(jcfg))
    W, T = jcfg.n_workers, jcfg.worker_steps
    env = jax_create_env(jcfg.environment)
    model = JModel(config=jcfg, obs_shape=env.observation_shape,
                   action_branches=env.action_branches,
                   max_episode_steps=env.max_episode_steps)
    params = model.init_params(jax.random.PRNGKey(0))
    mesh = jax_make_mesh(2)
    rollout_fn = JRolloutFn(jcfg, env, model)
    state = jax_shard_tree(rollout_fn.init_state(jax.random.PRNGKey(1)),
                           mesh, W)
    sharded_params = jax_replicate_tree(params, mesh)
    _, jbatch = rollout_fn(sharded_params, state)
    assert not jbatch.obs.sharding.is_fully_replicated
    jupdate = jppo.PPOUpdateFn(jcfg, model, env.max_episode_steps)
    rng = jax.random.PRNGKey(5)
    perms = np.stack([np.asarray(jax.random.permutation(k, W * T))
                      for k in jax.random.split(rng, jcfg.epochs)])
    copy = jax.tree.map(jnp.copy, sharded_params)
    j_new, _, j_stats, _ = jupdate(copy, jupdate.init_opt_state(copy),
                                   jbatch, rng, LR, CLIP, BETA)

    replay = probe.Replay(
        reset=_jax_reset_draws(env, W, 1, T),
        actions=torch.tensor(np.asarray(jbatch.actions)).long(),
        perms=[torch.as_tensor(perms)])
    fields = ("obs", "actions", "dones", "episode_steps", "values",
              "log_probs", "advantages", "tape", "snapshot")
    ranks = spawn(probe.train, 2, (cfg,), kwargs=dict(
        replay=replay, state_dict=flax_to_state_dict(params),
        batch_fields=fields, threads=1), **SPAWN)
    _assert_replicated(ranks)
    for r in ranks:
        rows = slice(r["rank"] * W // 2, (r["rank"] + 1) * W // 2)
        for name in fields:
            want = np.asarray(getattr(jbatch, name))[rows]
            got = r["batch"][name].numpy()
            if got.dtype.kind == "f":
                np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4,
                                           err_msg=name)
            else:
                np.testing.assert_array_equal(got, want, err_msg=name)
    j_stats = np.asarray(j_stats)
    for i, key in enumerate(STAT_KEYS):
        np.testing.assert_allclose(ranks[0]["results"][0][key], j_stats[i],
                                   rtol=STATS_RTOL, atol=1e-6, err_msg=key)
    _assert_params_close(ranks[0]["params"][0], flax_to_state_dict(j_new),
                         jcfg.epochs * jcfg.n_mini_batch)


# --- checkpoints, refusals -------------------------------------------


def test_checkpoint_is_one_file_and_resumes_at_any_n(tmp_path):
    """Two ranks checkpoint after update 1 and take update 2; resumed at 2
    ranks, update 2 is the same bit for bit; resumed on one device it is
    within the update tolerances."""
    cfg = config_from_dict(_minigrid(tmp_path, checkpoint_interval=1))
    run = dict(threads=1)
    first = spawn(probe.train, 2, (cfg, "ck"), kwargs=dict(
        updates=2, checkpoint_after=1, **run), **SPAWN)
    files = sorted(os.listdir(tmp_path / "models" / "ck_ckpt"))
    assert files == ["1.pt"]
    state = torch.load(tmp_path / "models" / "ck_ckpt" / "1.pt",
                       weights_only=True)
    assert state["rollout_state"]["memory"].shape[0] == cfg.n_workers
    assert state["update"] == 1
    again = spawn(probe.train, 2, (cfg, "ck"), kwargs=dict(
        updates=1, resume=True, **run), **SPAWN)
    _assert_replicated(again)
    for name, p in first[0]["params"][1].items():
        assert torch.equal(again[0]["params"][0][name], p), name
    # the episode statistics restart with the resumed run: not compared
    for key in STAT_KEYS + ("value_mean", "advantage_mean"):
        assert again[0]["results"][0][key] == first[0]["results"][1][key]
    one = probe.train(None, _one_device(cfg), "ck", updates=1, resume=True,
                      **run)
    _assert_params_close(one["params"][0], first[0]["params"][1],
                         2 * cfg.epochs * cfg.n_mini_batch)
    _assert_stats(one["results"], first[0]["results"][1:])


def test_refusals(tmp_path, monkeypatch):
    with pytest.raises(ValueError, match="divisible by num_devices"):
        config_from_dict(_raw(tmp_path, n_workers=3, worker_steps=16,
                              n_mini_batch=2))
    cfg = config_from_dict(_raw(tmp_path))
    with pytest.raises(RuntimeError, match="parallel.mesh.spawn"):
        PPOTrainer(cfg, device="cpu", enable_metrics=False)
    with pytest.raises(ValueError, match="holds 3 ranks"):
        PPOTrainer(cfg, device="cpu", enable_metrics=False,
                   mesh=DataMesh(0, 3, "cpu", "gloo"))

    class _Pool:                         # a pool that can step by group
        max_episode_steps = 10

        def step_group(self, group, actions):
            raise AssertionError

    trainer = PPOTrainer(_one_device(cfg), device="cpu", enable_metrics=False)
    groups = dataclasses.replace(cfg, host_pipeline_groups=3)
    with pytest.raises(ValueError, match=r"host_pipeline_groups \(3\) must "
                       r"divide the workers of a rank.*4 / 2 = 2"):
        HostRolloutFn(groups, _Pool(), trainer.model, None,
                      mesh=DataMesh(0, 2, "cpu", "gloo"))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="nccl runs one card a rank"):
        spawn(probe.train, 2, (cfg,), device="cuda")


def test_a_failing_rank_or_a_deadline_fails_the_run(tmp_path):
    """A rank that raises fails ``spawn`` with its traceback; a ``timeout``,
    where the caller gives one, bounds the whole run; either way no rank
    survives."""
    cfg = config_from_dict(_raw(tmp_path, checkpoint_interval=1))
    with pytest.raises(RuntimeError, match=r"rank \d of 2 failed:(.|\n)*"
                       "no checkpoint to resume from"):
        spawn(probe.train, 2, (cfg,), kwargs=dict(resume=True), **SPAWN)
    with pytest.raises(TimeoutError, match="did not finish within 1 s"):
        spawn(probe.train, 2, (cfg,), kwargs=dict(updates=100),
              **dict(SPAWN, timeout=1))
    assert not [p for p in torch.multiprocessing.active_children()]
