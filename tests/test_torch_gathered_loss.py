"""The gathered-window PPO loss of etmppo_tpu_torch vs the JAX package.

* ``compute_window_sources`` equals JAX's exactly, at PocMemory's and
  masked CartPole's real sizes (W, T, max_ep, L) = (16, 128, 32, 32) and
  (16, 256, 200, 32), on episodes of random lengths. PocMemory has
  ``max_ep == L``, a single sliding row in the index table, and episodes
  that wrap several times inside one rollout.
* ``loss_gathered`` and ``loss_window`` against JAX's ``_loss_fast`` and
  ``_loss`` on one minibatch of a JAX PocMemory rollout at the full
  ``POC_MEMORY`` width (GTrXL 4 x 64, pre-LN): loss and stats to rtol 1e-4
  (atol 1e-6), clipped gradients to rtol 1e-4 (atol 1e-7), as in
  tests/test_torch_training.py. A full update with JAX's permutations, 2
  epochs x 2 minibatches of 1024 as in tests/test_torch_training.py, to
  rtol 1e-3: later minibatches start from parameters that an AdamW step may
  have moved by ~lr where a gradient is at the level of float noise.
* The port's gathered loss against its own window-attention loss (the
  plain op on the CPU) on one minibatch of a ``use_pallas_attention: true``
  tiny config: the same function computed two ways, loss to rtol 1e-5.
* ``pallas_backward`` without ``use_pallas_attention`` warns, as the JAX
  trainer does, and trains on the gathered loss.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from etmppo_tpu.config import load_config as jax_load_config
from etmppo_tpu.envs.factory import create_env as jax_create_env
from etmppo_tpu.models.actor_critic import ActorCriticModel as JModel
from etmppo_tpu.ops import memory_index as jmi
from etmppo_tpu.training import ppo as jppo
from etmppo_tpu.training.rollout import RolloutFn as JRolloutFn
from etmppo_tpu_torch.config import config_from_dict
from etmppo_tpu_torch.interop import flax_to_state_dict, load_flax_params
from etmppo_tpu_torch.models.actor_critic import ActorCriticModel
from etmppo_tpu_torch.ops import memory_index as tmi
from etmppo_tpu_torch.training import ppo as ppo_lib
from etmppo_tpu_torch.training.ppo import PPOUpdate
from etmppo_tpu_torch.training.rollout import RolloutBatch
from etmppo_tpu_torch.training.trainer import PPOTrainer

torch.set_num_threads(1)

LR, CLIP, BETA = 3e-4, 0.2, 0.001
POC_YAML = "etmppo_tpu/configs/poc_memory_env.yaml"


def _episodes(rng, W, T, max_ep):
    """(episode_steps, dones) of W workers x T steps: episodes of random
    lengths in [1, max_ep], each worker entering mid-episode."""
    steps = np.empty((W, T), np.int32)
    dones = np.zeros((W, T), bool)
    for w in range(W):
        length = int(rng.integers(1, max_ep + 1))
        e = int(rng.integers(0, length))
        for t in range(T):
            steps[w, t] = e
            if e + 1 >= length:
                dones[w, t] = True
                e, length = 0, int(rng.integers(1, max_ep + 1))
            else:
                e += 1
    return steps, dones


@pytest.mark.parametrize("W,T,max_ep,L", [(16, 128, 32, 32),
                                          (16, 256, 200, 32)],
                         ids=["poc_memory", "cartpole"])
@pytest.mark.parametrize("seed", [0, 1])
def test_window_sources_match_jax(W, T, max_ep, L, seed):
    steps, dones = _episodes(np.random.default_rng(seed), W, T, max_ep)
    table = jmi.build_memory_indices(max_ep, L)
    want = jmi.compute_window_sources(jnp.asarray(steps), jnp.asarray(dones),
                                      jnp.asarray(table), max_ep)
    got = tmi.compute_window_sources(torch.as_tensor(steps).long(),
                                     torch.as_tensor(dones),
                                     torch.as_tensor(table), max_ep)
    assert dones.sum() >= 2 * W       # episodes end inside the rollout
    for name in want._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    assert got.flat_index.dtype == torch.int32
    assert int(got.flat_index.max()) < max_ep + T + max_ep
    # never-written slots resolve to the PE region at their own slot
    invalid = ~got.valid
    assert invalid.any()
    assert torch.equal(got.flat_index[invalid],
                       (max_ep + T + got.slot)[invalid])


# --- the loss on a JAX PocMemory rollout -------------------------------


def _jax_poc(**overrides):
    cfg = jax_load_config(POC_YAML)
    return dataclasses.replace(cfg, **overrides)


@pytest.fixture(scope="module")
def poc():
    """A JAX PocMemory rollout at the full POC_MEMORY width; the second
    rollout carries memory in, so the snapshot has rows."""
    jcfg = _jax_poc()
    env = jax_create_env(jcfg.environment)
    model = JModel(config=jcfg, obs_shape=env.observation_shape,
                   action_branches=env.action_branches,
                   max_episode_steps=env.max_episode_steps)
    params = model.init_params(jax.random.PRNGKey(0))
    rollout_fn = JRolloutFn(jcfg, env, model)
    state = rollout_fn.init_state(jax.random.PRNGKey(1))
    for _ in range(2):
        state, batch = rollout_fn(params, state)
    return dict(jcfg=jcfg, env=env, model=model, params=params, batch=batch)


def _torch_batch(batch) -> RolloutBatch:
    t = lambda x: torch.tensor(np.asarray(x))
    return RolloutBatch(
        obs=t(batch.obs), actions=t(batch.actions).long(),
        log_probs=t(batch.log_probs), values=t(batch.values),
        advantages=t(batch.advantages),
        episode_steps=t(batch.episode_steps).long(), dones=t(batch.dones),
        tape=t(batch.tape), snapshot=t(batch.snapshot),
        episode_infos={k: t(v) for k, v in batch.episode_infos.items()})


def _torch_update(jcfg, env, params, generator=None):
    tcfg = config_from_dict(dataclasses.asdict(jcfg))
    model = ActorCriticModel(tcfg, env.observation_shape, env.action_branches,
                             env.max_episode_steps, device="cpu")
    load_flax_params(model, params)
    return PPOUpdate(tcfg, model, env.max_episode_steps, generator)


def _jax_minibatch(jupdate, batch, idx):
    """JAX's minibatch for ``_loss_fast`` and ``_loss``, built the way
    PPOUpdateFn._update builds it; and (src, src_slots)."""
    cfg = jupdate.config
    W, T = cfg.n_workers, cfg.worker_steps
    L = cfg.transformer.memory_length
    max_ep = jupdate.max_ep
    sources = jmi.compute_window_sources(batch.episode_steps, batch.dones,
                                         jupdate.index_table, max_ep)
    src = jnp.concatenate([batch.snapshot, batch.tape,
                           jnp.zeros_like(batch.snapshot)], axis=1)
    slot_range = jnp.tile(jnp.arange(max_ep, dtype=jnp.int32)[None], (W, 1))
    src_slots = jnp.concatenate(
        [slot_range, batch.episode_steps.astype(jnp.int32), slot_range], 1)
    flat = lambda x: x.reshape((W * T,) + x.shape[2:])[idx]
    w_idx = idx // T
    mb = dict(obs=flat(batch.obs), actions=flat(batch.actions),
              log_probs=flat(batch.log_probs), values=flat(batch.values),
              advantages=flat(batch.advantages), w_idx=w_idx,
              flat_index=flat(sources.flat_index),
              memory_mask=jupdate.mask_table[
                  jnp.clip(flat(batch.episode_steps), 0, L - 1)],
              memory_indices=flat(sources.slot))
    mb["memory_window"] = src[w_idx[:, None], mb["flat_index"]]
    return mb, src, src_slots


def _jax_grads(jupdate, params, mb, src, src_slots, fast: bool):
    if fast:
        fn = lambda p: jupdate._loss_fast(p, mb, src, src_slots, CLIP, BETA)
    else:
        fn = lambda p: jupdate._loss(p, mb, CLIP, BETA)
    (_, stats), grads = jax.value_and_grad(fn, has_aux=True)(params)
    grads, _ = jppo.clip_grads_torch(grads, jupdate.config.max_grad_norm)
    return np.asarray(stats), flax_to_state_dict(grads)


@pytest.mark.parametrize("loss", ["gathered", "window"])
def test_minibatch_loss_and_clipped_gradients_match(poc, loss):
    jcfg, env, params, batch = (poc[k] for k in ("jcfg", "env", "params",
                                                  "batch"))
    jupdate = jppo.PPOUpdateFn(jcfg, poc["model"], env.max_episode_steps)
    idx = np.random.default_rng(3).permutation(jcfg.batch_size)[
        :jcfg.mini_batch_size]
    mb, src, src_slots = _jax_minibatch(jupdate, batch, jnp.asarray(idx))
    j_stats, j_grads = _jax_grads(jupdate, params, mb, src, src_slots,
                                  fast=loss == "gathered")

    update = _torch_update(jcfg, env, params)
    t_src, t_slots, fields = update.prepare_gathered(_torch_batch(batch))
    np.testing.assert_array_equal(t_src.numpy(), np.asarray(src))
    np.testing.assert_array_equal(t_slots.numpy(), np.asarray(src_slots))
    t_mb = update.minibatch(fields, torch.as_tensor(idx))
    fn = update.loss_gathered if loss == "gathered" else update.loss_window
    t_loss, t_stats = fn(t_mb, t_src, t_slots, CLIP, BETA)
    t_loss.backward()
    torch.nn.utils.clip_grad_norm_(update.model.parameters(),
                                   jcfg.max_grad_norm)
    np.testing.assert_allclose(t_stats.numpy(), j_stats, rtol=1e-4,
                               atol=1e-6)
    for name, p in update.model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), j_grads[name].numpy(),
                                   rtol=1e-4, atol=1e-7, err_msg=name)


def test_full_update_matches(poc):
    """2 epochs x 2 minibatches on the POC_MEMORY batch: stats and gradient
    norm groups are means over the four steps; every parameter ends within
    2 * lr per step of JAX's, and 99% of them within 1e-5."""
    env, params, batch = (poc[k] for k in ("env", "params", "batch"))
    jcfg = dataclasses.replace(poc["jcfg"], epochs=2, n_mini_batch=2)
    jupdate = jppo.PPOUpdateFn(jcfg, poc["model"], env.max_episode_steps)
    rng = jax.random.PRNGKey(5)
    perms = np.stack([np.asarray(jax.random.permutation(k, jcfg.batch_size))
                      for k in jax.random.split(rng, jcfg.epochs)])
    jparams = jax.tree.map(jnp.copy, params)
    j_new, _, j_stats, j_groups = jupdate(
        jparams, jupdate.init_opt_state(jparams), batch, rng, LR, CLIP, BETA)

    update = _torch_update(jcfg, env, params)
    t_stats, t_groups = update(_torch_batch(batch), LR, CLIP, BETA,
                               perms=torch.as_tensor(perms))
    np.testing.assert_allclose(t_stats.numpy(), np.asarray(j_stats),
                               rtol=1e-3, atol=1e-6)
    for k, v in j_groups.items():
        np.testing.assert_allclose(float(t_groups[k]), float(v), rtol=1e-3,
                                   err_msg=k)
    j_new = flax_to_state_dict(j_new)
    steps = jcfg.epochs * jcfg.n_mini_batch
    diffs = np.concatenate([
        np.abs(p.detach().numpy() - j_new[n].numpy()).ravel()
        for n, p in update.model.named_parameters()])
    assert diffs.max() <= 2 * LR * steps
    assert np.quantile(diffs, 0.99) <= 1e-5


# --- the port's two losses on one config --------------------------------


def _tiny_kernel_config():
    return config_from_dict(dict(
        environment={"type": "Minigrid", "name": "MiniGrid-MemoryS9-v0"},
        epochs=1, n_workers=2, worker_steps=48, n_mini_batch=2,
        hidden_layer_size=32,
        transformer={"num_blocks": 2, "embed_dim": 32, "num_heads": 4,
                     "memory_length": 8, "positional_encoding": "relative",
                     "layer_norm": "post"},
        use_pallas_attention=True, pallas_backward=True))


def test_gathered_loss_equals_the_window_attention_loss():
    cfg = _tiny_kernel_config()
    trainer = PPOTrainer(cfg, device="cpu", enable_metrics=False)
    state = trainer.rollout_state
    for _ in range(2):   # the second batch carries memory in
        state, batch = trainer.rollout_fn(state)
    upd = trainer.update_fn
    timeline, tl_slots, tl_fields = upd.prepare(batch)
    src, src_slots, g_fields = upd.prepare_gathered(batch)
    idx = torch.randperm(cfg.batch_size,
                         generator=torch.Generator().manual_seed(0))[
        :cfg.mini_batch_size]
    results = []
    for fn, memory, slots, fields in (
            (upd.loss_timeline, timeline, tl_slots, tl_fields),
            (upd.loss_gathered, src, src_slots, g_fields),
            (upd.loss_window, src, src_slots, g_fields)):
        trainer.model.zero_grad(set_to_none=True)
        loss, stats = fn(upd.minibatch(fields, idx), memory, slots, CLIP,
                         BETA)
        loss.backward()
        results.append((loss.item(), stats, [p.grad.clone() for p in
                                             trainer.model.parameters()]))
    assert batch.dones.any() and batch.snapshot.any()
    (loss_t, stats_t, grads_t), *others = results
    for loss, stats, grads in others:
        np.testing.assert_allclose(loss, loss_t, rtol=1e-5)
        np.testing.assert_allclose(stats.numpy(), stats_t.numpy(), rtol=1e-5,
                                   atol=1e-7)
        for a, b in zip(grads, grads_t):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                       atol=1e-6)


def test_loss_follows_the_config():
    cfg = _tiny_kernel_config()
    trainer = PPOTrainer(cfg, device="cpu", enable_metrics=False)
    _, batch = trainer.rollout_fn(trainer.rollout_state)
    memory, _, fields = trainer.update_fn.prepare(batch)
    assert "tl_start" in fields and "flat_index" not in fields
    assert memory.shape[1] == trainer.max_episode_steps + 48 + 8
    gathered = PPOTrainer(dataclasses.replace(cfg, use_pallas_attention=False,
                                              pallas_backward=False),
                          device="cpu", enable_metrics=False)
    memory, _, fields = gathered.update_fn.prepare(batch)
    assert "flat_index" in fields and "tl_start" not in fields
    assert memory.shape[1] == 2 * trainer.max_episode_steps + 48


def test_pallas_backward_without_the_kernel_loss_warns(monkeypatch):
    cfg = dataclasses.replace(_tiny_kernel_config(),
                              use_pallas_attention=False, updates=1)
    with pytest.warns(UserWarning, match="no effect without"):
        trainer = PPOTrainer(cfg, device="cpu", enable_metrics=False)
    calls = []
    monkeypatch.setattr(ppo_lib, "window_attention",
                        lambda *a, **k: calls.append(1))
    result = trainer.train_one_update()
    assert np.isfinite(result["loss"]) and not calls
