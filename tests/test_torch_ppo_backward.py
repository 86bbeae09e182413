"""One PPO update with ``pallas_backward: true``: etmppo_tpu_torch's
``PPOUpdate`` vs the JAX package's ``PPOUpdateFn`` with
``BACKWARD_MODE = "pallas"`` (its fused Pallas backward, interpret mode on the
CPU), on small versions of the two flagships' architectures:

* MiniGrid-Memory: CNN, post-LN TrXL, relative PE;
* Mystery Path Grid: CNN, pre-LN TrXL, no PE, a memory length (12) that is not
  a power of two.

Both get the same parameters (through ``interop.py``), the same JAX rollout
batch and the same permutation (1 epoch x 1 minibatch). On the CPU the
port's update hands the backward kernel to the op, which takes the plain VJP
for CPU tensors. Stats and clipped gradients agree to 1e-4 relative.
(tests/test_torch_training.py holds the AdamW step and a longer update
against the JAX package.)
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
from etmppo_tpu.ops import pallas_window_attention as pwa
from etmppo_tpu.training import ppo as jppo
from etmppo_tpu.training.rollout import RolloutFn as JRolloutFn
from etmppo_tpu_torch.config import config_from_dict
from etmppo_tpu_torch.interop import flax_to_state_dict, load_flax_params
from etmppo_tpu_torch.models.actor_critic import ActorCriticModel
from etmppo_tpu_torch.ops.window_attention import window_attention_bwd
from etmppo_tpu_torch.training.ppo import PPOUpdate
from etmppo_tpu_torch.training.rollout import RolloutBatch

torch.set_num_threads(1)

LR, CLIP, BETA = 3e-4, 0.1, 0.001
CONFIGS = {
    "minigrid": ("etmppo_tpu/configs/minigrid.yaml", 8),
    "mystery_path": ("etmppo_tpu/configs/mystery_path_grid.yaml", 12),
}


def _jax_config(name):
    path, memory_length = CONFIGS[name]
    cfg = jax_load_config(path)
    assert cfg.pallas_backward and cfg.use_pallas_attention
    trx = dataclasses.replace(cfg.transformer, num_blocks=2, embed_dim=32,
                              num_heads=4, memory_length=memory_length)
    return dataclasses.replace(cfg, n_workers=2, worker_steps=16,
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


def _jax_minibatch_grads(jcfg, update_fn, params, batch, idx):
    """JAX's stats and clipped gradients of one minibatch, built the way
    PPOUpdateFn._update builds it."""
    L = jcfg.transformer.memory_length
    T, B = jcfg.worker_steps, jcfg.batch_size
    timeline = jmi.build_timeline(batch.snapshot, batch.tape,
                                  batch.episode_steps[:, 0], pad=L)
    slots = jmi.build_timeline_slots(batch.episode_steps, update_fn.max_ep,
                                     pad=L)
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
    (_, stats), grads = jax.value_and_grad(
        update_fn._loss_pallas, has_aux=True)(params, mb, timeline, slots,
                                              CLIP, BETA)
    grads, _ = jppo.clip_grads_torch(grads, jcfg.max_grad_norm)
    return np.asarray(stats), grads


@pytest.fixture(scope="module", params=list(CONFIGS))
def one_step(request):
    jcfg = _jax_config(request.param)
    env = jax_create_env(jcfg.environment)
    jmodel = JModel(config=jcfg, obs_shape=env.observation_shape,
                    action_branches=env.action_branches,
                    max_episode_steps=env.max_episode_steps)
    params = jmodel.init_params(jax.random.PRNGKey(0))
    rollout_fn = JRolloutFn(jcfg, env, jmodel)
    state = rollout_fn.init_state(jax.random.PRNGKey(1))
    for _ in range(2):      # the second batch carries memory in
        state, batch = rollout_fn(params, state)

    calls = []
    mp = pytest.MonkeyPatch()
    mp.setattr(pwa, "BACKWARD_MODE", "pallas")
    real_backward = pwa._pallas_backward
    mp.setattr(pwa, "_pallas_backward",
               lambda *a, **k: calls.append(1) or real_backward(*a, **k))
    try:
        jupdate = jppo.PPOUpdateFn(jcfg, jmodel, env.max_episode_steps)
        rng = jax.random.PRNGKey(3)
        perm = np.asarray(jax.random.permutation(
            jax.random.split(rng, jcfg.epochs)[0], jcfg.batch_size))
        j_stats, j_grads = _jax_minibatch_grads(
            jcfg, jupdate, params, batch, jnp.asarray(perm))
    finally:
        mp.undo()
    assert pwa.BACKWARD_MODE == "xla" and calls

    tcfg = config_from_dict(dataclasses.asdict(jcfg))
    assert tcfg.pallas_backward
    model = ActorCriticModel(tcfg, env.observation_shape, env.action_branches,
                             env.max_episode_steps, device="cpu")
    load_flax_params(model, params)
    update = PPOUpdate(tcfg, model, env.max_episode_steps, generator=None)
    assert update.backward_kernel is window_attention_bwd
    launches = window_attention_bwd.launches
    t_stats, _ = update(_torch_batch(batch), LR, CLIP, BETA,
                        perms=torch.tensor(perm)[None])
    assert window_attention_bwd.launches == launches
    return dict(j_stats=j_stats, j_grads=j_grads, model=model,
                t_stats=t_stats)


def test_stats_match(one_step):
    np.testing.assert_allclose(one_step["t_stats"].numpy(),
                               one_step["j_stats"], rtol=1e-4, atol=1e-6)


def test_clipped_gradients_match(one_step):
    j_grads = flax_to_state_dict(one_step["j_grads"])
    for name, p in one_step["model"].named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), j_grads[name].numpy(),
                                   rtol=1e-4, atol=1e-7, err_msg=name)
