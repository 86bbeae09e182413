"""Rollout on the device (counterpart of ``etmppo_tpu/training/rollout.py``).

A Python loop over ``worker_steps`` takes the place of the JAX ``scan``. Each
step runs the policy on the KV-cache path: the memory window's K/V are
gathered from per-worker caches, and only the new memory item is projected.
Every new memory item is also written once to a tape; training rebuilds its
windows from (pre-rollout snapshot, tape).

Step order: store obs / episode step -> policy forward -> write the memory
item at ``(w, episode_step)`` -> sample actions -> env step (with its step
draws) -> where done:
reset the env, zero the worker's memory, reset its K/V caches to the
PE-only projections and its episode step to 0.

With ``obs_uint8`` the batch stores each observation as
``quantize_obs(obs)``, a quarter of the bytes; the policy still sees the
float observation, so the rollout itself is the float one's.

Under data parallelism (a ``mesh``, ``parallel/mesh.py``) a rank collects
its own workers' rows (``mesh.worker_rows``); every draw (reset, step and
the actions' uniforms) is made for all W workers and the rank keeps its
rows, so the rank's batch is those rows of the one-device batch. GAE, the
memory indices and the bootstrap value are per worker and stay local.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from ..config import TrainConfig
from ..envs.core import TorchEnv, select_state
from ..models.actor_critic import ActorCriticModel
from ..models.kv_cache import KVCacheStep
from ..ops import distributions
from ..ops.gae import calc_advantages
from ..ops.memory_index import build_memory_indices
from ..parallel.mesh import DataMesh, shard_worker_tree


def quantize_obs(obs: torch.Tensor) -> torch.Tensor:
    """``round(obs * 255)`` as uint8, saturated to [0, 255] as XLA's cast
    is (PyTorch's float-to-uint8 cast wraps: -0.2 would become 205)."""
    return torch.round(obs * 255.0).clamp(0, 255).to(torch.uint8)


class RolloutState(NamedTuple):
    """Sampler state carried from one update to the next."""
    env_state: NamedTuple       # batched env state, leading axis W
    obs: torch.Tensor           # (W, *obs_shape)
    episode_step: torch.Tensor  # (W,) int64
    memory: torch.Tensor        # (W, max_ep, blocks, D) live episodic memory


class RolloutBatch(NamedTuple):
    """One update's training data."""
    obs: torch.Tensor            # (W, T, *obs_shape)
    actions: torch.Tensor        # (W, T, n_branches) int64
    log_probs: torch.Tensor      # (W, T, n_branches)
    values: torch.Tensor         # (W, T)
    advantages: torch.Tensor     # (W, T)
    episode_steps: torch.Tensor  # (W, T) int64, before the step
    dones: torch.Tensor          # (W, T) bool
    tape: torch.Tensor           # (W, T, blocks, D) new memory item per step
    snapshot: torch.Tensor       # (W, max_ep, blocks, D) pre-rollout memory
    episode_infos: Dict[str, torch.Tensor]  # each (W, T); valid where dones


class RolloutFn:
    """Collects ``worker_steps`` steps of all workers with ``model``. Random
    draws come from ``generator``, on the env's device, in this order at
    each step: the actions, then the env's step draws (none for an env whose
    step draws nothing), then the reset draws of all workers. With a
    ``mesh``, ``env`` holds this rank's workers and draws for all
    ``config.n_workers``."""

    def __init__(self, config: TrainConfig, env: TorchEnv,
                 model: ActorCriticModel, generator: torch.Generator,
                 mesh: Optional[DataMesh] = None):
        self.config = config
        self.env = env
        self.model = model
        self.generator = generator
        self.mesh = mesh
        W = config.n_workers
        self.rows = slice(0, W) if mesh is None else mesh.worker_rows(W)
        self.n_workers = self.rows.stop - self.rows.start
        if mesh is not None and (env.n_workers, env.draw_width) != (
                self.n_workers, W):
            raise ValueError(
                f"rank {mesh.rank}'s env holds {env.n_workers} workers and "
                f"draws for {env.draw_width}; it must hold its "
                f"{self.n_workers} and draw for all {W}")
        # The actions' uniforms: for all W workers, this rank's rows kept.
        self._draw_rows = () if mesh is None else (self.rows, W)
        self.device = env.device
        trx = config.transformer
        self.max_ep = env.max_episode_steps
        self.kv_step = KVCacheStep(model, self.n_workers, self.max_ep,
                                   trx.memory_length, self.device)
        self.index_table = torch.as_tensor(
            build_memory_indices(self.max_ep, trx.memory_length),
            device=self.device)

    def init_state(self) -> RolloutState:
        trx = self.config.transformer
        W = self.n_workers
        env_state, obs = self.env.reset(self.reset_draws())
        return RolloutState(
            env_state=env_state, obs=obs,
            episode_step=torch.zeros(W, dtype=torch.int64, device=self.device),
            memory=torch.zeros(W, self.max_ep, trx.num_blocks, trx.embed_dim,
                               device=self.device))

    # Random draws, one method each so that a test can inject the JAX ones.

    def reset_draws(self):
        return shard_worker_tree(self.env.sample_reset_draws(self.generator),
                                 self.mesh, self.config.n_workers)

    def step_draws(self):
        return shard_worker_tree(self.env.sample_step_draws(self.generator),
                                 self.mesh, self.config.n_workers)

    def sample_actions(self, logits, step: int):
        del step
        return distributions.sample_multi(logits, self.generator,
                                          *self._draw_rows)

    @torch.no_grad()
    def __call__(self, state: RolloutState
                 ) -> Tuple[RolloutState, RolloutBatch]:
        cfg = self.config
        W, T = self.n_workers, cfg.worker_steps
        dev = self.device
        model = self.model
        workers = torch.arange(W, device=dev)
        slots = torch.arange(self.max_ep, device=dev).expand(W, -1)

        snapshot = state.memory
        memory = snapshot.clone()
        # Params are fixed within a rollout: project the carried-in memory
        # into K/V caches once. Unwritten slots are zero, so their K/V are
        # the PE-only projections.
        k_cache, v_cache = model.project_memory(memory, slots)
        pe_k, pe_v = model.pe_kv()

        n_br = len(self.env.action_branches)
        out = dict(
            obs=torch.empty((W, T) + tuple(state.obs.shape[1:]), device=dev,
                            dtype=torch.uint8 if cfg.obs_uint8
                            else torch.float32),
            actions=torch.empty(W, T, n_br, dtype=torch.int64, device=dev),
            log_probs=torch.empty(W, T, n_br, device=dev),
            values=torch.empty(W, T, device=dev),
            rewards=torch.empty(W, T, device=dev),
            dones=torch.empty(W, T, dtype=torch.bool, device=dev),
            episode_steps=torch.empty(W, T, dtype=torch.int64, device=dev),
            tape=torch.empty((W, T) + tuple(memory.shape[2:]), device=dev))
        infos = {k: torch.empty(W, T, device=dev) for k in self.env.info_keys}

        env_state, obs, e = state.env_state, state.obs, state.episode_step
        for t in range(T):
            logits, value, mem_item, slot, k_item, v_item = self.kv_step(
                obs, k_cache, v_cache, e)
            memory[workers, slot] = mem_item
            k_cache[workers, slot] = k_item
            v_cache[workers, slot] = v_item
            actions, log_probs = self.sample_actions(logits, t)

            env_state, obs_next, reward, done, info = self.env.step(
                env_state, actions, self.step_draws())
            reset_state, reset_obs = self.env.reset(self.reset_draws())
            env_state = select_state(done, reset_state, env_state)
            obs_next = torch.where(
                done.reshape((W,) + (1,) * (obs_next.dim() - 1)), reset_obs,
                obs_next)
            done4 = done[:, None, None, None]
            memory.masked_fill_(done4, 0.0)
            k_cache = torch.where(done4, pe_k, k_cache)
            v_cache = torch.where(done4, pe_v, v_cache)

            out["obs"][:, t] = quantize_obs(obs) if cfg.obs_uint8 else obs
            out["actions"][:, t] = actions
            out["log_probs"][:, t] = log_probs
            out["values"][:, t] = value
            out["rewards"][:, t] = reward
            out["dones"][:, t] = done
            out["episode_steps"][:, t] = e
            out["tape"][:, t] = mem_item
            for k in infos:
                infos[k][:, t] = info[k]
            obs = obs_next
            e = torch.where(done, 0, e + 1)

        final_state = RolloutState(env_state, obs, e, memory)
        # The reference bootstraps with the LAST step's memory indices.
        last_indices = self.index_table[out["episode_steps"][:, -1]]
        last_value = self._last_value(final_state, last_indices)
        advantages = calc_advantages(out["rewards"], out["values"],
                                     out["dones"], last_value, cfg.gamma,
                                     cfg.lamda)
        batch = RolloutBatch(
            obs=out["obs"], actions=out["actions"],
            log_probs=out["log_probs"], values=out["values"],
            advantages=advantages, episode_steps=out["episode_steps"],
            dones=out["dones"], tape=out["tape"], snapshot=snapshot,
            episode_infos=infos)
        return final_state, batch

    def _last_value(self, state: RolloutState, last_indices):
        return bootstrap_value(self.model, state.obs, state.memory,
                               state.episode_step, self.kv_step.mask_table,
                               last_indices)


def bootstrap_value(model, obs, memory, episode_step, mask_table,
                    last_indices):
    """V(s_T), with the reference's shifted window ``[max(e - L, 0),
    max(e - L, 0) + L)`` of ``memory`` at each worker's episode step ``e``
    and the given slot indices (the reference's quirk: the last step's)."""
    L = mask_table.shape[-1]
    e = episode_step
    rows = (e - L).clamp(min=0)[:, None] + torch.arange(L, device=e.device)
    window = memory[torch.arange(e.shape[0], device=e.device)[:, None], rows]
    _, last_value, _ = model(obs, window, mask_table[e.clamp(0, L - 1)],
                             last_indices)
    return last_value
