"""Batched policy serving (counterpart of ``etmppo_tpu/serve.py``).

``PolicyServer`` serves a trained policy to M concurrent streams (player
sessions, evaluation episodes, sim instances) on one device:

* Each stream's episodic memory is kept as projected K/V caches
  (``project_memory``): a memory item is projected once, when it is written,
  so a step gathers its window and attends, without re-projecting it.
* Every step computes all M streams; inactive streams compute but commit
  nothing, and an inactive stream's counter does not advance.
* ``reset`` returns streams to a fresh episode: their caches become the
  PE-only projections (``pe_kv``), as the rollout's auto-reset does.

A step attends over the window in plain PyTorch, as the JAX package's does
in plain jnp; no window-attention kernel runs here.

Typical use::

    server = PolicyServer("models/run.nn", max_streams=64)
    server.reset(range(64))
    actions, values = server.step(obs_batch)       # (64, branches), (64,)
    server.reset(finished_ids)                     # episode boundaries
"""
from __future__ import annotations

from typing import Iterable, Optional, Sequence, Tuple

import numpy as np
import torch

from .models.kv_cache import KVCacheStep
from .ops import distributions
from .training.checkpoint import load_model


def as_float_tensor(x, device) -> torch.Tensor:
    """``x`` (array-like or tensor) as float32 on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    x = np.asarray(x, np.float32)
    if not x.flags.writeable:     # a view of a request body's bytes
        x = x.copy()
    return torch.as_tensor(x, device=device)


class PolicyServer:
    """Serves a trained policy to up to ``max_streams`` concurrent episode
    streams on ``device`` (the CUDA device unless the caller asks for
    another; raises without a GPU). ``greedy=True`` takes the mode of each
    action branch instead of sampling. Sampling draws from a generator on
    the device seeded ``seed``, once per step."""

    def __init__(self, model_path: str, max_streams: int = 64,
                 greedy: bool = False, seed: int = 0, device="cuda"):
        self.model, self.config = load_model(model_path, device)
        model = self.model
        self.device = model.lin_hidden.weight.device
        self.max_streams = int(max_streams)
        self.greedy = bool(greedy)
        self.action_branches = model.action_branches
        self.observation_shape = model.obs_shape
        self.max_episode_steps = model.max_episode_steps

        M, dev = self.max_streams, self.device
        self._kv_step = KVCacheStep(model, M, self.max_episode_steps,
                                    self.config.transformer.memory_length,
                                    dev)
        self._streams = torch.arange(M, device=dev)
        with torch.no_grad():
            self._pe_k, self._pe_v = model.pe_kv()
        self._k_cache = self._pe_k.expand(M, -1, -1, -1).clone()
        self._v_cache = self._pe_v.expand(M, -1, -1, -1).clone()
        self._t = torch.zeros(M, dtype=torch.int64, device=dev)
        self._generator = torch.Generator(dev).manual_seed(seed)

    @torch.no_grad()
    def _step(self, obs: torch.Tensor, active: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One step of all streams (``KVCacheStep``, which clamps the window
        and the slot of a stream at ``t == max_episode_steps`` as JAX does);
        the new item is written where the stream is active. A stream at
        ``t == max_episode_steps`` is frozen."""
        rows, t = self._streams, self._t
        active = active & (t < self.max_episode_steps)
        logits, values, _, slot, k_item, v_item = self._kv_step(
            obs, self._k_cache, self._v_cache, t)
        act = active[:, None, None]
        self._k_cache[rows, slot] = torch.where(act, k_item,
                                                self._k_cache[rows, slot])
        self._v_cache[rows, slot] = torch.where(act, v_item,
                                                self._v_cache[rows, slot])
        self._t = torch.where(active, t + 1, t)
        if self.greedy:
            actions = torch.stack([lg.argmax(dim=-1) for lg in logits],
                                  dim=-1).to(torch.int32)
        else:
            actions, _ = distributions.sample_multi(logits, self._generator)
        return actions, values

    def _active(self, active) -> torch.Tensor:
        if active is None:
            return torch.ones(self.max_streams, dtype=torch.bool,
                              device=self.device)
        if isinstance(active, torch.Tensor):
            return active.to(device=self.device, dtype=torch.bool)
        return torch.as_tensor(np.asarray(active, bool), device=self.device)

    def _check_active(self, active) -> None:
        if active is not None and tuple(np.shape(active)) != (
                self.max_streams,):
            raise ValueError(
                f"active must have shape ({self.max_streams},), got "
                f"{tuple(np.shape(active))}: a shorter mask would silently "
                f"broadcast")

    # ------------------------------------------------------------------

    def reset(self, stream_ids: Iterable[int]) -> None:
        """Marks streams as fresh episodes: PE-only caches and step 0."""
        ids = np.fromiter(stream_ids, dtype=np.int64)
        if ids.size == 0:
            return
        bad = ids[(ids < 0) | (ids >= self.max_streams)]
        if bad.size:
            raise ValueError(f"stream ids {bad.tolist()} out of range [0, "
                             f"{self.max_streams})")
        ids_t = torch.as_tensor(ids, device=self.device)
        self._k_cache[ids_t] = self._pe_k
        self._v_cache[ids_t] = self._pe_v
        self._t[ids_t] = 0

    def step(self, obs, active: Optional[Sequence[bool]] = None
             ) -> Tuple[np.ndarray, np.ndarray]:
        """One policy step for all streams.

        obs: (max_streams, *observation_shape); rows of inactive streams may
        hold anything. active: optional bool mask (default: all active).
        Returns (actions (M, n_branches) int32, values (M,) float32) as
        numpy. Raises where an active stream has spent its episode budget:
        the caller resets it first.
        """
        obs = as_float_tensor(obs, self.device)
        expected = (self.max_streams,) + tuple(self.observation_shape)
        if tuple(obs.shape) != expected:
            raise ValueError(f"obs must be {expected}, got "
                             f"{tuple(obs.shape)}")
        self._check_active(active)
        active_t = self._active(active)
        exhausted = (active_t & (self._t >= self.max_episode_steps)).cpu()
        if exhausted.any():
            raise ValueError(
                f"streams {torch.nonzero(exhausted)[:, 0].tolist()} have "
                f"reached max_episode_steps={self.max_episode_steps}; call "
                f"reset() on them before stepping (the server has no done "
                f"signal: episode boundaries are caller-driven)")
        actions, values = self._step(obs, active_t)
        return actions.cpu().numpy(), values.cpu().numpy()

    def step_device(self, obs, active=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The same step without checks or host copies: device tensors, no
        host sync, so callers can enqueue many steps and sync once. Streams
        at ``t == max_episode_steps`` stop advancing instead of raising."""
        return self._step(as_float_tensor(obs, self.device),
                          self._active(active))

    def step_many(self, obs_seq, active=None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """T steps of ``step_device`` back to back, with no host sync.

        obs_seq: (T, max_streams, *observation_shape). Returns device
        tensors: actions (T, M, n_branches) int32, values (T, M) float32.
        """
        obs_seq = as_float_tensor(obs_seq, self.device)
        expected_tail = (self.max_streams,) + tuple(self.observation_shape)
        if obs_seq.dim() != 1 + len(expected_tail) \
                or tuple(obs_seq.shape[1:]) != expected_tail:
            raise ValueError(
                f"obs_seq must be (T, {', '.join(map(str, expected_tail))}), "
                f"got {tuple(obs_seq.shape)}")
        self._check_active(active)
        active_t = self._active(active)
        out = [self._step(obs, active_t) for obs in obs_seq]
        return (torch.stack([a for a, _ in out]),
                torch.stack([v for _, v in out]))

    @property
    def steps(self) -> np.ndarray:
        """Current episode-step counter per stream (host copy)."""
        return self._t.to(torch.int32).cpu().numpy()
