"""Batched environment protocol on the device
(counterpart of ``etmppo_tpu/envs/core.py``).

An environment steps all W workers at once: its state is a NamedTuple of
tensors with a leading worker axis, on the env's device.

* ``observation_shape`` (images NHWC), ``action_branches`` (arity per
  multi-discrete branch), ``max_episode_steps``, ``info_keys``;
* ``sample_reset_draws(generator)``: the random values a reset of all
  ``draw_width`` workers consumes, drawn from an explicit generator. JAX's
  and PyTorch's generators differ, so tests hand ``reset`` the values the
  JAX env drew;
* ``sample_step_draws(generator)``: the random values a step of all
  ``draw_width`` workers consumes, or None (the default) for an env whose
  step draws nothing: such an env takes nothing from the generator;
* ``draw_width``: ``n_workers``, or under data parallelism the run's W
  (``draw_workers``): a rank's env steps its ``n_workers`` of them, draws
  for all W and the rollout keeps the rank's rows
  (``parallel/mesh.shard_worker_tree``), so its workers see what they see
  on one device;
* ``reset(draws) -> (state, obs)``;
* ``step(state, actions, draws=None) -> (state, obs, reward, done, info)``:
  ``draws`` from ``sample_step_draws``; ``reward`` is the training reward,
  ``info`` per-episode statistics read where ``done``.

Auto-reset lives in the rollout (``training/rollout.py``), with
``select_state``.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import torch


def select_state(mask: torch.Tensor, new: NamedTuple, old: NamedTuple
                 ) -> NamedTuple:
    """Field-wise ``where(mask[w], new, old)`` over the worker axis."""
    def pick(a, b):
        return torch.where(mask.reshape((-1,) + (1,) * (a.dim() - 1)), a, b)
    return type(old)(*(pick(a, b) for a, b in zip(new, old)))


class TorchEnv:
    """Base class documenting the batched env interface."""

    observation_shape: Tuple[int, ...]
    action_branches: Tuple[int, ...]
    max_episode_steps: int
    info_keys: Tuple[str, ...]
    n_workers: int
    device: torch.device
    draw_workers: Optional[int] = None      # set by envs/factory.create_env

    @property
    def draw_width(self) -> int:
        return self.draw_workers or self.n_workers

    def sample_reset_draws(self, generator: torch.Generator) -> Any:
        raise NotImplementedError

    def sample_step_draws(self, generator: torch.Generator) -> Any:
        return None

    def reset(self, draws: Any):
        raise NotImplementedError

    def step(self, state: Any, actions: torch.Tensor, draws: Any = None):
        raise NotImplementedError
