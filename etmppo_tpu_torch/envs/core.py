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
  ``info`` per-episode statistics read where ``done``;
* ``reset_done(done, draws, state, obs) -> (state, obs)``: the auto-reset
  of the device rollout (``training/rollout.py``): the workers where
  ``done`` start a new episode from ``draws``, the others keep ``state`` and
  ``obs``. The default resets all workers and keeps the reset where
  ``done`` (``select_state``); an env may do the same in a kernel of its own,
  its ``reset_kernel``, which it lists in ``kernels`` and which rebuilds
  only the workers whose episode ended: on CUDA Mystery Path Grid's
  (``csrc/mystery_path_reset.cu``) and Mortar Mayhem Grid's
  (``csrc/mortar_mayhem_reset.cu``, which picks the commands from the reset
  draws' uniforms itself). Each gives the default's bits; on the CPU both
  envs take the default.
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
    kernels: Tuple[Any, ...] = ()           # its CUDA kernels (CudaKernel)
    reset_kernel: Any = None                # the one of them in reset_done

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

    def reset_done(self, done: torch.Tensor, draws: Any, state: Any,
                   obs: torch.Tensor):
        reset_state, reset_obs = self.reset(draws)
        state = select_state(done, reset_state, state)
        obs = torch.where(done.reshape((-1,) + (1,) * (obs.dim() - 1)),
                          reset_obs, obs)
        return state, obs
