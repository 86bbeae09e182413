"""CartPole-v0 with optional velocity masking, batched over workers on the
device (counterpart of ``etmppo_tpu/envs/cartpole.py``).

Classic cart-pole dynamics in float32 (Euler integration, tau 0.02), a
200-step limit, and with ``mask_velocity`` the two velocities (indices 1 and
3) zeroed in the observation, so that the policy needs memory. The training
reward is 1/100 per step; the episode info reports the raw return (``reward``)
and the ``length``, and has no ``success``.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from .core import TorchEnv

GRAVITY = 9.8
MASS_CART = 1.0
MASS_POLE = 0.1
TOTAL_MASS = MASS_CART + MASS_POLE
LENGTH = 0.5  # half the pole's length
POLE_MASS_LENGTH = MASS_POLE * LENGTH
FORCE_MAG = 10.0
TAU = 0.02
THETA_THRESHOLD = 12 * 2 * math.pi / 360
X_THRESHOLD = 2.4


class CartPoleState(NamedTuple):
    physics: torch.Tensor     # (W, 4) float32: x, x_dot, theta, theta_dot
    step_count: torch.Tensor  # (W,) int64
    reward_sum: torch.Tensor  # (W,) float32 raw (unscaled) episode return
    length: torch.Tensor      # (W,) int64


class CartPole(TorchEnv):
    info_keys = ("reward", "length")
    max_episode_steps = 200

    def __init__(self, mask_velocity: bool = False, n_workers: int = 1,
                 device="cuda"):
        self.mask_velocity = mask_velocity
        self.n_workers = n_workers
        self.device = torch.device(device)
        self.obs_mask = torch.tensor(
            [1.0, 0.0, 1.0, 0.0] if mask_velocity else [1.0] * 4,
            device=self.device)
        self.observation_shape: Tuple[int, ...] = (4,)
        self.action_branches: Tuple[int, ...] = (2,)

    def _obs(self, state: CartPoleState) -> torch.Tensor:
        return state.physics * self.obs_mask

    def sample_reset_draws(self, generator: torch.Generator) -> torch.Tensor:
        """(W, 4) uniform in [-0.05, 0.05): the initial physics."""
        u = torch.rand(self.draw_width, 4, generator=generator,
                       device=self.device)
        return u * 0.1 - 0.05

    def reset(self, draws: torch.Tensor):
        W = draws.shape[0]
        zeros = torch.zeros(W, dtype=torch.int64, device=self.device)
        state = CartPoleState(physics=draws.float(), step_count=zeros,
                              reward_sum=torch.zeros(W, device=self.device),
                              length=zeros)
        return state, self._obs(state)

    def step(self, state: CartPoleState, actions: torch.Tensor, draws=None):
        del draws  # the step draws nothing
        x, x_dot, theta, theta_dot = state.physics.unbind(1)
        force = torch.where(actions[:, 0] == 1, FORCE_MAG, -FORCE_MAG).float()
        costheta = torch.cos(theta)
        sintheta = torch.sin(theta)
        temp = (force + POLE_MASS_LENGTH * theta_dot ** 2 * sintheta
                ) / TOTAL_MASS
        thetaacc = (GRAVITY * sintheta - costheta * temp) / (
            LENGTH * (4.0 / 3.0 - MASS_POLE * costheta ** 2 / TOTAL_MASS))
        xacc = temp - POLE_MASS_LENGTH * thetaacc * costheta / TOTAL_MASS
        x = x + TAU * x_dot
        x_dot = x_dot + TAU * xacc
        theta = theta + TAU * theta_dot
        theta_dot = theta_dot + TAU * thetaacc
        physics = torch.stack([x, x_dot, theta, theta_dot], dim=1)

        terminated = (x.abs() > X_THRESHOLD) | (theta.abs() > THETA_THRESHOLD)
        step_count = state.step_count + 1
        done = terminated | (step_count >= self.max_episode_steps)

        new_state = CartPoleState(
            physics=physics, step_count=step_count,
            reward_sum=state.reward_sum + 1.0, length=state.length + 1)
        info = {"reward": new_state.reward_sum,
                "length": new_state.length.float()}
        reward = torch.full_like(state.reward_sum, 1.0 / 100.0)
        return new_state, self._obs(new_state), reward, done, info
