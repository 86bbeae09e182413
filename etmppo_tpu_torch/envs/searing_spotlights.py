"""Searing Spotlights, batched over workers on the device
(counterpart of ``etmppo_tpu/envs/searing_spotlights.py``).

The arena is lit for the first ``SHOW_STEPS`` steps, then dark: the scene
(exit, coin, agent) shows only inside four roaming spotlights, which also
damage the agent. It must track its own position from memory, collect the
coin, then reach the exit. Rewards: the coin, the exit, each hit and death,
all from ``reset_params``; the episode ends at the exit, at death or after
256 steps. Actions are two branches of 3 (dx, dy in {-1, 0, +1}).
Observations are 84x84x3 HWC in [0, 1], rendered for all workers at once.

Spotlights drift toward their targets and draw new ones on arrival: the
step's draws (``sample_step_draws``) are every worker's candidate targets.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from .core import TorchEnv

N_SPOTS = 4
SHOW_STEPS = 6          # fully lit initial phase
AGENT_SPEED = 0.035
SPOT_SPEED = 0.02
SPOT_RADIUS = 0.16
AGENT_RADIUS = 0.035
COIN_RADIUS = 0.04
EXIT_RADIUS = 0.05
SIZE = 84


class SearingSpotlightsResetDraws(NamedTuple):
    """The random values one reset of all workers consumes, in their
    ranges."""
    pos: torch.Tensor      # (W, 2) in [0.15, 0.85)
    coin: torch.Tensor     # (W, 2) in [0.1, 0.9)
    exit: torch.Tensor     # (W, 2) in [0.1, 0.9)
    spots: torch.Tensor    # (W, N_SPOTS, 2) in [0, 1)
    targets: torch.Tensor  # (W, N_SPOTS, 2) in [0, 1)


class SearingSpotlightsState(NamedTuple):
    pos: torch.Tensor             # (W, 2) float32 agent position in [0, 1]^2
    health: torch.Tensor          # (W,) float32
    coin_pos: torch.Tensor        # (W, 2)
    coin_collected: torch.Tensor  # (W,) bool
    exit_pos: torch.Tensor        # (W, 2)
    spot_pos: torch.Tensor        # (W, N_SPOTS, 2)
    spot_target: torch.Tensor     # (W, N_SPOTS, 2)
    t: torch.Tensor               # (W,) int64
    reward_sum: torch.Tensor      # (W,) float32
    length: torch.Tensor          # (W,) int64


def _norm(v: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the last axis (of size 2)."""
    return torch.sqrt((v * v).sum(-1))


class SearingSpotlightsEnv(TorchEnv):
    info_keys = ("reward", "length", "success")
    max_episode_steps = 256

    def __init__(self, reset_params: Dict, n_workers: int = 1, device="cuda"):
        p = dict(reset_params or {})
        self.initial_health = float(p.get("agent_health", 100.0))
        self.damage = float(p.get("spot_damage", 2.5))
        self.r_coin = float(p.get("reward_coin", 0.25))
        self.r_exit = float(p.get("reward_exit", 1.0))
        self.r_damage = float(p.get("reward_damage", 0.0))
        self.r_death = float(p.get("reward_death", 0.0))
        self.n_workers = n_workers
        self.device = torch.device(device)
        self.observation_shape: Tuple[int, ...] = (SIZE, SIZE, 3)
        self.action_branches: Tuple[int, ...] = (3, 3)
        # Pixel centres, one row of x and one column of y.
        self._centres = (torch.arange(SIZE, device=self.device).float()
                         + 0.5) / SIZE
        self._colors = {name: torch.tensor(c, device=self.device) for name, c
                        in (("exit", [0.1, 0.8, 0.2]),
                            ("coin", [0.95, 0.85, 0.1]),
                            ("agent", [0.9, 0.15, 0.1]))}

    # --- rendering -------------------------------------------------------

    def _disk(self, centre: torch.Tensor, radius: float) -> torch.Tensor:
        """(..., 84, 84) bool [y][x]: the pixel centres strictly inside the
        disk around each centre (..., 2)."""
        dx = (self._centres - centre[..., 0:1]) ** 2          # (..., 84) by x
        dy = (self._centres - centre[..., 1:2]) ** 2          # (..., 84) by y
        return dx[..., None, :] + dy[..., :, None] < radius ** 2

    def _observe(self, state: SearingSpotlightsState) -> torch.Tensor:
        W = state.pos.shape[0]
        scene = torch.full((W, SIZE, SIZE, 3), 0.25, device=self.device)
        layers = (
            ("exit", self._disk(state.exit_pos, EXIT_RADIUS)),
            ("coin", self._disk(state.coin_pos, COIN_RADIUS)
             & ~state.coin_collected[:, None, None]),
            ("agent", self._disk(state.pos, AGENT_RADIUS)))
        for name, on in layers:
            scene = torch.where(on[..., None], self._colors[name], scene)
        lit = (state.t < SHOW_STEPS)[:, None, None]
        visible = lit | self._disk(state.spot_pos, SPOT_RADIUS).any(dim=1)
        return torch.where(visible[..., None], scene, 0.0)

    # --- protocol --------------------------------------------------------

    def sample_reset_draws(self, generator: torch.Generator
                           ) -> SearingSpotlightsResetDraws:
        W = self.draw_width

        def uniform(shape, low, high):
            u = torch.rand((W,) + shape, generator=generator,
                           device=self.device)
            return low + u * (high - low)
        return SearingSpotlightsResetDraws(
            pos=uniform((2,), 0.15, 0.85), coin=uniform((2,), 0.1, 0.9),
            exit=uniform((2,), 0.1, 0.9), spots=uniform((N_SPOTS, 2), 0.0, 1.0),
            targets=uniform((N_SPOTS, 2), 0.0, 1.0))

    def sample_step_draws(self, generator: torch.Generator) -> torch.Tensor:
        """(W, N_SPOTS, 2) uniform in [0, 1): the targets a spotlight takes
        if it arrives at its current one."""
        return torch.rand(self.draw_width, N_SPOTS, 2, generator=generator,
                          device=self.device)

    def reset(self, draws: SearingSpotlightsResetDraws):
        W = draws.pos.shape[0]
        zeros = torch.zeros(W, dtype=torch.int64, device=self.device)
        state = SearingSpotlightsState(
            pos=draws.pos.float(),
            health=torch.full((W,), self.initial_health, device=self.device),
            coin_pos=draws.coin.float(),
            coin_collected=torch.zeros(W, dtype=torch.bool,
                                       device=self.device),
            exit_pos=draws.exit.float(), spot_pos=draws.spots.float(),
            spot_target=draws.targets.float(), t=zeros,
            reward_sum=torch.zeros(W, device=self.device), length=zeros)
        return state, self._observe(state)

    def step(self, state: SearingSpotlightsState, actions: torch.Tensor,
             draws: torch.Tensor = None):
        """``draws``: (W, N_SPOTS, 2) from ``sample_step_draws``."""
        if draws is None:
            raise ValueError("a Searing Spotlights step needs its step draws")
        move = (actions.float() - 1.0) * AGENT_SPEED
        pos = (state.pos + move).clamp(0.0 + AGENT_RADIUS, 1.0 - AGENT_RADIUS)

        # Spotlights drift toward their targets; a new target on arrival.
        delta = state.spot_target - state.spot_pos
        dist = _norm(delta)[..., None]                        # (W, N, 1)
        step_vec = torch.where(dist > 1e-6, delta / (dist + 1e-9), 0.0)
        spot_pos = state.spot_pos + step_vec * SPOT_SPEED
        arrived = dist < SPOT_SPEED * 1.5
        spot_target = torch.where(arrived, draws, state.spot_target)

        in_spot = (_norm(spot_pos - pos[:, None, :])
                   < SPOT_RADIUS + AGENT_RADIUS).any(dim=1)
        hit = in_spot & (state.t >= SHOW_STEPS)
        zero = torch.zeros_like(state.health)
        health = state.health - torch.where(hit, self.damage, zero)

        got_coin = ~state.coin_collected & (
            _norm(pos - state.coin_pos) < COIN_RADIUS + AGENT_RADIUS)
        coin_collected = state.coin_collected | got_coin
        at_exit = coin_collected & (
            _norm(pos - state.exit_pos) < EXIT_RADIUS + AGENT_RADIUS)
        dead = health <= 0.0

        t = state.t + 1
        reward = (torch.where(got_coin, self.r_coin, zero)
                  + torch.where(at_exit, self.r_exit, zero)
                  + torch.where(hit, self.r_damage, zero)
                  + torch.where(dead, self.r_death, zero))
        done = at_exit | dead | (t >= self.max_episode_steps)

        new_state = SearingSpotlightsState(
            pos=pos, health=health, coin_pos=state.coin_pos,
            coin_collected=coin_collected, exit_pos=state.exit_pos,
            spot_pos=spot_pos, spot_target=spot_target, t=t,
            reward_sum=state.reward_sum + reward, length=state.length + 1)
        info = {"reward": new_state.reward_sum,
                "length": new_state.length.float(),
                "success": at_exit.float()}
        return new_state, self._observe(new_state), reward, done, info
