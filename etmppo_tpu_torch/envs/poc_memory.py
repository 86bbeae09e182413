"""Proof-of-concept memory environment, batched over workers on the device
(counterpart of ``etmppo_tpu/envs/poc_memory.py``).

A 1-D track with a goal at each end, one +1 and one -1, shown only for the
first two steps; the agent (frozen during that show phase with ``freeze``)
must remember which end rewards. Reaching an end pays +-(1 + min_steps *
0.1) and ends the episode; every other step costs 0.1; ``max_episode_steps``
ends it too. Positions are integer ticks (1 tick = ``step_size``), so the
goal checks are exact. Observations are ``[goal_0, position, goal_1]``, the
goals zero after the show phase; one branch of 2 actions (left, right).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from .core import TorchEnv


class PocMemoryResetDraws(NamedTuple):
    """The random values one reset of all workers consumes."""
    start: torch.Tensor    # (W,) int64 index into the env's start ticks
    swapped: torch.Tensor  # (W,) bool: goals (+1, -1) rather than (-1, +1)


class PocMemoryState(NamedTuple):
    ticks: torch.Tensor       # (W,) int64 position in units of step_size
    goals: torch.Tensor       # (W, 2) float32, each +-1
    step_count: torch.Tensor  # (W,) int64
    reward_sum: torch.Tensor  # (W,) float32 running episode return
    length: torch.Tensor      # (W,) int64


class PocMemoryEnv(TorchEnv):
    info_keys = ("reward", "length", "success")

    def __init__(self, step_size: float = 0.2, glob: bool = False,
                 freeze: bool = False, max_episode_steps: int = -1,
                 n_workers: int = 1, device="cuda"):
        self.step_size = step_size
        self.freeze = freeze
        self.max_episode_steps = max_episode_steps
        self.min_steps = int(1.0 / step_size) + 1
        self.time_penalty = 0.1
        self.num_show_steps = 2
        self.goal_ticks = int(round(1.0 / step_size))
        self.n_workers = n_workers
        self.device = torch.device(device)

        # Possible start positions, in ticks.
        num_steps = int(0.4 / step_size)
        if not glob:
            lower = min(-2.0 * step_size, -num_steps * step_size)
            upper = max(3.0 * step_size, step_size, (num_steps + 1) * step_size)
        else:
            lower = -1 + step_size
            upper = 1
        positions = np.arange(lower, upper, step_size).clip(
            -1 + step_size, 1 - step_size)
        self.start_ticks = torch.as_tensor(
            np.unique(np.round(positions / step_size).astype(np.int64)),
            device=self.device)
        # Made once: a reset copies no host data to the device (a CUDA graph
        # can replay it).
        self._minus_plus = torch.tensor([-1.0, 1.0], device=self.device)

        self.observation_shape: Tuple[int, ...] = (3,)
        self.action_branches: Tuple[int, ...] = (2,)

    def _obs(self, state: PocMemoryState, show_goals) -> torch.Tensor:
        pos = state.ticks.float() * self.step_size
        goals = torch.where(show_goals.reshape(-1, 1), state.goals, 0.0)
        return torch.stack([goals[:, 0], pos, goals[:, 1]], dim=1)

    def sample_reset_draws(self, generator: torch.Generator
                           ) -> PocMemoryResetDraws:
        W = self.draw_width
        start = torch.randint(0, len(self.start_ticks), (W,),
                              generator=generator, device=self.device)
        swapped = torch.rand(W, generator=generator, device=self.device) < 0.5
        return PocMemoryResetDraws(start, swapped)

    def reset(self, draws: PocMemoryResetDraws):
        W = draws.start.shape[0]
        goals = torch.where(draws.swapped[:, None], self._minus_plus.flip(0),
                            self._minus_plus)
        zeros = torch.zeros(W, dtype=torch.int64, device=self.device)
        state = PocMemoryState(
            ticks=self.start_ticks[draws.start.long()], goals=goals,
            step_count=zeros, reward_sum=torch.zeros(W, device=self.device),
            length=zeros)
        return state, self._obs(state, show_goals=torch.ones(
            W, dtype=torch.bool, device=self.device))

    def render_ascii(self, state: PocMemoryState, worker: int = 0) -> str:
        """One worker's track as text: the agent ``a``, each goal ``+`` or
        ``-``, and whether the goals are still shown."""
        n = self.goal_ticks
        tick = int(state.ticks[worker])
        goals = state.goals[worker].tolist()
        cells = []
        for i in range(-n, n + 1):
            if tick == i:
                cells.append("a")
            elif i == -n:
                cells.append("+" if goals[0] > 0 else "-")
            elif i == n:
                cells.append("+" if goals[1] > 0 else "-")
            else:
                cells.append(" ")
        shown = int(state.step_count[worker]) < self.num_show_steps
        return "|" + "|".join(cells) + "|  goals shown: " + str(shown)

    def step(self, state: PocMemoryState, actions: torch.Tensor, draws=None):
        del draws  # the step draws nothing
        time_done = (self.max_episode_steps > 0) & (
            state.step_count >= self.max_episode_steps - 1)
        in_show = state.step_count < self.num_show_steps

        move = torch.where(actions[:, 0] == 1, 1, -1)
        frozen = in_show & self.freeze
        ticks = state.ticks + torch.where(frozen, 0, move)

        at_neg = ticks == -self.goal_ticks
        at_pos = ticks == self.goal_ticks
        bonus = 1.0 + self.min_steps * self.time_penalty
        neg_good = state.goals[:, 0] == 1.0
        pos_good = state.goals[:, 1] == 1.0
        signed = lambda good: torch.where(good, bonus, -bonus)
        goal_reward = torch.where(at_neg, signed(neg_good), signed(pos_good))
        reward = torch.where(at_neg | at_pos, goal_reward, -self.time_penalty)
        # Frozen show-phase steps pay nothing and check no goal.
        reward = torch.where(frozen, 0.0, reward).float()
        success = ~frozen & ((at_neg & neg_good) | (at_pos & pos_good))
        done = time_done | (~frozen & (at_neg | at_pos))

        new_state = PocMemoryState(
            ticks=ticks, goals=state.goals, step_count=state.step_count + 1,
            reward_sum=state.reward_sum + reward, length=state.length + 1)
        info = {"reward": new_state.reward_sum,
                "length": new_state.length.float(),
                "success": success.float()}
        return new_state, self._obs(new_state, in_show), reward, done, info
