"""Frozen plain copy of Mystery Path Grid: memory-gym's Mystery Path on a
grid, its resets drawn as the benchmarked program documents its draws. A
step draws nothing. Imports nothing of the port.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class PathState(NamedTuple):
    on_path: torch.Tensor
    progress: torch.Tensor
    origin: torch.Tensor
    goal: torch.Tensor
    pos: torch.Tensor
    best: torch.Tensor
    fall_pos: torch.Tensor
    fall_timer: torch.Tensor
    t: torch.Tensor
    reward_sum: torch.Tensor


class MysteryPathGrid:
    """Mystery Path on an S x S grid: an invisible path from an origin on
    one edge to a goal on the opposite one, drawn as a biased walk (forward
    1/2, sideways 1/4 each, never back, forced forward once the moves left
    equal the distance left); leaving it sends the agent back to the origin
    with a step of visual feedback; the goal pays ``reward_goal`` and ends
    the episode; 128 steps end it. Actions: up, right, down, left."""

    max_episode_steps = 128
    observation_shape = (84, 84, 3)
    action_branches = (4,)

    def __init__(self, params: dict, n_workers: int, device):
        self.W, self.device = n_workers, torch.device(device)
        S = self.S = int(params.get("arena_size", 7))
        self.choices = [int(c) for c in params.get("cardinal_origin_choice",
                                                   [0, 1, 2, 3])]
        self.show_origin = bool(params.get("show_origin", False))
        self.show_goal = bool(params.get("show_goal", False))
        self.feedback = bool(params.get("visual_feedback", True))
        self.r_goal = float(params.get("reward_goal", 1.0))
        self.r_fall = float(params.get("reward_fall_off", 0.0))
        self.r_progress = float(params.get("reward_path_progress", 0.0))
        self.n_moves = 3 * S - 1
        tile = 84 // S
        off = (84 - tile * S) // 2
        yy, xx = np.mgrid[0:84, 0:84]
        inside = ((xx >= off) & (xx < off + S * tile) & (yy >= off)
                  & (yy < off + S * tile))
        cx = np.clip((xx - off) // tile, 0, S - 1)
        cy = np.clip((yy - off) // tile, 0, S - 1)
        base = np.where(inside & ((cx + cy) % 2 == 0), 0.18, 0.24)
        t = lambda a, dt=torch.int64: torch.as_tensor(a, dtype=dt,
                                                      device=self.device)
        self.inside, self.cx, self.cy = t(inside, torch.bool), t(cx), t(cy)
        self.base = t(np.repeat(base[:, :, None], 3, 2), torch.float32)
        self.moves = t([[0, -1], [1, 0], [0, 1], [-1, 0]])
        self.choice_table = t(self.choices)
        self.colors = {k: t(v, torch.float32) for k, v in (
            ("origin", [0.2, 0.8, 0.2]), ("goal", [0.9, 0.8, 0.1]),
            ("fall", [0.85, 0.1, 0.1]), ("agent", [0.1, 0.3, 0.95]))}

    def _xy(self, edge, fwd, lat):
        far = self.S - 1 - fwd
        x = torch.where(edge == 0, fwd, torch.where(edge == 2, far, lat))
        y = torch.where(edge == 1, fwd, torch.where(edge == 3, far, lat))
        return x, y

    def reset_draws(self, gen: torch.Generator):
        W, S = self.W, self.S
        choice = torch.randint(0, len(self.choices), (W,), generator=gen,
                               device=self.device)
        lat0 = torch.randint(0, S, (W,), generator=gen, device=self.device)
        u = torch.rand(W, self.n_moves, generator=gen, device=self.device)
        return (self.choice_table[choice], lat0,
                (u >= 0.5).long() + (u >= 0.75).long())

    def reset(self, draws):
        edge, lat0, moves = draws
        S, W = self.S, edge.shape[0]
        edge = edge.long()[:, None]
        fwd = torch.zeros(W, dtype=torch.int64, device=self.device)
        lat = lat0.long().clone()
        over = torch.zeros(W, dtype=torch.bool, device=self.device)
        fwds, lats = [fwd], [lat]
        for i in range(self.n_moves):
            move = torch.where(self.n_moves - i <= S - 1 - fwd, 0,
                               moves[:, i])
            side = torch.where(move == 1, 1, torch.where(move == 2, -1, 0))
            lat = torch.where(over, lat, (lat + side).clamp(0, S - 1))
            fwd = torch.where(over | (move != 0), fwd, fwd + 1)
            over = over | (fwd >= S - 1)
            fwds.append(fwd)
            lats.append(lat)
        xs, ys = self._xy(edge, torch.stack(fwds, 1), torch.stack(lats, 1))
        cells = ys * S + xs
        on_path = torch.zeros(W, S * S, dtype=torch.bool, device=self.device)
        on_path.scatter_(1, cells, True)
        order = torch.arange(cells.shape[1], device=self.device)
        first = torch.full((W, S * S), cells.shape[1], dtype=torch.int64,
                           device=self.device)
        first.scatter_reduce_(1, cells, order.expand(W, -1), reduce="amin")
        progress = torch.where(on_path, first, -1)
        origin = torch.stack(self._xy(edge[:, 0], torch.zeros_like(lat),
                                      lat0.long()), dim=1)
        goal = torch.stack([xs[:, -1], ys[:, -1]], dim=1)
        zeros = torch.zeros(W, dtype=torch.int64, device=self.device)
        s = PathState(on_path.reshape(W, S, S), progress.reshape(W, S, S),
                      origin, goal, origin.clone(), zeros,
                      torch.full((W, 2), -1, dtype=torch.int64,
                                 device=self.device), zeros, zeros,
                      torch.zeros(W, device=self.device))
        return s, self.observe(s)

    def observe(self, s: PathState) -> torch.Tensor:
        img = self.base.expand(s.pos.shape[0], -1, -1, -1)

        def mark(img, pos, color, cond=None):
            on = ((self.cx == pos[:, 0, None, None])
                  & (self.cy == pos[:, 1, None, None]) & self.inside)
            if cond is not None:
                on = on & cond[:, None, None]
            return torch.where(on[..., None], self.colors[color], img)
        if self.show_origin:
            img = mark(img, s.origin, "origin")
        if self.show_goal:
            img = mark(img, s.goal, "goal")
        if self.feedback:
            img = mark(img, s.fall_pos, "fall", s.fall_timer > 0)
        return mark(img, s.pos, "agent").clamp(0.0, 1.0)

    def step(self, s: PathState, actions):
        w = torch.arange(s.pos.shape[0], device=self.device)
        new = (s.pos + self.moves[actions[:, 0].long()]).clamp(0, self.S - 1)
        on = s.on_path[w, new[:, 1], new[:, 0]]
        at_goal = (new == s.goal).all(dim=1)
        prog = torch.where(on, s.progress[w, new[:, 1], new[:, 0]], 0)
        zero = torch.zeros(s.pos.shape[0], device=self.device)
        reward = (torch.where(at_goal, self.r_goal, zero)
                  + torch.where(~on, self.r_fall, zero)
                  + torch.where(on & (prog > s.best), self.r_progress, zero))
        t = s.t + 1
        done = at_goal | (t >= self.max_episode_steps)
        s = PathState(s.on_path, s.progress, s.origin, s.goal,
                      torch.where(on[:, None], new, s.origin),
                      torch.maximum(s.best, prog),
                      torch.where(on[:, None], s.fall_pos, new),
                      torch.where(on, (s.fall_timer - 1).clamp(min=0), 1), t,
                      s.reward_sum + reward)
        info = {"reward": s.reward_sum, "length": t.float(),
                "success": at_goal.float()}
        return s, self.observe(s), reward, done, info


def make(env_cfg: dict, n_workers: int, device) -> MysteryPathGrid:
    return MysteryPathGrid(env_cfg.get("reset_params", {}), n_workers,
                           device)
