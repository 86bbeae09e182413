"""Frozen plain copy of MiniGrid-Memory (the S9 flagship's env):
gym-minigrid's MemoryEnv seen through the reference's 3x3 egocentric
wrapper, its resets drawn as the benchmarked program documents its draws.
A step draws nothing. Imports nothing of the port.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

FLOOR, WALL, KEY, BALL, UNSEEN, AGENT = 0, 1, 2, 3, 4, 5
TILE = 28
DIRS = np.array([[1, 0], [0, 1], [-1, 0], [0, -1]], np.int64)


def _sprites() -> np.ndarray:
    yy, xx = np.mgrid[0:TILE, 0:TILE].astype(np.float32) / (TILE - 1)
    out = np.zeros((6, TILE, TILE, 3), np.float32)
    floor = np.zeros((TILE, TILE, 3), np.float32)
    floor[0, :, :] = 0.15
    floor[:, 0, :] = 0.15
    green = np.array([0.0, 0.88, 0.0])
    out[FLOOR] = floor
    out[WALL] = 0.4
    key = floor.copy()
    r2 = (xx - 0.5) ** 2 + (yy - 0.3) ** 2
    key[((r2 < 0.04) & (r2 > 0.012))
        | ((np.abs(xx - 0.5) < 0.06) & (yy > 0.3) & (yy < 0.85))
        | ((np.abs(yy - 0.7) < 0.045) & (xx > 0.5) & (xx < 0.7))
        | ((np.abs(yy - 0.82) < 0.045) & (xx > 0.5) & (xx < 0.65))] = green
    out[KEY] = key
    ball = floor.copy()
    ball[(xx - 0.5) ** 2 + (yy - 0.5) ** 2 < 0.11] = green
    out[BALL] = ball
    agent = floor.copy()
    agent[(yy > 0.2) & (yy < 0.85)
          & (np.abs(xx - 0.5) < 0.45 * (yy - 0.2) / 0.65)] = [0.9, 0.1, 0.1]
    out[AGENT] = agent
    return out


def _visible(opaque: np.ndarray) -> np.ndarray:
    """gym-minigrid's ``process_vis`` on the 3x3 view, the agent at row 2,
    column 1."""
    vis = np.zeros((3, 3), bool)
    vis[2, 1] = True
    for j in (2, 1, 0):
        for i in (0, 1):
            if vis[j, i] and not opaque[j, i]:
                vis[j, i + 1] = True
                if j > 0:
                    vis[j - 1, i + 1] = vis[j - 1, i] = True
        for i in (2, 1):
            if vis[j, i] and not opaque[j, i]:
                vis[j, i - 1] = True
                if j > 0:
                    vis[j - 1, i - 1] = vis[j - 1, i] = True
    return vis


class MinigridState(NamedTuple):
    grid: torch.Tensor
    pos: torch.Tensor
    dir: torch.Tensor
    success: torch.Tensor
    failure: torch.Tensor
    steps: torch.Tensor
    reward_sum: torch.Tensor


class MinigridMemory:
    """MiniGrid-MemoryS<size>: a cue in the start room, both objects at the
    end of the hallway; the cell beside the matching one pays
    ``1 - 0.9 * steps / (5 * size^2)`` and ends the episode, the other ends
    it with 0, and 96 steps end it. Actions: left, right, forward."""

    max_episode_steps = 96
    observation_shape = (3 * TILE, 3 * TILE, 3)
    action_branches = (3,)

    def __init__(self, n_workers: int, device, size: int = 9):
        self.W, self.size, self.device = n_workers, size, torch.device(device)
        g = np.zeros((size, size), np.int64)
        g[[0, -1], :] = WALL
        g[:, [0, -1]] = WALL
        up, low, end = size // 2 - 2, size // 2 + 2, size - 3
        g[up, 1:5] = g[low, 1:5] = WALL
        g[up + 1, 4] = g[low - 1, 4] = WALL
        g[up + 1, 5:end] = g[low - 1, 5:end] = WALL
        g[[j for j in range(size) if j != size // 2], end] = WALL
        self.end = end
        self.cue = (1, size // 2 - 1)
        self.top = (end + 1, size // 2 - 2)
        self.bottom = (end + 1, size // 2 + 2)
        t = lambda a, dt=torch.int64: torch.as_tensor(a, dtype=dt,
                                                      device=self.device)
        self.grid0 = t(g)
        self.dirs = t(DIRS)
        self.sprites = t(_sprites(), torch.float32)
        bits = np.arange(512)[:, None] >> np.arange(9)[None, :] & 1
        self.vis = t(np.stack([_visible(b.reshape(3, 3).astype(bool))
                               for b in bits]), torch.bool)
        self.weights = t(1 << np.arange(9)).reshape(3, 3)
        self.beside_top = t([self.top[0], self.top[1] + 1])
        self.beside_bottom = t([self.bottom[0], self.bottom[1] - 1])
        # view row 0 is the farthest: depths 2, 1, 0; columns left to right
        self.depth = t([2, 1, 0])[:, None]
        self.side = t([-1, 0, 1])[None, :]

    def observe(self, s: MinigridState) -> torch.Tensor:
        fwd, right = self.dirs[s.dir], self.dirs[(s.dir + 1) % 4]
        cells = (s.pos[:, None, None, :]
                 + self.depth[None, :, :, None] * fwd[:, None, None, :]
                 + self.side[None, :, :, None] * right[:, None, None, :])
        x, y = cells[..., 0], cells[..., 1]
        inside = (x >= 0) & (x < self.size) & (y >= 0) & (y < self.size)
        w = torch.arange(s.pos.shape[0], device=self.device)[:, None, None]
        view = torch.where(inside, s.grid[w, y.clamp(0, self.size - 1),
                                          x.clamp(0, self.size - 1)], WALL)
        pattern = ((view == WALL).long() * self.weights).sum(dim=(1, 2))
        view = torch.where(self.vis[pattern], view, UNSEEN)
        view[:, 2, 1] = AGENT
        tiles = self.sprites[view]
        return tiles.permute(0, 1, 3, 2, 4, 5).reshape(
            -1, 3 * TILE, 3 * TILE, 3)

    def reset_draws(self, gen: torch.Generator):
        bits = torch.randint(0, 2, (2, self.W), generator=gen,
                             device=self.device).bool()
        start = torch.randint(1, self.end + 1, (self.W,), generator=gen,
                              device=self.device)
        return start, bits[0], bits[1]

    def reset(self, draws):
        start, cue_key, top_key = draws
        W = start.shape[0]
        grid = self.grid0.expand(W, -1, -1).clone()
        grid[:, self.cue[1], self.cue[0]] = torch.where(cue_key, KEY, BALL)
        grid[:, self.top[1], self.top[0]] = torch.where(top_key, KEY, BALL)
        grid[:, self.bottom[1], self.bottom[0]] = torch.where(top_key, BALL,
                                                              KEY)
        match = (cue_key == top_key)[:, None]
        zeros = torch.zeros(W, dtype=torch.int64, device=self.device)
        s = MinigridState(
            grid, torch.stack([start.long(), zeros + self.size // 2], dim=1),
            zeros, torch.where(match, self.beside_top, self.beside_bottom),
            torch.where(match, self.beside_bottom, self.beside_top), zeros,
            torch.zeros(W, device=self.device))
        return s, self.observe(s)

    def step(self, s: MinigridState, actions):
        a = actions[:, 0].long()
        d = torch.where(a == 0, (s.dir + 3) % 4,
                        torch.where(a == 1, (s.dir + 1) % 4, s.dir))
        ahead = s.pos + self.dirs[d]
        w = torch.arange(s.pos.shape[0], device=self.device)
        free = (a == 2) & (s.grid[w, ahead[:, 1], ahead[:, 0]] == FLOOR)
        pos = torch.where(free[:, None], ahead, s.pos)
        steps = s.steps + 1
        won = (pos == s.success).all(dim=1)
        lost = (pos == s.failure).all(dim=1)
        reward = torch.where(won, 1.0 - 0.9 * steps.float()
                             / (5 * self.size ** 2), 0.0)
        done = won | lost | (steps >= self.max_episode_steps)
        s = MinigridState(s.grid, pos, d, s.success, s.failure, steps,
                          s.reward_sum + reward)
        info = {"reward": s.reward_sum, "length": steps.float(),
                "success": won.float()}
        return s, self.observe(s), reward, done, info


def make(env_cfg: dict, n_workers: int, device) -> MinigridMemory:
    """MiniGrid-Memory of the size the env's name gives (S9 by default)."""
    name = env_cfg.get("name", "")
    size = next((s for s in (7, 9, 11, 13, 17) if f"S{s}" in name), 9)
    return MinigridMemory(n_workers, device, size)
