"""Frozen plain copies of the two device envs the training cells step:
MiniGrid-Memory (the S9 flagship) and Mystery Path Grid.

They follow the environments as published (gym-minigrid's MemoryEnv seen
through the reference's 3x3 egocentric wrapper; memory-gym's Mystery Path
on a grid) and draw their resets as the benchmarked program documents its
draws: each reset takes its values from a generator in a fixed order, so
that the reference, seeded alike, steps the same episodes. A step draws
nothing. Imports nothing of the port.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

FLOOR, WALL, KEY, BALL, UNSEEN, AGENT = 0, 1, 2, 3, 4, 5
TILE = 28
DIRS = np.array([[1, 0], [0, 1], [-1, 0], [0, -1]], np.int64)


def where_rows(mask, new, old):
    """Field-wise ``where(mask[w], new, old)`` over a state's worker axis."""
    return type(old)(*(torch.where(mask.reshape((-1,) + (1,) * (a.dim() - 1)),
                                   a, b) for a, b in zip(new, old)))


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


def make_env(env_cfg: dict, n_workers: int, device):
    """The reference env of a configuration's ``environment``."""
    if env_cfg["type"] == "Minigrid":
        name = env_cfg.get("name", "")
        size = next((s for s in (7, 9, 11, 13, 17) if f"S{s}" in name), 9)
        return MinigridMemory(n_workers, device, size)
    if env_cfg["type"] == "MysteryPath-Grid":
        return MysteryPathGrid(env_cfg.get("reset_params", {}), n_workers,
                               device)
    raise NotImplementedError(f"no reference env for {env_cfg['type']!r}")
