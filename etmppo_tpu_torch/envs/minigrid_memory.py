"""MiniGrid-Memory (S7/S9/S11/S13), batched over workers on the device
(counterpart of ``etmppo_tpu/envs/minigrid_memory.py``).

A cue object (key or ball) sits in the start room; at the end of the hallway
a T-junction holds both object types. Stepping onto the cell next to the
object that matches the cue gives ``1 - 0.9 * step_count / (5 * size^2)`` and
ends the episode; the wrong side ends it with 0; 96 steps end it too.
Observations are the 3x3 egocentric view rendered to (84, 84, 3) HWC in
[0, 1], actions are turn-left / turn-right / forward.

The occlusion pass of the JAX env (``_process_vis_3x3``) depends only on which
of the 9 view cells are walls, so it is run once per wall pattern at
construction and becomes a (512, 3, 3) lookup table.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from .core import TorchEnv

# Cell types
FLOOR, WALL, KEY, BALL, UNSEEN = 0, 1, 2, 3, 4
NUM_CELL_TYPES = 5
TILE = 28
VIEW = 3

# dir: 0 = east(+x), 1 = south(+y), 2 = west, 3 = north  (minigrid order)
DIR_VEC = np.array([[1, 0], [0, 1], [-1, 0], [0, -1]], np.int64)


def _build_static_grid(size: int) -> Tuple[np.ndarray, tuple, tuple, tuple, int]:
    """Static wall layout of MemoryEnv. Returns (grid[y][x], cue_pos,
    obj_top_pos, obj_bottom_pos, hallway_end), positions as (x, y)."""
    if size % 2 != 1:
        raise ValueError(f"MiniGrid-Memory size must be odd, got {size}")
    g = np.zeros((size, size), np.int8)
    g[0, :] = WALL
    g[-1, :] = WALL
    g[:, 0] = WALL
    g[:, -1] = WALL
    upper = size // 2 - 2
    lower = size // 2 + 2
    hallway_end = size - 3
    for i in range(1, 5):
        g[upper, i] = WALL
        g[lower, i] = WALL
    g[upper + 1, 4] = WALL
    g[lower - 1, 4] = WALL
    for i in range(5, hallway_end):
        g[upper + 1, i] = WALL
        g[lower - 1, i] = WALL
    for j in range(size):
        if j != size // 2:
            g[j, hallway_end] = WALL
    cue_pos = (1, size // 2 - 1)
    obj_top = (hallway_end + 1, size // 2 - 2)
    obj_bottom = (hallway_end + 1, size // 2 + 2)
    return g, cue_pos, obj_top, obj_bottom, hallway_end


def _make_sprites() -> np.ndarray:
    """(NUM_CELL_TYPES + 1, TILE, TILE, 3) float32 sprites in [0, 1]; the last
    entry is the agent-on-floor tile (red triangle pointing up)."""
    yy, xx = np.mgrid[0:TILE, 0:TILE].astype(np.float32) / (TILE - 1)
    sprites = np.zeros((NUM_CELL_TYPES + 1, TILE, TILE, 3), np.float32)

    floor = np.zeros((TILE, TILE, 3), np.float32)
    floor[0, :, :] = 0.15
    floor[:, 0, :] = 0.15
    sprites[FLOOR] = floor

    sprites[WALL] = 0.4

    key = floor.copy()
    ring = ((xx - 0.5) ** 2 + (yy - 0.3) ** 2 < 0.04) & \
           ((xx - 0.5) ** 2 + (yy - 0.3) ** 2 > 0.012)
    shaft = (np.abs(xx - 0.5) < 0.06) & (yy > 0.3) & (yy < 0.85)
    tooth = (np.abs(yy - 0.7) < 0.045) & (xx > 0.5) & (xx < 0.7)
    tooth2 = (np.abs(yy - 0.82) < 0.045) & (xx > 0.5) & (xx < 0.65)
    key[ring | shaft | tooth | tooth2] = np.array([0.0, 0.88, 0.0])
    sprites[KEY] = key

    ball = floor.copy()
    circle = (xx - 0.5) ** 2 + (yy - 0.5) ** 2 < 0.11
    ball[circle] = np.array([0.0, 0.88, 0.0])
    sprites[BALL] = ball

    sprites[UNSEEN] = 0.0

    agent = floor.copy()
    tri = (yy > 0.2) & (yy < 0.85) & (np.abs(xx - 0.5) < 0.45 * (yy - 0.2) / 0.65)
    agent[tri] = np.array([0.9, 0.1, 0.1])
    sprites[NUM_CELL_TYPES] = agent
    return sprites


def _visibility_3x3(opaque: np.ndarray) -> np.ndarray:
    """minigrid's Grid.process_vis on the 3x3 egocentric view (agent at row 2,
    col 1): which cells are visible, given which are opaque (walls)."""
    vis = np.zeros((3, 3), bool)
    vis[2, 1] = True
    for j in (2, 1, 0):
        for i in range(0, 2):            # left to right
            ok = vis[j, i] and not opaque[j, i]
            vis[j, i + 1] |= ok
            if j > 0:
                vis[j - 1, i + 1] |= ok
                vis[j - 1, i] |= ok
        for i in range(2, 0, -1):        # right to left
            ok = vis[j, i] and not opaque[j, i]
            vis[j, i - 1] |= ok
            if j > 0:
                vis[j - 1, i - 1] |= ok
                vis[j - 1, i] |= ok
    return vis


def _visibility_table() -> np.ndarray:
    """(512, 3, 3) bool: visibility for every wall pattern, indexed by
    ``sum(opaque[r, c] << (3 * r + c))``."""
    bits = np.arange(512)[:, None] >> np.arange(9)[None, :] & 1
    return np.stack([_visibility_3x3(b.reshape(3, 3).astype(bool))
                     for b in bits])


class MinigridResetDraws(NamedTuple):
    """The random values one reset of all workers consumes."""
    start_x: torch.Tensor     # (W,) int64 in [1, hallway_end]
    cue_is_key: torch.Tensor  # (W,) bool
    top_is_key: torch.Tensor  # (W,) bool


class MinigridMemoryState(NamedTuple):
    grid: torch.Tensor         # (W, S, S) int64  [w][y][x]
    pos: torch.Tensor          # (W, 2) int64     (x, y)
    dir: torch.Tensor          # (W,) int64
    success_pos: torch.Tensor  # (W, 2) int64
    failure_pos: torch.Tensor  # (W, 2) int64
    step_count: torch.Tensor   # (W,) int64
    reward_sum: torch.Tensor   # (W,) float32
    length: torch.Tensor       # (W,) int64


class MinigridMemoryEnv(TorchEnv):
    info_keys = ("reward", "length", "success")
    max_episode_steps = 96  # reference wrapper cap

    def __init__(self, name: str = "MiniGrid-MemoryS9-v0", n_workers: int = 1,
                 device="cuda"):
        size = 9
        for s in (7, 9, 11, 13, 17):
            if f"S{s}" in name:
                size = s
        self.name = name
        self.size = size
        self.n_workers = n_workers
        self.device = torch.device(device)
        self.internal_max_steps = 5 * size * size
        grid, cue, obj_top, obj_bottom, hallway_end = _build_static_grid(size)
        self._cue = cue
        self._obj_top = obj_top
        self._obj_bottom = obj_bottom
        self._hallway_end = hallway_end
        as_t = lambda a, dtype=torch.int64: torch.as_tensor(
            a, dtype=dtype, device=self.device)
        self._base_grid = as_t(grid)
        self._dir_vec = as_t(DIR_VEC)
        self._sprites = as_t(_make_sprites(), torch.float32)
        self._vis_table = as_t(_visibility_table(), torch.bool)
        self._depth = as_t([2, 1, 0])[:, None]
        self._lateral = as_t([-1, 0, 1])[None, :]
        self._bit_weights = as_t(1 << np.arange(9)).reshape(3, 3)
        # The cells beside each object, made once: a reset copies no host
        # data to the device (a CUDA graph can replay it).
        self._succ_top = as_t([obj_top[0], obj_top[1] + 1])
        self._succ_bottom = as_t([obj_bottom[0], obj_bottom[1] - 1])
        self.observation_shape: Tuple[int, ...] = (TILE * VIEW, TILE * VIEW, 3)
        self.action_branches: Tuple[int, ...] = (3,)

    # --- observation ------------------------------------------------------

    def _observe(self, state: MinigridMemoryState) -> torch.Tensor:
        W = state.pos.shape[0]
        fwd = self._dir_vec[state.dir]                       # (W, 2)
        right = self._dir_vec[(state.dir + 1) % 4]
        # view[row, col]: row 0 = farthest (depth 2), agent at (row 2, col 1)
        world = (state.pos[:, None, None, :]
                 + self._depth[None, :, :, None] * fwd[:, None, None, :]
                 + self._lateral[None, :, :, None] * right[:, None, None, :])
        x = world[..., 0].clamp(0, self.size - 1)
        y = world[..., 1].clamp(0, self.size - 1)
        in_bounds = ((world[..., 0] >= 0) & (world[..., 0] < self.size)
                     & (world[..., 1] >= 0) & (world[..., 1] < self.size))
        w = torch.arange(W, device=self.device)[:, None, None]
        view = torch.where(in_bounds, state.grid[w, y, x], WALL)   # (W, 3, 3)
        pattern = ((view == WALL).long() * self._bit_weights).sum(dim=(1, 2))
        view = torch.where(self._vis_table[pattern], view, UNSEEN)
        view[:, 2, 1].fill_(NUM_CELL_TYPES)                  # agent tile
        tiles = self._sprites[view]                          # (W, 3, 3, T, T, 3)
        return tiles.permute(0, 1, 3, 2, 4, 5).reshape(
            W, VIEW * TILE, VIEW * TILE, 3)

    # --- protocol ---------------------------------------------------------

    def sample_reset_draws(self, generator: torch.Generator
                           ) -> MinigridResetDraws:
        W = self.draw_width
        bits = torch.randint(0, 2, (2, W), generator=generator,
                             device=self.device).bool()
        start_x = torch.randint(1, self._hallway_end + 1, (W,),
                                generator=generator, device=self.device)
        return MinigridResetDraws(start_x, bits[0], bits[1])

    def reset(self, draws: MinigridResetDraws):
        W = draws.start_x.shape[0]
        grid = self._base_grid.expand(W, -1, -1).clone()
        cue_obj = torch.where(draws.cue_is_key, KEY, BALL)
        top_obj = torch.where(draws.top_is_key, KEY, BALL)
        bottom_obj = torch.where(draws.top_is_key, BALL, KEY)
        grid[:, self._cue[1], self._cue[0]] = cue_obj
        grid[:, self._obj_top[1], self._obj_top[0]] = top_obj
        grid[:, self._obj_bottom[1], self._obj_bottom[0]] = bottom_obj

        # success next to the object matching the cue
        top_matches = (draws.cue_is_key == draws.top_is_key)[:, None]
        succ_top, succ_bottom = self._succ_top, self._succ_bottom
        success_pos = torch.where(top_matches, succ_top, succ_bottom)
        failure_pos = torch.where(top_matches, succ_bottom, succ_top)

        pos = torch.stack([draws.start_x.long(),
                           torch.full_like(draws.start_x.long(),
                                           self.size // 2)], dim=1)
        zeros = torch.zeros(W, dtype=torch.int64, device=self.device)
        state = MinigridMemoryState(
            grid=grid, pos=pos, dir=zeros, success_pos=success_pos,
            failure_pos=failure_pos, step_count=zeros,
            reward_sum=torch.zeros(W, device=self.device), length=zeros)
        return state, self._observe(state)

    def step(self, state: MinigridMemoryState, actions: torch.Tensor,
             draws=None):
        del draws  # the step draws nothing
        W = state.pos.shape[0]
        a = actions[:, 0].long()
        d = torch.where(a == 0, (state.dir - 1) % 4,
                        torch.where(a == 1, (state.dir + 1) % 4, state.dir))
        fwd_pos = state.pos + self._dir_vec[d]
        w = torch.arange(W, device=self.device)
        cell = state.grid[w, fwd_pos[:, 1], fwd_pos[:, 0]]
        can_move = (a == 2) & (cell == FLOOR)
        pos = torch.where(can_move[:, None], fwd_pos, state.pos)

        step_count = state.step_count + 1
        at_success = (pos == state.success_pos).all(dim=1)
        at_failure = (pos == state.failure_pos).all(dim=1)
        reward = torch.where(
            at_success,
            1.0 - 0.9 * step_count.float() / self.internal_max_steps,
            0.0)
        done = at_success | at_failure | (step_count >= self.max_episode_steps)

        new_state = MinigridMemoryState(
            grid=state.grid, pos=pos, dir=d, success_pos=state.success_pos,
            failure_pos=state.failure_pos, step_count=step_count,
            reward_sum=state.reward_sum + reward, length=state.length + 1)
        info = {"reward": new_state.reward_sum,
                "length": new_state.length.float(),
                "success": at_success.float()}
        return new_state, self._observe(new_state), reward, done, info
