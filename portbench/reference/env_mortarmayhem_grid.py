"""Frozen plain copy of Mortar Mayhem Grid: memory-gym's Mortar Mayhem on a
grid, as the benchmarked program defines it.

A reset draws ``command_count`` movement commands, each uniform among
those whose target stays in the arena when walked from its centre. They
are announced one at a time, each shown for 3 steps as a glyph in a strip
at the top and followed by 1 blank step, while the agent stays frozen in
the centre. Then each command is executed in turn: within
``explosion_delay`` steps the agent has to reach its tile, and hold it for
``explosion_duration`` steps while every other tile of the arena explodes
(drawn red). Holding the tile to its last step verifies the command
(``reward_command_success``); standing anywhere else while tiles explode
fails (``reward_command_failure``) and ends the episode; the last command
verified adds ``reward_episode_success`` and ends it; and it ends after
``C * (3 + 1) + C * (delay + duration)`` steps (120 at 10 commands).

Observations are 84x84x3 HWC in [0, 1]; the actions are the first
``allowed_commands`` of stay, up, right, down, left and the diagonals. A
reset takes, for each command in turn, one ``torch.rand(W)`` from the
generator; a step draws nothing. Imports nothing of the port.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

# stay, up (-y), right (+x), down (+y), left (-x), then the diagonals
MOVES = np.array([[0, 0], [0, -1], [1, 0], [0, 1], [-1, 0],
                  [1, -1], [1, 1], [-1, 1], [-1, -1]], np.int64)
SHOWN, BLANK = 3, 1
GLYPH = 20
BASE = (0.18, 0.24)
EXPLOSION_RED = 0.7
AGENT_RGB = (0.1, 0.3, 0.95)


def glyph_masks() -> np.ndarray:
    """(9, GLYPH, GLYPH) bool: a square for stay, a triangle pointing each
    cardinal way, a corner triangle for each diagonal."""
    yy, xx = np.mgrid[0:GLYPH, 0:GLYPH].astype(np.float32) / (GLYPH - 1)
    down = (np.abs(xx - 0.5) < (yy - 0.1) * 0.6) & (yy > 0.1) & (yy < 0.9)
    return np.stack([
        (np.abs(xx - 0.5) < 0.22) & (np.abs(yy - 0.5) < 0.22),
        np.rot90(down, k=2), np.rot90(down, k=1), down, np.rot90(down, k=3),
        xx - yy > 0.25, xx + yy > 1.25, yy - xx > 0.25, xx + yy < 0.75])


class MortarState(NamedTuple):
    pos: torch.Tensor        # (W, 2) x, y
    commands: torch.Tensor   # (W, C)
    targets: torch.Tensor    # (W, C, 2) the tile each command leads to
    t: torch.Tensor          # (W,) steps since the reset
    verified: torch.Tensor   # (W,) commands verified
    reward_sum: torch.Tensor


class MortarMayhemGrid:
    observation_shape = (84, 84, 3)

    def __init__(self, params: dict, n_workers: int, device):
        self.W, self.device = n_workers, torch.device(device)
        A = self.A = int(params.get("arena_size", 5))
        self.n_actions = int(params.get("allowed_commands", 5))
        self.C = int(np.max(params.get("command_count", [10])))
        self.duration = int(np.max(params.get("explosion_duration", [2])))
        self.delay = int(np.max(params.get("explosion_delay", [6])))
        self.r_fail = float(params.get("reward_command_failure", 0.0))
        self.r_success = float(params.get("reward_command_success", 0.1))
        self.r_episode = float(params.get("reward_episode_success", 0.0))
        self.announce = self.C * (SHOWN + BLANK)
        self.per_command = self.delay + self.duration
        self.max_episode_steps = self.announce + self.C * self.per_command
        self.action_branches = (self.n_actions,)
        tile = 84 // A
        off = (84 - tile * A) // 2
        yy, xx = np.mgrid[0:84, 0:84]
        cx, cy = (xx - off) // tile, (yy - off) // tile
        inside = (cx >= 0) & (cx < A) & (cy >= 0) & (cy < A)
        t = lambda a, dt=torch.int64: torch.as_tensor(a, dtype=dt,
                                                      device=self.device)
        # each pixel's tile as y * A + x, -1 off the arena
        self.tile_of = t(np.where(inside, cy * A + cx, -1))
        self.base = t(np.where(inside & ((cx + cy) % 2 == 0), *BASE),
                      torch.float32)
        self.agent_rgb = t(AGENT_RGB, torch.float32)
        self.moves = t(MOVES[:self.n_actions])
        self.glyphs = t(glyph_masks(), torch.bool)
        self.centre = t([A // 2, A // 2])
        self.strip = (slice(1, 1 + GLYPH),
                      slice(42 - GLYPH // 2, 42 + GLYPH // 2))

    def phase(self, t):
        """Of episode step t: announcing, the command shown and whether it
        is shown, the command executed and whether its tiles explode."""
        period = SHOWN + BLANK
        announcing = t < self.announce
        shown = (t // period).clamp(max=self.C - 1)
        showing = t % period < SHOWN
        te = t - self.announce
        executed = (te // self.per_command).clamp(0, self.C - 1)
        exploding = te % self.per_command >= self.delay
        return announcing, shown, showing, executed, exploding

    def reset_draws(self, gen: torch.Generator):
        """The commands, one uniform per command: the k-th of the moves
        that keep the walk from the centre inside the arena, k the uniform
        times their number, rounded down."""
        w = torch.arange(self.W, device=self.device)
        pos = self.centre.expand(self.W, 2)
        commands = []
        for _ in range(self.C):
            ahead = pos[:, None, :] + self.moves
            ok = ((ahead >= 0) & (ahead < self.A)).all(dim=2)
            u = torch.rand(self.W, generator=gen, device=self.device)
            k = (u * ok.sum(dim=1)).long()
            # the allowed moves first, each part in the order of its ids
            order = torch.sort((~ok).long(), dim=1, stable=True).indices
            command = order[w, k]
            commands.append(command)
            pos = ahead[w, command]
        return torch.stack(commands, dim=1)

    def reset(self, commands):
        W = commands.shape[0]
        targets = self.centre + torch.cumsum(self.moves[commands], dim=1)
        zeros = torch.zeros(W, dtype=torch.int64, device=self.device)
        s = MortarState(self.centre.expand(W, 2).clone(), commands, targets,
                        zeros, zeros, torch.zeros(W, device=self.device))
        return s, self.observe(s)

    def observe(self, s: MortarState) -> torch.Tensor:
        W = s.pos.shape[0]
        w = torch.arange(W, device=self.device)
        announcing, shown, showing, executed, exploding = self.phase(s.t)

        def on(xy):
            return self.tile_of == (xy[:, 1] * self.A + xy[:, 0])[:, None,
                                                                  None]
        target = s.targets[w, executed]
        red = ((~announcing & exploding)[:, None, None]
               & (self.tile_of >= 0) & ~on(target))
        img = self.base[None, :, :, None].repeat(W, 1, 1, 3)
        img[..., 0] = img[..., 0] + torch.where(red, EXPLOSION_RED, 0.0)
        img = torch.where(on(s.pos)[..., None], self.agent_rgb, img)
        glyph = (self.glyphs[s.commands[w, shown]]
                 & (announcing & showing)[:, None, None])
        rows, cols = self.strip
        img[:, rows, cols] = torch.where(glyph[..., None], 1.0,
                                         img[:, rows, cols])
        return img

    def step(self, s: MortarState, actions):
        W = s.pos.shape[0]
        w = torch.arange(W, device=self.device)
        announcing, _, _, executed, exploding = self.phase(s.t)
        moved = (s.pos + self.moves[actions[:, 0].long()]).clamp(0,
                                                                 self.A - 1)
        pos = torch.where(announcing[:, None], s.pos, moved)
        on_target = (pos == s.targets[w, executed]).all(dim=1)
        failed = ~announcing & exploding & ~on_target
        last = (s.t - self.announce) % self.per_command == self.per_command - 1
        ok = ~announcing & last & on_target & ~failed
        verified = s.verified + ok.long()
        finished = verified >= self.C
        reward = (torch.where(ok, self.r_success,
                              torch.where(failed, self.r_fail, 0.0))
                  + torch.where(finished & ok, self.r_episode, 0.0))
        t = s.t + 1
        done = failed | finished | (t >= self.max_episode_steps)
        s = MortarState(pos, s.commands, s.targets, t, verified,
                        s.reward_sum + reward)
        info = {"reward": s.reward_sum, "length": t.float(),
                "success": finished.float()}
        return s, self.observe(s), reward, done, info


def make(env_cfg: dict, n_workers: int, device) -> MortarMayhemGrid:
    return MortarMayhemGrid(env_cfg.get("reset_params", {}), n_workers,
                            device)
