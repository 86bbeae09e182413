"""Mortar Mayhem Grid, batched over workers on the device
(counterpart of ``etmppo_tpu/envs/mortar_mayhem.py``).

A sequence of ``command_count`` movement commands is announced one at a time
(each shown for 3 steps as a glyph at the top, then 1 blank step) while the
agent is frozen. Then the agent must execute them in order: within
``explosion_delay`` steps it must reach the commanded tile, then stay on it
for ``explosion_duration`` verification steps during which every other tile
"explodes" (drawn red). Each verified command gives
``reward_command_success``; leaving the target during verification ends the
episode with ``reward_command_failure``. The episode also ends when all
commands are done or after ``C * (3 + 1) + C * (delay + duration)`` steps
(120 for the shipped config). Observations are an 84x84x3 HWC top-down view
in [0, 1]; actions are the first ``allowed_commands`` command ids.

The commands are the reset draws (``MortarMayhemResetDraws``): each is drawn
uniformly among the commands that keep the target path inside the arena, the
distribution of the JAX env's ``_sample_commands``. A reset draws one uniform
per worker and command, ``command_count`` calls of ``torch.rand(draw_width)``
in turn (``sample_reset_uniforms``), and ``commands_from_uniforms`` picks the
commands from them: the ``floor(u * n)``-th of the ``n`` allowed commands, in
id order, walking from the centre.

The rollout's auto-reset (``reset_done``) is on CUDA one kernel,
``csrc/mortar_mayhem_reset.cu`` (``MortarMayhemReset``): there
``sample_reset_draws`` hands out the uniforms (``MortarMayhemResetUniforms``)
and the kernel picks the commands, builds the targets and renders the fresh
frame only for the workers whose episode ended, copying the others through.
On the CPU ``reset_done`` is ``TorchEnv``'s reset of all workers kept where
done, the path the tests hold against the JAX env, and ``sample_reset_draws``
hands out the commands. ``reset`` takes either draws, so commands handed in
directly (the JAX env's, in the tests) reset as before. Both paths give the
same bits.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple, Union

import numpy as np
import torch

# The nvcc/ctypes build is to move out of the attention op (ROADMAP.md §E1).
from ..ops.window_attention import _PACKAGE_DIR, _CudaKernel
from .core import TorchEnv

# command ids: 0 stay, 1 up(-y), 2 right(+x), 3 down(+y), 4 left(-x),
# 5..8 diagonals (allowed_commands: 5 => cardinal+stay, 9 => + diagonals)
COMMAND_OFFSETS = np.array(
    [[0, 0], [0, -1], [1, 0], [0, 1], [-1, 0],
     [1, -1], [1, 1], [-1, 1], [-1, -1]], np.int64)
SHOW_DURATION = 3
SHOW_DELAY = 1
GLYPH = 20
OBS_SIDE = 84
RESET_SOURCE = _PACKAGE_DIR / "csrc" / "mortar_mayhem_reset.cu"


def glyphs(tile: int) -> np.ndarray:
    """(9, tile, tile) arrow/stay glyph masks for the command display."""
    yy, xx = np.mgrid[0:tile, 0:tile].astype(np.float32) / (tile - 1)
    g = np.zeros((9, tile, tile), np.float32)
    g[0] = ((np.abs(xx - 0.5) < 0.22) & (np.abs(yy - 0.5) < 0.22)).astype(
        np.float32)                              # stay: square
    down = ((np.abs(xx - 0.5) < (yy - 0.1) * 0.6)
            & (yy > 0.1) & (yy < 0.9)).astype(np.float32)
    g[1] = np.rot90(down, k=2)                   # up (apex top)
    g[2] = np.rot90(down, k=1)                   # right (apex right)
    g[3] = down                                  # down
    g[4] = np.rot90(down, k=3)                   # left
    # diagonals: distinct corner-triangle glyphs
    g[5] = (xx - yy > 0.25).astype(np.float32)   # up-right
    g[6] = (xx + yy > 1.25).astype(np.float32)   # down-right
    g[7] = (yy - xx > 0.25).astype(np.float32)   # down-left
    g[8] = (xx + yy < 0.75).astype(np.float32)   # up-left
    return g


class MortarMayhemResetDraws(NamedTuple):
    """The random values one reset of all workers consumes."""
    commands: torch.Tensor   # (W, C) int64 command ids


class MortarMayhemResetUniforms(NamedTuple):
    """The same reset before the pick: the uniforms it was drawn from."""
    uniforms: torch.Tensor   # (W, C) float32 in [0, 1), command i's in column i


class MortarMayhemState(NamedTuple):
    pos: torch.Tensor            # (W, 2) int64 (x, y)
    commands: torch.Tensor       # (W, C) int64
    targets: torch.Tensor        # (W, C, 2) int64, the tile of each command
    t: torch.Tensor              # (W,) int64 step of the episode
    commands_done: torch.Tensor  # (W,) int64
    failed: torch.Tensor         # (W,) bool
    reward_sum: torch.Tensor     # (W,) float32
    length: torch.Tensor         # (W,) int64


class MortarMayhemReset(_CudaKernel):
    """The auto-reset kernel (``csrc/mortar_mayhem_reset.cu``), built by nvcc
    into ``_build`` like the window-attention kernels: ``reset(done, draws,
    state, obs, glyph_table, arena, allowed_commands) -> (state, obs)`` with
    the draws' uniforms, fresh tensors, on the current stream. The number of
    commands is read from ``state.commands``; any number, any arena whose
    tile is a pixel or more, and any ``allowed_commands`` of the nine ids."""

    symbol = "mortar_mayhem_reset"
    n_pointers = 3 + 2 * (len(MortarMayhemState._fields) + 1)
    n_ints = 4

    def __init__(self, source=RESET_SOURCE):
        super().__init__(source)

    def __call__(self, done: torch.Tensor, draws: MortarMayhemResetUniforms,
                 state: MortarMayhemState, obs: torch.Tensor,
                 glyph_table: torch.Tensor, arena: int,
                 allowed_commands: int):
        if not isinstance(draws, MortarMayhemResetUniforms):
            raise ValueError(
                "mortar_mayhem_reset: the draws must be the uniforms "
                f"(MortarMayhemResetUniforms), got {type(draws).__name__}")
        W, C = state.commands.shape
        if not 1 <= arena <= OBS_SIDE:
            raise ValueError(f"mortar_mayhem_reset: arena_size {arena} is "
                             f"not in [1, {OBS_SIDE}]")
        if not 1 <= allowed_commands <= len(COMMAND_OFFSETS):
            raise ValueError(
                f"mortar_mayhem_reset: allowed_commands {allowed_commands} "
                f"is not in [1, {len(COMMAND_OFFSETS)}]")
        want = dict(
            done=(done, torch.bool, (W,)),
            uniforms=(draws.uniforms, torch.float32, (W, C)),
            glyphs=(glyph_table, torch.float32, (9, GLYPH, GLYPH)))
        for name, x in zip(MortarMayhemState._fields, state):
            shape = ((W, 2) if name == "pos" else (W, C) if name == "commands"
                     else (W, C, 2) if name == "targets" else (W,))
            dtype = (torch.bool if name == "failed" else torch.float32
                     if name == "reward_sum" else torch.int64)
            want[name] = (x, dtype, shape)
        want["obs"] = (obs, torch.float32, (W, OBS_SIDE, OBS_SIDE, 3))
        for name, (x, dtype, shape) in want.items():
            if (x.dtype != dtype or tuple(x.shape) != shape
                    or not x.is_contiguous()):
                raise ValueError(
                    f"mortar_mayhem_reset: {name} must be a contiguous "
                    f"{dtype} tensor of shape {shape}, got {x.dtype} "
                    f"{tuple(x.shape)} with strides {x.stride()}")
        for name, (x, _, _) in want.items():
            if x.device.type != "cuda" or x.device != done.device:
                raise ValueError(
                    f"mortar_mayhem_reset: {name} must be on the CUDA device "
                    f"of done, got {x.device} and {done.device}")
        out_state = MortarMayhemState(*(torch.empty_like(x) for x in state))
        out_obs = torch.empty_like(obs)
        self._launch([x.data_ptr() for x in (
            done, draws.uniforms, glyph_table, *state, obs, *out_state,
            out_obs)], (W, C, arena, allowed_commands), done.device)
        return out_state, out_obs


class MortarMayhemGridEnv(TorchEnv):
    info_keys = ("reward", "length", "success")

    def __init__(self, reset_params: Dict, n_workers: int = 1, device="cuda"):
        p = dict(reset_params or {})
        self.arena = int(p.get("arena_size", 5))
        self.allowed_commands = int(p.get("allowed_commands", 5))
        self.command_count = int(np.max(p.get("command_count", [10])))
        self.explosion_duration = int(np.max(p.get("explosion_duration", [2])))
        self.explosion_delay = int(np.max(p.get("explosion_delay", [6])))
        self.r_fail = float(p.get("reward_command_failure", 0.0))
        self.r_success = float(p.get("reward_command_success", 0.1))
        self.r_episode = float(p.get("reward_episode_success", 0.0))
        self.n_workers = n_workers
        self.device = torch.device(device)
        if self.device.type == "cuda":
            self.reset_kernel = MortarMayhemReset()
            self.kernels = (self.reset_kernel,)

        C = self.command_count
        self.announce_steps = C * (SHOW_DURATION + SHOW_DELAY)
        self.exec_steps_per_cmd = self.explosion_delay + self.explosion_duration
        self.max_episode_steps = (
            self.announce_steps + C * self.exec_steps_per_cmd)
        self.observation_shape: Tuple[int, ...] = (84, 84, 3)
        self.action_branches: Tuple[int, ...] = (self.allowed_commands,)

        arena = self.arena
        tile = 84 // arena
        off = (84 - tile * arena) // 2
        as_t = lambda a, dtype=torch.int64: torch.as_tensor(
            a, dtype=dtype, device=self.device)
        yy, xx = np.mgrid[0:84, 0:84]
        in_arena = ((xx >= off) & (xx < off + arena * tile)
                    & (yy >= off) & (yy < off + arena * tile))
        cell_x = np.clip((xx - off) // tile, 0, arena - 1)
        cell_y = np.clip((yy - off) // tile, 0, arena - 1)
        base = np.where(in_arena & (((cell_x + cell_y) % 2) == 0),
                        np.float32(0.18), np.float32(0.24)).astype(np.float32)
        self._in_arena = as_t(in_arena, torch.bool)
        self._cell_x = as_t(cell_x)
        self._cell_y = as_t(cell_y)
        self._base = as_t(np.repeat(base[:, :, None], 3, axis=2),
                          torch.float32)
        self._offsets = as_t(COMMAND_OFFSETS[:self.allowed_commands])
        self._glyphs = as_t(glyphs(GLYPH), torch.float32)
        self._agent = as_t([0.1, 0.3, 0.95], torch.float32)
        self._start = as_t([arena // 2, arena // 2])
        self._strip = (slice(1, 1 + GLYPH),
                       slice(42 - GLYPH // 2, 42 - GLYPH // 2 + GLYPH))

    # --- helpers ---------------------------------------------------------

    def _targets(self, commands: torch.Tensor) -> torch.Tensor:
        """The tile after each command, walking from the arena's centre."""
        steps = self._offsets[commands.long()]              # (W, C, 2)
        return self._start + torch.cumsum(steps, dim=1)

    def _phase(self, t: torch.Tensor):
        """(announcing, shown command slot, show active, executed command,
        in explosion) at episode step t (W,)."""
        C, period = self.command_count, SHOW_DURATION + SHOW_DELAY
        announcing = t < self.announce_steps
        show_slot = (t // period).clamp(0, C - 1)
        show_active = (t % period) < SHOW_DURATION
        te = t - self.announce_steps
        exec_idx = (te // self.exec_steps_per_cmd).clamp(0, C - 1)
        in_explosion = (te % self.exec_steps_per_cmd) >= self.explosion_delay
        return announcing, show_slot, show_active, exec_idx, in_explosion

    def _observe(self, state: MortarMayhemState) -> torch.Tensor:
        W = state.pos.shape[0]
        w = torch.arange(W, device=self.device)
        announcing, show_slot, show_active, exec_idx, in_explosion = \
            self._phase(state.t)

        # explosion overlay: every arena tile but the current target turns red
        target = state.targets[w, exec_idx]                  # (W, 2)
        is_target = ((self._cell_x == target[:, 0, None, None])
                     & (self._cell_y == target[:, 1, None, None]))
        explode = (~announcing & in_explosion)[:, None, None]
        red = (explode & self._in_arena & ~is_target).float() * 0.7
        img = self._base.expand(W, -1, -1, -1).clone()
        img[..., 0] += red

        # agent tile (blue)
        on_agent = ((self._cell_x == state.pos[:, 0, None, None])
                    & (self._cell_y == state.pos[:, 1, None, None])
                    & self._in_arena)
        img = torch.where(on_agent[..., None], self._agent, img)

        # command glyph strip (top), only while announcing and shown
        glyph = self._glyphs[state.commands[w, show_slot]]   # (W, 20, 20)
        show = (announcing & show_active)[:, None, None]
        patch = torch.where(show, glyph, 0.0)[..., None]
        rows, cols = self._strip
        img[:, rows, cols] = torch.maximum(img[:, rows, cols], patch)
        return img.clamp(0.0, 1.0)

    # --- protocol --------------------------------------------------------

    def sample_reset_uniforms(self, generator: torch.Generator
                              ) -> torch.Tensor:
        """(W, C) float32: a reset's uniforms, one ``torch.rand(W)`` call a
        command, in turn."""
        W = self.draw_width
        return torch.stack([torch.rand(W, generator=generator,
                                       device=self.device)
                            for _ in range(self.command_count)], dim=1)

    def commands_from_uniforms(self, uniforms: torch.Tensor) -> torch.Tensor:
        """(W, C) int64: each command uniform among those whose target stays
        in the arena, the ``floor(u * n)``-th of the ``n`` allowed."""
        W = uniforms.shape[0]
        pos = self._start.expand(W, -1)
        commands = []
        for i in range(uniforms.shape[1]):
            cand = pos[:, None, :] + self._offsets               # (W, A, 2)
            ok = ((cand >= 0) & (cand < self.arena)).all(dim=2)  # (W, A)
            pick = (uniforms[:, i] * ok.sum(dim=1)).long()       # k-th valid
            rank = torch.cumsum(ok.long(), dim=1) - 1
            cmd = ((rank == pick[:, None]) & ok).long().argmax(dim=1)
            commands.append(cmd)
            pos = cand[torch.arange(W, device=self.device), cmd]
        return torch.stack(commands, dim=1)

    def sample_reset_draws(self, generator: torch.Generator
                           ) -> Union[MortarMayhemResetDraws,
                                      MortarMayhemResetUniforms]:
        """The uniforms where the reset kernel picks the commands, else the
        commands picked from them."""
        uniforms = self.sample_reset_uniforms(generator)
        if self.reset_kernel is not None:
            return MortarMayhemResetUniforms(uniforms)
        return MortarMayhemResetDraws(self.commands_from_uniforms(uniforms))

    def reset(self, draws: Union[MortarMayhemResetDraws,
                                 MortarMayhemResetUniforms]):
        commands = (self.commands_from_uniforms(draws.uniforms)
                    if isinstance(draws, MortarMayhemResetUniforms)
                    else draws.commands.long())
        W = commands.shape[0]
        zeros = torch.zeros(W, dtype=torch.int64, device=self.device)
        state = MortarMayhemState(
            pos=self._start.expand(W, -1).clone(), commands=commands,
            targets=self._targets(commands), t=zeros, commands_done=zeros,
            failed=torch.zeros(W, dtype=torch.bool, device=self.device),
            reward_sum=torch.zeros(W, device=self.device), length=zeros)
        return state, self._observe(state)

    def reset_done(self, done: torch.Tensor,
                   draws: Union[MortarMayhemResetDraws,
                                MortarMayhemResetUniforms],
                   state: MortarMayhemState, obs: torch.Tensor):
        if self.reset_kernel is None:
            return super().reset_done(done, draws, state, obs)
        return self.reset_kernel(done, draws, state, obs, self._glyphs,
                                 self.arena, self.allowed_commands)

    def step(self, state: MortarMayhemState, actions: torch.Tensor,
             draws=None):
        del draws  # the step draws nothing
        W = state.pos.shape[0]
        w = torch.arange(W, device=self.device)
        new_pos = (state.pos + self._offsets[actions[:, 0].long()]).clamp(
            0, self.arena - 1)
        # The phase of the step before the move; frozen while announcing.
        announcing, _, _, exec_idx, in_explosion = self._phase(state.t)
        pos = torch.where(announcing[:, None], state.pos, new_pos)

        # verification: during explosion steps the agent must be on target
        on_target = (pos == state.targets[w, exec_idx]).all(dim=1)
        failed_now = ~announcing & in_explosion & ~on_target
        # a command succeeds at the LAST explosion step of its window
        te = state.t - self.announce_steps
        last_step = ~announcing & (
            (te % self.exec_steps_per_cmd) == self.exec_steps_per_cmd - 1)
        cmd_success = last_step & on_target & ~failed_now
        commands_done = state.commands_done + cmd_success.long()
        all_done = commands_done >= self.command_count

        zero = torch.zeros(W, device=self.device)
        reward = torch.where(cmd_success, self.r_success, zero)
        reward = torch.where(failed_now, self.r_fail, reward)
        reward = reward + torch.where(all_done & cmd_success, self.r_episode,
                                      zero)
        t = state.t + 1
        done = failed_now | all_done | (t >= self.max_episode_steps)

        new_state = MortarMayhemState(
            pos=pos, commands=state.commands, targets=state.targets, t=t,
            commands_done=commands_done, failed=state.failed | failed_now,
            reward_sum=state.reward_sum + reward, length=state.length + 1)
        info = {"reward": new_state.reward_sum,
                "length": new_state.length.float(),
                "success": all_done.float()}
        return new_state, self._observe(new_state), reward, done, info
