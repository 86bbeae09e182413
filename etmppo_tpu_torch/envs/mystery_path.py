"""Mystery Path Grid, batched over workers on the device
(counterpart of ``etmppo_tpu/envs/mystery_path.py``).

An invisible path leads from an origin on one arena edge
(``cardinal_origin_choice``) to a goal on the opposite edge. Stepping off the
path teleports the agent back to the origin, with one step of visual feedback
marking where it fell (``visual_feedback``). Reaching the goal gives
``reward_goal`` and ends the episode; first-time progress along the path can
give ``reward_path_progress``; 128 steps end it too. Origin and goal are drawn
only with ``show_origin`` / ``show_goal``. Observations are an 84x84x3 HWC
top-down view in [0, 1]; actions are up / right / down / left.

The path is a biased walk in (forward, lateral) coordinates: forward with
probability 1/2, lateral +1 or -1 with 1/4 each (clipped to the arena), never
backward, and forced forward once the steps left equal the forward distance
left. Its ``3 * S - 1`` moves, the edge and the starting lateral cell are the
reset draws (``MysteryPathResetDraws``).

The rollout's auto-reset (``reset_done``) is on CUDA one kernel,
``csrc/mystery_path_reset.cu`` (``MysteryPathReset``), that rebuilds only the
workers whose episode ended and copies the others through; elsewhere it is
``TorchEnv``'s reset of all workers kept where done. Both give the same bits.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from ..ops.window_attention import _PACKAGE_DIR, _CudaKernel
from .core import TorchEnv

# actions: 0 up(-y), 1 right(+x), 2 down(+y), 3 left(-x)
MOVE_OFFSETS = np.array([[0, -1], [1, 0], [0, 1], [-1, 0]], np.int64)
INT32_MAX = 2 ** 31 - 1
OBS_SIDE = 84
RESET_SOURCE = _PACKAGE_DIR / "csrc" / "mystery_path_reset.cu"


class MysteryPathResetDraws(NamedTuple):
    """The random values one reset of all workers consumes."""
    edge: torch.Tensor      # (W,) int64, one of cardinal_origin_choice
    lateral0: torch.Tensor  # (W,) int64 in [0, S)
    moves: torch.Tensor     # (W, 3 * S - 1) int64 in {0 forward, 1 +1, 2 -1}


class MysteryPathState(NamedTuple):
    on_path: torch.Tensor        # (W, S, S) bool   hidden path cells [y][x]
    progress_idx: torch.Tensor   # (W, S, S) int64  first visit along the path, -1 off
    origin: torch.Tensor         # (W, 2) int64     (x, y)
    goal: torch.Tensor           # (W, 2) int64
    pos: torch.Tensor            # (W, 2) int64
    best_progress: torch.Tensor  # (W,) int64       farthest path index reached
    fall_pos: torch.Tensor       # (W, 2) int64     last fall cell (feedback)
    fall_timer: torch.Tensor     # (W,) int64       steps of feedback remaining
    t: torch.Tensor              # (W,) int64
    reward_sum: torch.Tensor     # (W,) float32
    length: torch.Tensor         # (W,) int64


class MysteryPathReset(_CudaKernel):
    """The auto-reset kernel (``csrc/mystery_path_reset.cu``), built by nvcc
    into ``_build`` like the window-attention kernels: ``reset(done, draws,
    state, obs, show_origin, show_goal) -> (state, obs)``, fresh tensors, on
    the current stream. The arena's size is read from ``state.on_path``."""

    symbol = "mystery_path_reset"
    n_pointers = 4 + 2 * (len(MysteryPathState._fields) + 1)
    n_ints = 4

    def __init__(self, source=RESET_SOURCE):
        super().__init__(source)

    def __call__(self, done: torch.Tensor, draws: MysteryPathResetDraws,
                 state: MysteryPathState, obs: torch.Tensor,
                 show_origin: bool, show_goal: bool):
        W, S = state.on_path.shape[0], state.on_path.shape[-1]
        if not 1 <= S <= OBS_SIDE:
            raise ValueError(f"mystery_path_reset: arena_size {S} is not in "
                             f"[1, {OBS_SIDE}]")
        want = dict(
            done=(done, torch.bool, (W,)),
            edge=(draws.edge, torch.int64, (W,)),
            lateral0=(draws.lateral0, torch.int64, (W,)),
            moves=(draws.moves, torch.int64, (W, 3 * S - 1)),
            obs=(obs, torch.float32, (W, OBS_SIDE, OBS_SIDE, 3)))
        for name, x in zip(MysteryPathState._fields, state):
            shape = ((W, S, S) if name in ("on_path", "progress_idx")
                     else (W, 2) if name in ("origin", "goal", "pos",
                                             "fall_pos") else (W,))
            dtype = (torch.bool if name == "on_path" else torch.float32
                     if name == "reward_sum" else torch.int64)
            want[name] = (x, dtype, shape)
        for name, (x, dtype, shape) in want.items():
            if (x.dtype != dtype or tuple(x.shape) != shape
                    or not x.is_contiguous()):
                raise ValueError(
                    f"mystery_path_reset: {name} must be a contiguous "
                    f"{dtype} tensor of shape {shape}, got {x.dtype} "
                    f"{tuple(x.shape)} with strides {x.stride()}")
        for name, (x, _, _) in want.items():
            if x.device.type != "cuda" or x.device != done.device:
                raise ValueError(
                    f"mystery_path_reset: {name} must be on the CUDA device "
                    f"of done, got {x.device} and {done.device}")
        out_state = MysteryPathState(*(torch.empty_like(x) for x in state))
        out_obs = torch.empty_like(obs)
        self._launch([x.data_ptr() for x in (
            done, *draws, *state, obs, *out_state, out_obs)],
            (W, S, int(show_origin), int(show_goal)), done.device)
        return out_state, out_obs


class MysteryPathGridEnv(TorchEnv):
    info_keys = ("reward", "length", "success")
    max_episode_steps = 128

    def __init__(self, reset_params: Dict, n_workers: int = 1, device="cuda"):
        p = dict(reset_params or {})
        self.size = int(p.get("arena_size", 7))
        self.origin_choices = tuple(int(c) for c in p.get(
            "cardinal_origin_choice", [0, 1, 2, 3]))
        self.show_origin = bool(p.get("show_origin", False))
        self.show_goal = bool(p.get("show_goal", False))
        self.visual_feedback = bool(p.get("visual_feedback", True))
        self.r_goal = float(p.get("reward_goal", 1.0))
        self.r_fall = float(p.get("reward_fall_off", 0.0))
        self.r_progress = float(p.get("reward_path_progress", 0.0))
        self.n_workers = n_workers
        self.device = torch.device(device)
        if self.device.type == "cuda":
            self.reset_kernel = MysteryPathReset()
            self.kernels = (self.reset_kernel,)

        S = self.size
        tile = OBS_SIDE // S
        off = (OBS_SIDE - tile * S) // 2
        # generous bound on path length (the biased walk crosses in <= ~3S)
        self.max_path_len = 3 * S
        self.observation_shape: Tuple[int, ...] = (OBS_SIDE, OBS_SIDE, 3)
        self.action_branches: Tuple[int, ...] = (4,)

        as_t = lambda a, dtype=torch.int64: torch.as_tensor(
            a, dtype=dtype, device=self.device)
        yy, xx = np.mgrid[0:OBS_SIDE, 0:OBS_SIDE]
        in_arena = ((xx >= off) & (xx < off + S * tile)
                    & (yy >= off) & (yy < off + S * tile))
        cell_x = np.clip((xx - off) // tile, 0, S - 1)
        cell_y = np.clip((yy - off) // tile, 0, S - 1)
        base = np.where(in_arena & (((cell_x + cell_y) % 2) == 0),
                        np.float32(0.18), np.float32(0.24)).astype(np.float32)
        self._in_arena = as_t(in_arena, torch.bool)
        self._cell_x = as_t(cell_x)
        self._cell_y = as_t(cell_y)
        self._base = as_t(np.repeat(base[:, :, None], 3, axis=2),
                          torch.float32)
        self._moves = as_t(MOVE_OFFSETS)
        self._choices = as_t(self.origin_choices)
        self._colors = {name: as_t(c, torch.float32) for name, c in (
            ("origin", [0.2, 0.8, 0.2]), ("goal", [0.9, 0.8, 0.1]),
            ("fall", [0.85, 0.1, 0.1]), ("agent", [0.1, 0.3, 0.95]))}

    # --- path generation -------------------------------------------------

    def _to_xy(self, edge, fwd, lat):
        """(forward, lateral) -> (x, y) per edge: 0 left->right, 1
        top->bottom, 2 right->left, 3 bottom->top."""
        far = self.size - 1 - fwd
        x = torch.where(edge == 0, fwd, torch.where(edge == 2, far, lat))
        y = torch.where(edge == 1, fwd, torch.where(edge == 3, far, lat))
        return x, y

    def _generate_path(self, draws: MysteryPathResetDraws):
        S = self.size
        W = draws.edge.shape[0]
        n_steps = self.max_path_len - 1
        edge = draws.edge.long()[:, None]
        fwd = torch.zeros(W, dtype=torch.int64, device=self.device)
        lat = draws.lateral0.long().clone()
        done = torch.zeros(W, dtype=torch.bool, device=self.device)
        fwds, lats = [fwd], [lat]
        for i in range(n_steps):
            force_fwd = (n_steps - i) <= (S - 1) - fwd
            move = torch.where(force_fwd, 0, draws.moves[:, i].long())
            d_lat = torch.where(move == 1, 1, torch.where(move == 2, -1, 0))
            lat = torch.where(done, lat, (lat + d_lat).clamp(0, S - 1))
            fwd = torch.where(done | (move != 0), fwd, fwd + 1)
            done = done | (fwd >= S - 1)
            fwds.append(fwd)
            lats.append(lat)
        xs, ys = self._to_xy(edge, torch.stack(fwds, 1), torch.stack(lats, 1))
        cells = ys * S + xs                                        # (W, 3S)
        on_path = torch.zeros(W, S * S, dtype=torch.bool, device=self.device)
        on_path.scatter_(1, cells, True)
        # progress index: the FIRST time a cell appears along the walk
        order = torch.arange(self.max_path_len, device=self.device)
        progress = torch.full((W, S * S), INT32_MAX, dtype=torch.int64,
                              device=self.device)
        progress.scatter_reduce_(1, cells, order.expand(W, -1), reduce="amin")
        progress = torch.where(on_path, progress, -1)
        origin = torch.stack(self._to_xy(edge[:, 0], torch.zeros_like(lat),
                                         draws.lateral0.long()), dim=1)
        goal = torch.stack([xs[:, -1], ys[:, -1]], dim=1)
        return (on_path.reshape(W, S, S), progress.reshape(W, S, S), origin,
                goal)

    # --- rendering -------------------------------------------------------

    def _observe(self, state: MysteryPathState) -> torch.Tensor:
        W = state.pos.shape[0]
        img = self._base.expand(W, -1, -1, -1)

        def mark(img, pos, color, cond=None):
            on = ((self._cell_x == pos[:, 0, None, None])
                  & (self._cell_y == pos[:, 1, None, None]) & self._in_arena)
            if cond is not None:
                on = on & cond[:, None, None]
            return torch.where(on[..., None], self._colors[color], img)

        if self.show_origin:
            img = mark(img, state.origin, "origin")
        if self.show_goal:
            img = mark(img, state.goal, "goal")
        if self.visual_feedback:
            img = mark(img, state.fall_pos, "fall", state.fall_timer > 0)
        img = mark(img, state.pos, "agent")
        return img.clamp(0.0, 1.0)

    # --- protocol --------------------------------------------------------

    def sample_reset_draws(self, generator: torch.Generator
                           ) -> MysteryPathResetDraws:
        W, S = self.draw_width, self.size
        choice = torch.randint(0, len(self.origin_choices), (W,),
                               generator=generator, device=self.device)
        lateral0 = torch.randint(0, S, (W,), generator=generator,
                                 device=self.device)
        u = torch.rand(W, self.max_path_len - 1, generator=generator,
                       device=self.device)
        moves = (u >= 0.5).long() + (u >= 0.75).long()
        return MysteryPathResetDraws(self._choices[choice], lateral0, moves)

    def reset(self, draws: MysteryPathResetDraws):
        on_path, progress, origin, goal = self._generate_path(draws)
        W = origin.shape[0]
        zeros = torch.zeros(W, dtype=torch.int64, device=self.device)
        state = MysteryPathState(
            on_path=on_path, progress_idx=progress, origin=origin, goal=goal,
            pos=origin.clone(), best_progress=zeros,
            fall_pos=torch.full((W, 2), -1, dtype=torch.int64,
                                device=self.device),
            fall_timer=zeros, t=zeros,
            reward_sum=torch.zeros(W, device=self.device), length=zeros)
        return state, self._observe(state)

    def reset_done(self, done: torch.Tensor, draws: MysteryPathResetDraws,
                   state: MysteryPathState, obs: torch.Tensor):
        if self.device.type != "cuda":
            return super().reset_done(done, draws, state, obs)
        return self.reset_kernel(done, draws, state, obs, self.show_origin,
                                 self.show_goal)

    def step(self, state: MysteryPathState, actions: torch.Tensor,
             draws=None):
        del draws  # the step draws nothing
        W = state.pos.shape[0]
        w = torch.arange(W, device=self.device)
        new_pos = (state.pos + self._moves[actions[:, 0].long()]).clamp(
            0, self.size - 1)
        on = state.on_path[w, new_pos[:, 1], new_pos[:, 0]]
        at_goal = (new_pos == state.goal).all(dim=1)

        fell = ~on
        pos = torch.where(fell[:, None], state.origin, new_pos)
        prog = torch.where(
            on, state.progress_idx[w, new_pos[:, 1], new_pos[:, 0]], 0)
        new_best = torch.maximum(state.best_progress, prog)
        progressed = on & (prog > state.best_progress)

        zero = torch.zeros(W, device=self.device)
        reward = torch.where(at_goal, self.r_goal, zero)
        reward = reward + torch.where(fell, self.r_fall, zero)
        reward = reward + torch.where(progressed, self.r_progress, zero)

        t = state.t + 1
        done = at_goal | (t >= self.max_episode_steps)
        new_state = MysteryPathState(
            on_path=state.on_path, progress_idx=state.progress_idx,
            origin=state.origin, goal=state.goal, pos=pos,
            best_progress=new_best,
            fall_pos=torch.where(fell[:, None], new_pos, state.fall_pos),
            fall_timer=torch.where(fell, 1, (state.fall_timer - 1).clamp(
                min=0)),
            t=t, reward_sum=state.reward_sum + reward,
            length=state.length + 1)
        info = {"reward": new_state.reward_sum,
                "length": new_state.length.float(),
                "success": at_goal.float()}
        return new_state, self._observe(new_state), reward, done, info
