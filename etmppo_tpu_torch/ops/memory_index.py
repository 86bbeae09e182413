"""Episodic-memory window tables and the rollout-tape index math
(counterpart of ``etmppo_tpu/ops/memory_index.py``).

* ``memory_mask``: row ``min(episode_step, L-1)`` of ``tril(ones(L, L), -1)``
  is the key mask at that step. Row 0 is all False: at episode step 0 every
  key is masked and attention is uniform over the (zero) memory slots.
* ``memory_indices``: per episode step, the absolute episode slots of the
  sliding memory window.
* The rollout writes each new memory item once to a tape; training windows
  are rebuilt from (pre-rollout snapshot, tape) by index arithmetic: a gather
  of L rows per sample from ``[snapshot | tape | zero PE region]``
  (``compute_window_sources``, the gathered-window loss), or, over the
  *timeline* of a worker (its memory writes in order), one contiguous run of
  timeline rows followed by one contiguous run of positional-encoding-only
  rows (``compute_timeline_sources``, the window-attention kernels).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


def build_memory_mask(memory_length: int) -> np.ndarray:
    """Boolean (L, L) mask table; True = attendable."""
    return np.tril(np.ones((memory_length, memory_length), dtype=bool), k=-1)


def build_memory_indices(max_episode_steps: int, memory_length: int) -> np.ndarray:
    """(max_episode_steps, L) int32 absolute episode slots of the sliding
    window at each episode step."""
    L = memory_length
    T = max_episode_steps
    if T < L:
        raise ValueError(f"max_episode_steps ({T}) must be >= memory_length ({L})")
    repetitions = np.repeat(np.arange(L, dtype=np.int32)[None, :], L - 1, axis=0)
    sliding = np.stack(
        [np.arange(i, i + L, dtype=np.int32) for i in range(T - L + 1)])
    return np.concatenate([repetitions, sliding], axis=0)


def _next_end(dones: torch.Tensor) -> torch.Tensor:
    """(W, T): the rollout step at which the episode of (w, t) ends (its last
    memory write), or T-1 if it outlives the rollout."""
    T = dones.shape[1]
    steps = torch.arange(T, dtype=torch.int32, device=dones.device)
    done_step = torch.where(dones, steps[None, :], T - 1)
    return torch.flip(torch.cummin(torch.flip(done_step, [1]), dim=1).values,
                      [1])


class WindowSources(NamedTuple):
    """Per-sample window gather indices.

    ``flat_index[w, t, j]`` indexes the per-worker source rows
    ``[snapshot[w] | tape[w] | zero PE region]`` (``max_ep + T + max_ep``
    rows). Never-written slots resolve to the zero PE region at their own
    slot, so after the positional encoding is added they hold the
    reference's zeros-plus-PE contents with a plain gather. ``valid`` is True
    where the slot holds real memory; ``slot`` is the absolute episode slot
    (the reference's ``memory_indices``).
    """
    flat_index: torch.Tensor  # (W, T, L) int32
    valid: torch.Tensor       # (W, T, L) bool
    slot: torch.Tensor        # (W, T, L) int32


def compute_window_sources(episode_steps: torch.Tensor, dones: torch.Tensor,
                           index_table: torch.Tensor, max_episode_steps: int
                           ) -> WindowSources:
    """episode_steps: (W, T) int; dones: (W, T) bool; index_table:
    (max_ep, L) from ``build_memory_indices``.

    Slot s of sample (w, t) at episode step e was (or will be) written at
    rollout step ``t_s = t + s - e``: before the rollout (t_s < 0) it is
    ``snapshot[w, s]``, else ``tape[w, t_s]``, valid while ``t_s`` is at most
    the step at which the sample's episode ends (``_next_end``)."""
    T = episode_steps.shape[1]
    e = episode_steps.long()
    slot = index_table[e].long()                                  # (W, T, L)
    t = torch.arange(T, device=e.device)[None, :, None]
    t_s = t + slot - e[:, :, None]
    from_snapshot = t_s < 0
    valid = from_snapshot | (t_s <= _next_end(dones)[:, :, None])
    flat_index = torch.where(from_snapshot, slot, max_episode_steps + t_s)
    flat_index = torch.where(valid, flat_index, max_episode_steps + T + slot)
    return WindowSources(flat_index.int(), valid, slot.int())


class TimelineSources(NamedTuple):
    """Window addressing over the per-worker memory timeline.

    For sample (w, t) at episode step e with window slots [s_lo, s_lo + L),
    the valid slots are timeline rows ``start .. start + n_valid - 1`` and the
    rest are PE-table rows ``s_lo + n_valid .. s_lo + L - 1``.
    """
    start: torch.Tensor    # (W, T) int32
    n_valid: torch.Tensor  # (W, T) int32
    s_lo: torch.Tensor     # (W, T) int32


def compute_timeline_sources(episode_steps: torch.Tensor, dones: torch.Tensor,
                             index_table: torch.Tensor, memory_length: int
                             ) -> TimelineSources:
    """episode_steps: (W, T) int; dones: (W, T) bool; index_table:
    (max_ep, L) from ``build_memory_indices``."""
    T = episode_steps.shape[1]
    L = memory_length
    e = episode_steps.int()
    t = torch.arange(T, dtype=torch.int32, device=e.device)[None, :]
    s_lo = index_table[e.long()][:, :, 0].int()
    start = e[:, :1] + t - e + s_lo
    s_valid_hi = torch.minimum(s_lo + L - 1, e + (_next_end(dones) - t))
    n_valid = torch.clamp(s_valid_hi - s_lo + 1, 1, L)
    return TimelineSources(start.int(), n_valid.int(), s_lo)


def build_timeline_slots(episode_steps: torch.Tensor, max_episode_steps: int,
                         pad: int) -> torch.Tensor:
    """(W, max_ep + T + pad) int32 absolute episode slot of each timeline row
    (snapshot rows sit at their slot, tape rows at the episode step they were
    written, padding rows at 0)."""
    W, T = episode_steps.shape
    S = max_episode_steps + T + pad
    rows = torch.arange(S, dtype=torch.int32,
                        device=episode_steps.device)[None, :].expand(W, S)
    e0 = episode_steps[:, :1].int()
    tape_idx = torch.clamp(rows - e0, 0, T - 1)
    tape_slot = torch.gather(episode_steps.int(), 1, tape_idx.long())
    return torch.where(rows < e0, rows, tape_slot)


def build_timeline(snapshot: torch.Tensor, tape: torch.Tensor,
                   e0: torch.Tensor, pad: int) -> torch.Tensor:
    """(W, max_ep + T + pad, ...) chronological memory timeline: row i is
    ``snapshot[w, i]`` for i < e0[w], else ``tape[w, i - e0[w]]``, and zero
    past the written range."""
    W, max_ep = snapshot.shape[:2]
    T = tape.shape[1]
    S = max_ep + T + pad
    rows = torch.arange(S, device=snapshot.device)[None, :]
    e0 = e0.long()[:, None]
    w = torch.arange(W, device=snapshot.device)[:, None]
    extra = (1,) * (snapshot.dim() - 2)
    from_snap = (rows < e0).reshape((W, S) + extra)
    from_tape = ((rows >= e0) & (rows - e0 < T)).reshape((W, S) + extra)
    snap = snapshot[w, rows.clamp(0, max_ep - 1).expand(W, S)]
    tap = tape[w, (rows - e0).clamp(0, T - 1)]
    return torch.where(from_snap, snap, torch.where(from_tape, tap, 0.0))
