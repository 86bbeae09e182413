"""One policy step on the K/V-cache path, shared by the rollout
(``training/rollout.py``), the policy server (``serve.py``) and the
evaluation (``evaluate.py``).

Each of N rows (workers, streams, episodes) holds its episodic memory as
projected K/V caches, each (N, max_ep, blocks, D). A step gathers each
row's window from the caches and attends over it, then projects the one new
memory item. Where the item is written is the caller's rule: the rollout
and the evaluation write every row, the server only its active streams.
"""
from __future__ import annotations

import torch

from ..ops.memory_index import build_memory_mask


class KVCacheStep:
    """Row n attends over the ``memory_length`` cached slots that end at its
    episode step ``t[n]``, with mask row ``min(t[n], L - 1)``, and the new
    memory item is projected for slot ``t[n]``.

    Where JAX clamps an index implicitly, this clamps it explicitly: the
    window starts at most at ``max_ep - L`` (``dynamic_slice_in_dim``) and
    the slot is at most ``max_ep - 1`` (the PE gather). A row at
    ``t == max_ep``, a served stream whose episode budget is spent, then
    gets the values JAX gives it; unclamped, the index would be out of range,
    a device-side assert on the card."""

    def __init__(self, model, n_rows: int, max_ep: int, memory_length: int,
                 device):
        self.model = model
        self.max_ep = max_ep
        self.memory_length = memory_length
        self.mask_table = torch.as_tensor(build_memory_mask(memory_length),
                                          device=device)
        self.rows = torch.arange(n_rows, device=device)[:, None]
        self.window = torch.arange(memory_length, device=device)

    def __call__(self, obs, k_cache, v_cache, t):
        """Returns (logits, value, mem_item, slot, k_item, v_item): the
        policy's outputs, the new memory item, the slot it belongs to and
        its K/V there. Nothing is written."""
        L = self.memory_length
        start = (t - (L - 1)).clamp(0, self.max_ep - L)
        win = start[:, None] + self.window
        logits, value, mem_item = self.model.forward_with_kv(
            obs, k_cache[self.rows, win], v_cache[self.rows, win],
            self.mask_table[t.clamp(0, L - 1)])
        slot = t.clamp(max=self.max_ep - 1)
        k_item, v_item = self.model.project_memory(mem_item, slot)
        return logits, value, mem_item, slot, k_item, v_item
