"""TransformerXL / GTrXL episodic-memory core
(counterpart of ``etmppo_tpu/models/transformer.py``).

The quirks of the reference model are kept, since each changes learning:

* the attention energy is filled with -1e20 where the key mask is False
  *before* it is scaled, so an all-masked row attends uniformly;
* the softmax scale is ``sqrt(embed_dim)``, not ``sqrt(head_dim)``;
* each block's input becomes its memory item, detached: gradients reach K/V
  only through the projection weights;
* the sinusoid positions are enumerated in reverse, and the positional
  encoding is added to every block's memory by absolute episode slot.

Entry points (all queries are length 1, shape (B, D)):

* ``forward`` on raw memory windows, projections inside;
* ``project_memory`` / ``project_memory_blocks`` / ``pe_kv``: K/V of memory
  entries, projected once per entry (PE + optional pre-LN + K/V projection
  depend only on the entry and its slot);
* ``forward_with_kv`` on pre-projected K/V windows;
* ``forward_with_ops`` where each block's attention contraction is an op
  (the CUDA window-attention kernel in training).

A compute ``dtype`` (``float32`` or ``bfloat16``) follows flax's ``dtype=``
semantics, not ``torch.autocast``'s: the parameters stay float32; each
linear layer and GRU gate casts its input, weight and bias to the dtype and
computes in it; LayerNorm takes its statistics in float32 and casts its
output to the dtype; the attention energies are the dtype's (masked in it)
and the scaled softmax and the mix with V run in float32, as JAX promotes
them; ``project_memory*`` and ``pe_kv*`` return K/V in the dtype. In float32
every cast is the identity and the model computes what it always did.
"""
from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..config import TransformerConfig
from .initializers import (normal_, orthogonal_, uniform_fan_in_,
                           xavier_uniform_)

MASK_FILL = -1e20


def sinusoidal_position_table(max_steps: int, dim: int,
                              min_timescale: float = 2.0,
                              max_timescale: float = 1e4) -> np.ndarray:
    """(max_steps, dim) sinusoid table with positions enumerated in REVERSE:
    slot i encodes position ``max_steps - 1 - i``."""
    freqs = np.arange(0, dim, min_timescale, dtype=np.float32)
    inv_freqs = max_timescale ** (-freqs / dim)
    seq = np.arange(max_steps - 1, -1, -1.0, dtype=np.float32)
    sinusoid = seq[:, None] * inv_freqs[None, :]
    return np.concatenate([np.sin(sinusoid), np.cos(sinusoid)], axis=-1)


class Linear(nn.Linear):
    """``nn.Linear`` that computes in ``compute_dtype``: input, weight and
    bias cast to it (flax's ``Dense(dtype=...)``); float32 parameters."""

    def __init__(self, fan_in: int, fan_out: int, bias: bool, device,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(fan_in, fan_out, bias=bias, device=device)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` (eps 1e-5) as flax's ``LayerNorm(dtype=...)``:
    statistics and affine in float32, the output cast to
    ``compute_dtype``."""

    def __init__(self, dim: int, device,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(dim, eps=1e-5, device=device)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.float()).to(self.compute_dtype)


def _linear(fan_in: int, fan_out: int, bias: bool, device, generator,
            gain: Optional[float] = None, bias_fan_in: Optional[int] = None,
            dtype: torch.dtype = torch.float32) -> Linear:
    """``Linear`` with the reference's init: orthogonal(gain) weight when
    ``gain`` is given, else U(+-1/sqrt(fan_in)); bias U(+-1/sqrt(bias_fan_in))."""
    layer = Linear(fan_in, fan_out, bias, device, dtype)
    if gain is None:
        uniform_fan_in_(layer.weight, fan_in, generator)
    else:
        orthogonal_(layer.weight, gain, generator)
    if bias:
        uniform_fan_in_(layer.bias, bias_fan_in or fan_in, generator)
    return layer


class MultiHeadAttention(nn.Module):
    """Masked multi-head attention with the sqrt(embed_dim) scale. Bias-free
    Q/K/V projections, biased output projection."""

    def __init__(self, embed_dim: int, num_heads: int, device, generator,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        D = embed_dim
        self.embed_dim = D
        self.num_heads = num_heads
        self.values = _linear(D, D, False, device, generator, dtype=dtype)
        self.keys = _linear(D, D, False, device, generator, dtype=dtype)
        self.queries = _linear(D, D, False, device, generator, dtype=dtype)
        self.fc_out = _linear(D, D, True, device, generator, dtype=dtype)

    def project_kv(self, memory: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.keys(memory), self.values(memory)

    def attend(self, k: torch.Tensor, v: torch.Tensor, query: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
        """k/v: (B, L, D) projected; query: (B, D) unprojected; mask (B, L).
        The energies are in the compute dtype; the scaled softmax and the
        mix with V are float32 (JAX's promotion of ``energy /
        np.sqrt(D)``)."""
        D, H = self.embed_dim, self.num_heads
        B, L = k.shape[:2]
        q = self.queries(query).reshape(B, H, D // H)
        energy = torch.einsum("bhd,blhd->bhl", q, k.reshape(B, L, H, D // H))
        energy = energy.masked_fill(~mask[:, None, :], MASK_FILL)
        attention = torch.softmax(energy.float() / math.sqrt(D), dim=-1)
        out = torch.einsum("bhl,blhd->bhd", attention,
                           v.reshape(B, L, H, D // H).float())
        return self.fc_out(out.reshape(B, D))

    def attend_with_op(self, query: torch.Tensor,
                       op: Callable[[torch.Tensor], torch.Tensor]
                       ) -> torch.Tensor:
        """``op`` maps projected queries (B, D) to the attention output
        (B, D); the mask lives inside the op."""
        return self.fc_out(op(self.queries(query)))


class GRUGate(nn.Module):
    """GRU gate that replaces a residual connection in GTrXL. Weights are kept
    (in, out), as in the JAX package."""

    def __init__(self, dim: int, bias: float, device, generator,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        D = dim
        self.compute_dtype = dtype
        for name in ("Wr", "Wz", "Wg", "Ur", "Uz", "Ug"):
            weight = nn.Parameter(torch.empty(D, D, device=device))
            xavier_uniform_(weight, generator)
            setattr(self, name, weight)
        self.bg = nn.Parameter(torch.full((D,), float(bias), device=device))

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        Wr, Wz, Wg, Ur, Uz, Ug, bg = (p.to(dt) for p in (
            self.Wr, self.Wz, self.Wg, self.Ur, self.Uz, self.Ug, self.bg))
        x, y = x.to(dt), y.to(dt)
        r = torch.sigmoid(y @ Wr + x @ Ur)
        z = torch.sigmoid(y @ Wz + x @ Uz - bg)
        h = torch.tanh(y @ Wg + (r * x) @ Ug)
        return (1.0 - z) * x + z * h


class TransformerBlock(nn.Module):
    """One TrXL/GTrXL block with "pre", "post" or no LayerNorm."""

    def __init__(self, config: TransformerConfig, device, generator,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config = config
        D = config.embed_dim
        self.attention = MultiHeadAttention(D, config.num_heads, device,
                                            generator, dtype)
        ln = config.layer_norm
        if ln in ("pre", "post"):
            self.norm1 = LayerNorm(D, device, dtype)
            self.norm2 = LayerNorm(D, device, dtype)
        if ln == "pre":
            self.norm_kv = LayerNorm(D, device, dtype)
        if config.gtrxl:
            self.gate1 = GRUGate(D, config.gtrxl_bias, device, generator, dtype)
            self.gate2 = GRUGate(D, config.gtrxl_bias, device, generator, dtype)
        self.fc = _linear(D, D, True, device, generator, dtype=dtype)

    def project_kv(self, memory: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """PE-added memory entries -> projected (k, v), through the shared
        pre-LN ``norm_kv`` first when configured."""
        if self.config.layer_norm == "pre":
            memory = self.norm_kv(memory)
        return self.attention.project_kv(memory)

    def attend_and_project(self, k, v, query, mask) -> torch.Tensor:
        query_ = self.norm1(query) if self.config.layer_norm == "pre" else query
        return self._post_attention(self.attention.attend(k, v, query_, mask),
                                    query)

    def attend_with_op_and_project(self, op, query) -> torch.Tensor:
        query_ = self.norm1(query) if self.config.layer_norm == "pre" else query
        return self._post_attention(self.attention.attend_with_op(query_, op),
                                    query)

    def _post_attention(self, attention, query) -> torch.Tensor:
        cfg = self.config
        ln = cfg.layer_norm
        h = self.gate1(query, attention) if cfg.gtrxl else attention + query
        if ln == "post":
            h = self.norm1(h)
        h_ = self.norm2(h) if ln == "pre" else h
        forward = F.relu(self.fc(h_))
        out = self.gate2(h, forward) if cfg.gtrxl else forward + h
        if ln == "post":
            out = self.norm2(out)
        return out

    def forward(self, memory, query, mask) -> torch.Tensor:
        """memory: (B, L, D) PE-added raw entries (K == V); query: (B, D)."""
        k, v = self.project_kv(memory)
        return self.attend_and_project(k, v, query, mask)


class Transformer(nn.Module):
    """Episodic-memory transformer encoder with a length-1 query."""

    def __init__(self, config: TransformerConfig, max_episode_steps: int,
                 device, generator, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config = config
        self.max_episode_steps = max_episode_steps
        D = config.embed_dim
        self.linear_embedding = _linear(D, D, True, device, generator,
                                        gain=math.sqrt(2), dtype=dtype)
        self.blocks = nn.ModuleList(
            [TransformerBlock(config, device, generator, dtype)
             for _ in range(config.num_blocks)])
        if config.positional_encoding == "relative":
            self.register_buffer("pos_table", torch.as_tensor(
                sinusoidal_position_table(max_episode_steps, D),
                device=device), persistent=False)
        elif config.positional_encoding == "learned":
            self.pos_embedding = nn.Parameter(
                torch.empty(max_episode_steps, D, device=device))
            normal_(self.pos_embedding, 1.0, generator)

    def positional_table(self) -> Optional[torch.Tensor]:
        pe = self.config.positional_encoding
        if pe == "relative":
            return self.pos_table
        if pe == "learned":
            return self.pos_embedding
        return None

    def embed(self, h: torch.Tensor) -> torch.Tensor:
        return F.relu(self.linear_embedding(h))

    def forward(self, h, memories, mask, memory_indices
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """h: (B, D_in); memories: (B, L, blocks, D) cached block inputs;
        mask: (B, L) bool; memory_indices: (B, L) absolute episode slots.
        Returns (h_out (B, D), new_memory (B, blocks, D))."""
        h = self.embed(h)
        pos = self.positional_table()
        if pos is not None:
            memories = memories + pos[memory_indices.long()][:, :, None, :]
        out_memories = []
        for i, block in enumerate(self.blocks):
            out_memories.append(h.detach())
            h = block(memories[:, :, i], h, mask)
        return h, torch.stack(out_memories, dim=1)

    # --- projected-KV paths --------------------------------------------

    def project_memory_blocks(self, memory, slots
                              ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """Per block, contiguous (k, v) of shape (..., D) for memory entries
        (..., blocks, D) at absolute episode slots (...)."""
        pos = self.positional_table()
        if pos is not None:
            memory = memory + pos[slots.long()][..., None, :]
        return [block.project_kv(memory[..., i, :])
                for i, block in enumerate(self.blocks)]

    def project_memory(self, memory, slots
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(k, v), each (..., blocks, D): ``project_memory_blocks`` stacked."""
        kv = self.project_memory_blocks(memory, slots)
        return (torch.stack([k for k, _ in kv], dim=-2),
                torch.stack([v for _, v in kv], dim=-2))

    def pe_kv_blocks(self) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """Per block, projected (k, v) of unwritten slots (zero content + PE),
        each (max_episode_steps, D)."""
        device = self.linear_embedding.weight.device
        zeros = torch.zeros(self.max_episode_steps, self.config.num_blocks,
                            self.config.embed_dim, device=device)
        slots = torch.arange(self.max_episode_steps, device=device)
        return self.project_memory_blocks(zeros, slots)

    def pe_kv(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(k, v), each (max_episode_steps, blocks, D)."""
        kv = self.pe_kv_blocks()
        return (torch.stack([k for k, _ in kv], dim=-2),
                torch.stack([v for _, v in kv], dim=-2))

    def forward_with_kv(self, h, k_win, v_win, mask
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        """k_win/v_win: (B, L, blocks, D) projected windows; mask: (B, L)."""
        h = self.embed(h)
        out_memories = []
        # unbind: one stacked backward, not a zero-filled window per block
        for block, k, v in zip(self.blocks, k_win.unbind(2), v_win.unbind(2)):
            out_memories.append(h.detach())
            h = block.attend_and_project(k, v, h, mask)
        return h, torch.stack(out_memories, dim=1)

    def forward_with_ops(self, h, ops: Sequence[Callable]
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Block stack where block i's attention contraction is ``ops[i]``
        (projected q (B, D) -> attention output (B, D))."""
        h = self.embed(h)
        out_memories = []
        for i, block in enumerate(self.blocks):
            out_memories.append(h.detach())
            h = block.attend_with_op_and_project(ops[i], h)
        return h, torch.stack(out_memories, dim=1)
