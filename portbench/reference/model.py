"""Plain PyTorch reference of the episodic-memory actor-critic.

Written from the published description of the TrXL-PPO model (the
MarcoMeter/episodic-transformer-memory-ppo repository) and imports nothing
of the port. Parameters are a dict of tensors under the names of the port's
``state_dict``, so that the benchmark can hand the same weights to both
sides; nothing else is shared.

* Encoder: the Atari CNN (32x8s4, 64x4s2, 64x3s1, VALID, ReLU) on NHWC
  images, flattened in HWC order, then ``lin_hidden`` and ReLU.
* Transformer: ``linear_embedding`` and ReLU, then blocks that attend with a
  length-1 query over a raw window of memory items (the block inputs of
  earlier steps), with the sinusoid table (positions enumerated in reverse)
  added by absolute episode slot under relative PE; the energy is filled
  with -1e20 where the key is masked before it is scaled by sqrt(embed_dim);
  pre- or post-LayerNorm (eps 1e-5); bias-free Q/K/V; a residual around the
  attention and around ``fc``.
* Heads: ReLU(lin_policy) and ReLU(lin_value), one linear head per action
  branch and a value head.

Every matrix product goes through ``Precision``: with ``tf32`` set, its
inputs are rounded to TensorFloat-32 (10 mantissa bits, to nearest, ties
away), which is what a TF32 tensor core does to them. That is the control of
the benchmark's comparison; by default the reference computes in float32
with TF32 off.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

MASK_FILL = -1e20


def _tf32(x: torch.Tensor) -> torch.Tensor:
    bits = x.contiguous().view(torch.int32)
    sign = bits & torch.iinfo(torch.int32).min
    mag = (bits & 0x7FFFFFFF) + 0x1000
    return ((mag & ~0x1FFF) | sign).view(torch.float32)


class _RoundTF32(torch.autograd.Function):
    """TF32 rounding of a matrix product's operand, and of the gradient
    that flows back through it."""

    @staticmethod
    def forward(ctx, x):
        return _tf32(x)

    @staticmethod
    def backward(ctx, grad):
        return _tf32(grad)


def strict_float32() -> None:
    """Float32 matrix products and convolutions, TF32 off, on every
    backend: the reference's precision is its own, not the process's."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


class Precision:
    """Whether the matrix products round their operands to TF32."""

    def __init__(self, tf32: bool = False):
        self.tf32 = tf32

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return _RoundTF32.apply(x) if self.tf32 else x


def conv_out(hw: int) -> int:
    hw = (hw - 8) // 4 + 1
    hw = (hw - 4) // 2 + 1
    return hw - 2


def param_spec(cfg: dict, obs_shape: Tuple[int, ...],
               action_branches: Tuple[int, ...]) -> List[Tuple[str, tuple]]:
    """(name, shape) of every parameter, under the port's names."""
    trx = cfg["transformer"]
    if trx.get("gtrxl") or trx.get("positional_encoding") == "learned":
        raise NotImplementedError("the reference has no GRU gates and no "
                                  "learned positional encoding")
    D, hidden = trx["embed_dim"], cfg["hidden_layer_size"]
    spec = []

    def linear(name, fan_in, fan_out, bias=True):
        spec.append((name + ".weight", (fan_out, fan_in)))
        if bias:
            spec.append((name + ".bias", (fan_out,)))

    if len(obs_shape) > 1:
        H, W, C = obs_shape
        for name, c_in, c_out, k in (("conv1", C, 32, 8), ("conv2", 32, 64, 4),
                                     ("conv3", 64, 64, 3)):
            spec.append((name + ".weight", (c_out, c_in, k, k)))
            spec.append((name + ".bias", (c_out,)))
        feat = conv_out(H) * conv_out(W) * 64
    else:
        feat = obs_shape[0]
    linear("lin_hidden", feat, D)
    linear("transformer.linear_embedding", D, D)
    for i in range(trx["num_blocks"]):
        b = f"transformer.blocks.{i}."
        for proj in ("values", "keys", "queries"):
            linear(b + "attention." + proj, D, D, bias=False)
        linear(b + "attention.fc_out", D, D)
        norms = {"pre": ("norm1", "norm2", "norm_kv"),
                 "post": ("norm1", "norm2")}.get(trx["layer_norm"], ())
        for norm in norms:
            spec.append((b + norm + ".weight", (D,)))
            spec.append((b + norm + ".bias", (D,)))
        linear(b + "fc", D, D)
    linear("lin_policy", D, hidden)
    linear("lin_value", D, hidden)
    linear("value", hidden, 1)
    for j, n in enumerate(action_branches):
        linear(f"policy_branches.{j}", hidden, n)
    return spec


def make_weights(spec, seed: int, device) -> Dict[str, torch.Tensor]:
    """Weights drawn from ``seed`` on ``device`` in one call: matrices and
    convolutions U(+-1/sqrt(fan_in)), biases U(+-0.05), LayerNorm scales
    1 + U(+-0.1) and shifts U(+-0.1)."""
    gen = torch.Generator(device).manual_seed(seed)
    sizes = [math.prod(shape) for _, shape in spec]
    flat = torch.rand(sum(sizes), generator=gen, device=device) * 2 - 1
    weights = {}
    for (name, shape), part in zip(spec, flat.split(sizes)):
        if len(shape) > 1:
            value = part / math.sqrt(math.prod(shape[1:]))
        elif ".norm" in name and name.endswith(".weight"):
            value = 1 + 0.1 * part
        elif ".norm" in name:
            value = 0.1 * part
        else:
            value = 0.05 * part
        weights[name] = value.reshape(shape).clone()
    return weights


def memory_mask(L: int) -> np.ndarray:
    """Row ``min(e, L-1)`` is the key mask at episode step e: the slots
    before it."""
    return np.tril(np.ones((L, L), dtype=bool), k=-1)


def memory_indices(max_ep: int, L: int) -> np.ndarray:
    """(max_ep, L): the episode slots of the window at each episode step;
    the first L slots until step L-1, then the L slots ending at the
    step."""
    rows = [np.arange(L) for _ in range(L - 1)]
    rows += [np.arange(i, i + L) for i in range(max_ep - L + 1)]
    return np.stack(rows).astype(np.int64)


def position_table(max_ep: int, dim: int) -> np.ndarray:
    """Sinusoids with the positions reversed: slot i encodes max_ep-1-i."""
    inv = 1e4 ** (-np.arange(0, dim, 2.0, dtype=np.float32) / dim)
    pos = np.arange(max_ep - 1, -1, -1.0, dtype=np.float32)[:, None] * inv
    return np.concatenate([np.sin(pos), np.cos(pos)], axis=-1)


class Model:
    """The actor-critic as functions of a parameter dict."""

    def __init__(self, cfg: dict, obs_shape, action_branches, max_ep: int,
                 device, precision: Optional[Precision] = None):
        strict_float32()
        trx = cfg["transformer"]
        self.D = trx["embed_dim"]
        self.H = trx["num_heads"]
        self.L = trx["memory_length"]
        self.blocks = trx["num_blocks"]
        self.ln = trx["layer_norm"]
        self.visual = len(obs_shape) > 1
        self.branches = tuple(action_branches)
        self.max_ep = max_ep
        self.rnd = precision or Precision()
        self.pos = (torch.as_tensor(position_table(max_ep, self.D),
                                    device=device)
                    if trx["positional_encoding"] == "relative" else None)
        self.mask_table = torch.as_tensor(memory_mask(self.L), device=device)
        self.index_table = torch.as_tensor(memory_indices(max_ep, self.L),
                                           device=device)

    def linear(self, p, name, x, bias=True):
        r = self.rnd
        return F.linear(r(x), r(p[name + ".weight"]),
                        p[name + ".bias"] if bias else None)

    def norm(self, p, name, x):
        return F.layer_norm(x, (self.D,), p[name + ".weight"],
                            p[name + ".bias"], 1e-5)

    def encode(self, p, obs):
        h = obs
        if self.visual:
            h = h.permute(0, 3, 1, 2)
            for name, stride in (("conv1", 4), ("conv2", 2), ("conv3", 1)):
                h = F.relu(F.conv2d(self.rnd(h), self.rnd(p[name + ".weight"]),
                                    p[name + ".bias"], stride=stride))
            h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
        return F.relu(self.linear(p, "lin_hidden", h))

    def forward(self, p, obs, window, mask, slots):
        """obs (B, *obs_shape); window (B, L, blocks, D) raw memory items
        (zero where unwritten); mask (B, L) bool; slots (B, L) episode
        slots. Returns (branch logits, value (B,), the block inputs (B,
        blocks, D))."""
        B, D, H = obs.shape[0], self.D, self.H
        h = F.relu(self.linear(p, "transformer.linear_embedding",
                               self.encode(p, obs)))
        if self.pos is not None:
            window = window + self.pos[slots][:, :, None, :]
        items = []
        for i in range(self.blocks):
            b = f"transformer.blocks.{i}."
            items.append(h.detach())
            mem = window[:, :, i]
            if self.ln == "pre":
                mem = self.norm(p, b + "norm_kv", mem)
            k = self.linear(p, b + "attention.keys", mem, bias=False)
            v = self.linear(p, b + "attention.values", mem, bias=False)
            query = self.norm(p, b + "norm1", h) if self.ln == "pre" else h
            q = self.linear(p, b + "attention.queries", query, bias=False)
            r = self.rnd
            energy = torch.einsum("bhd,blhd->bhl", r(q.reshape(B, H, D // H)),
                                  r(k.reshape(B, -1, H, D // H)))
            energy = energy.masked_fill(~mask[:, None, :], MASK_FILL)
            att = torch.softmax(energy / math.sqrt(D), dim=-1)
            out = torch.einsum("bhl,blhd->bhd", r(att),
                               r(v.reshape(B, -1, H, D // H)))
            x = self.linear(p, b + "attention.fc_out", out.reshape(B, D)) + h
            if self.ln == "post":
                x = self.norm(p, b + "norm1", x)
            x_ = self.norm(p, b + "norm2", x) if self.ln == "pre" else x
            out = F.relu(self.linear(p, b + "fc", x_)) + x
            h = self.norm(p, b + "norm2", out) if self.ln == "post" else out
        hp = F.relu(self.linear(p, "lin_policy", h))
        hv = F.relu(self.linear(p, "lin_value", h))
        logits = [self.linear(p, f"policy_branches.{j}", hp)
                  for j in range(len(self.branches))]
        value = self.linear(p, "value", hv).reshape(-1)
        return logits, value, torch.stack(items, dim=1)

    def window(self, memory, e, rows=None):
        """The raw window at episode step e (N,) of each row's memory
        (N, max_ep, blocks, D), or of memory rows ``rows`` (N,): (items,
        mask, slots)."""
        slots = self.index_table[e]
        if rows is None:
            rows = torch.arange(memory.shape[0], device=e.device)
        return (memory[rows[:, None], slots],
                self.mask_table[e.clamp(max=self.L - 1)], slots)


def gumbel_gap(logits: torch.Tensor, u: torch.Tensor,
               chosen: torch.Tensor) -> torch.Tensor:
    """How far the chosen action's Gumbel-perturbed logit lies below the
    best one, with the uniforms ``u`` of the draw (0 where it is the
    best)."""
    u = u.clamp(min=torch.finfo(u.dtype).tiny)
    perturbed = logits - torch.log(-torch.log(u))
    return perturbed.max(dim=-1).values - perturbed.gather(
        -1, chosen.long()[..., None])[..., 0]


def sample(logits: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The Gumbel-max action for the uniforms ``u``."""
    u = u.clamp(min=torch.finfo(u.dtype).tiny)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)
