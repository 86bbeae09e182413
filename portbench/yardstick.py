"""The benchmark's frozen arithmetic: the card's peaks, the FLOPs of the
algorithm's matrix products from a configuration's shapes, and the least
time of a window-attention call. None of it reads what the program runs,
so a change to the program cannot change what it counts.

Peaks: NVIDIA H100 SXM5 at its 700 W power limit (NVIDIA's data sheet):
67 TFLOP/s in float32 outside the tensor cores, which is what the cells
compute in (TF32 off), and 3.35 TB/s of HBM3.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

H100_FP32_FLOPS = 67e12
H100_BYTES_PER_S = 3.35e12


def _conv_shapes(obs_shape):
    """(out_h, out_w, c_out, c_in * k * k) of the three convolutions."""
    H, W, C = obs_shape
    out = []
    for c_in, c_out, k, s in ((C, 32, 8, 4), (32, 64, 4, 2), (64, 64, 3, 1)):
        H, W = (H - k) // s + 1, (W - k) // s + 1
        out.append((H, W, c_out, c_in * k * k))
    return out


def forward_flops(cfg: dict, obs_shape, action_branches) -> dict:
    """FLOPs of one sample's forward, by part: ``conv1`` (the first
    convolution, whose input needs no gradient), ``dense`` (the other
    convolutions and every linear layer on the query's path), ``attention``
    (4 L D a block) and ``kv_row`` (the K and V projections of one memory
    row in all blocks)."""
    trx = cfg["transformer"]
    D, L, blocks = trx["embed_dim"], trx["memory_length"], trx["num_blocks"]
    hidden = cfg["hidden_layer_size"]
    conv1 = dense = 0
    if len(obs_shape) > 1:
        convs = [2 * h * w * co * fan for h, w, co, fan in
                 _conv_shapes(obs_shape)]
        conv1, dense = convs[0], sum(convs[1:])
        h, w, co, _ = _conv_shapes(obs_shape)[-1]
        feat = h * w * co
    else:
        feat = obs_shape[0]
    dense += 2 * feat * D + 2 * D * D                   # lin_hidden, embedding
    dense += blocks * 3 * 2 * D * D                     # queries, fc_out, fc
    dense += 2 * 2 * D * hidden + 2 * hidden * (1 + sum(action_branches))
    return dict(conv1=conv1, dense=dense, attention=blocks * 4 * L * D,
                kv_row=blocks * 2 * 2 * D * D)


def update_flops(cfg: dict, env) -> float:
    """FLOPs of one update: every rollout step's forward and its new memory
    row's K/V; each epoch's forward and backward of every sample (backward
    twice the forward's matrix products, the first convolution's weights
    alone, attention 8 L D a block), and the K/V of the rollout's W x T
    memory rows once per minibatch, forward and backward (the backward's
    input gradient only under pre-LN, whose norm it reaches)."""
    f = forward_flops(cfg, env.observation_shape, env.action_branches)
    rows = cfg["n_workers"] * cfg["worker_steps"]
    fwd = f["conv1"] + f["dense"] + f["attention"]
    bwd = f["conv1"] + 2 * f["dense"] + 2 * f["attention"]
    kv_bwd = f["kv_row"] * (2 if cfg["transformer"]["layer_norm"] == "pre"
                            else 1)
    rollout = rows * (fwd + f["kv_row"])
    epoch = rows * (fwd + bwd) + cfg["n_mini_batch"] * rows * (
        f["kv_row"] + kv_bwd)
    return float(rollout + cfg["epochs"] * epoch)


def step_flops(cfg: dict, obs_shape, action_branches, rows: int) -> float:
    """FLOPs of one policy step of ``rows`` streams on the K/V cache: the
    forward and the new memory row's K/V."""
    f = forward_flops(cfg, obs_shape, action_branches)
    return float(rows * (f["conv1"] + f["dense"] + f["attention"]
                         + f["kv_row"]))


class Timeline(NamedTuple):
    """Where each sample's window lies in its worker's memory timeline:
    rows ``start .. start + n_valid - 1``, then PE-table rows from
    ``s_lo + n_valid`` up to ``s_lo + L - 1``."""
    start: torch.Tensor
    n_valid: torch.Tensor
    s_lo: torch.Tensor


def timeline_sources(episode_steps, dones, max_ep: int, L: int) -> Timeline:
    """(W, T) window addressing from a rollout's episode steps and dones:
    the window's first slot ``max(e - L + 1, 0)``, its valid slots up to the
    episode's last step inside the rollout."""
    W, T = episode_steps.shape
    e = episode_steps.long()
    t = torch.arange(T, device=e.device)[None, :]
    s_lo = (e - (L - 1)).clamp(min=0).clamp(max=max_ep - L)
    done_at = torch.where(dones, t, T - 1)
    last = torch.flip(torch.cummin(torch.flip(done_at, [1]), 1).values, [1])
    start = e[:, :1] + t - e + s_lo
    hi = torch.minimum(s_lo + L - 1, e + (last - t))
    return Timeline(start, (hi - s_lo + 1).clamp(1, L), s_lo)


def window_bound_s(src: Timeline, idx, T: int, W: int, max_ep: int, L: int,
                   D: int, backward: bool) -> float:
    """Least seconds of one window-attention call over the samples ``idx``
    (flat ``w * T + t``): the larger of its bytes over the HBM rate and its
    FLOPs over the float32 peak. Bytes: each distinct timeline and PE row
    read once (K and V), the queries (and the output gradient) and the four
    indices read and the mask; the output written, or for the backward dq
    and the four gradient tables whole. FLOPs: 4 B L D forward, 8 B L D
    backward."""
    B = idx.numel()
    w, t = idx // T, idx % T
    start, n_valid = src.start[w, t], src.n_valid[w, t]
    s_lo = src.s_lo[w, t]
    S, P = max_ep + T + L, max_ep
    offs = torch.arange(L, device=idx.device)
    valid = offs[None] < n_valid[:, None]
    rows = (w[:, None] * S + start[:, None] + offs[None])[valid]
    pe_rows = (s_lo[:, None] + offs[None])[~valid]
    n_rows = rows.unique().numel() + pe_rows.unique().numel()
    n_bytes = 2 * n_rows * D * 4 + 2 * B * D * 4 + 4 * B * 4 + B * L
    flops = 4 * B * L * D
    if backward:
        n_bytes += B * D * 4 + 2 * (W * S + P) * D * 4
        flops = 8 * B * L * D
    return max(n_bytes / H100_BYTES_PER_S, flops / H100_FP32_FLOPS)
