"""Generalized Advantage Estimation (counterpart of ``etmppo_tpu/ops/gae.py``).

A reverse loop over t = T-1 .. 0 with ``mask = ~done``::

    last_value     = last_value * mask[t]
    last_advantage = last_advantage * mask[t]
    delta          = reward[t] + gamma * last_value - value[t]
    last_advantage = delta + gamma * lamda * last_advantage
    advantage[t]   = last_advantage
    last_value     = value[t]
"""
from __future__ import annotations

import torch


def calc_advantages(rewards: torch.Tensor, values: torch.Tensor,
                    dones: torch.Tensor, last_value: torch.Tensor,
                    gamma: float, lamda: float) -> torch.Tensor:
    """rewards/values: (W, T) float; dones: (W, T) bool; last_value: (W,).
    Returns advantages (W, T)."""
    mask = (~dones).to(values.dtype)
    advantages = torch.empty_like(values)
    last_v = last_value
    last_adv = torch.zeros_like(last_value)
    for t in range(values.shape[1] - 1, -1, -1):
        last_v = last_v * mask[:, t]
        last_adv = last_adv * mask[:, t]
        delta = rewards[:, t] + gamma * last_v - values[:, t]
        last_adv = delta + gamma * lamda * last_adv
        advantages[:, t] = last_adv
        last_v = values[:, t]
    return advantages
