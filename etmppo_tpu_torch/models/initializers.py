"""Parameter initializers (counterpart of ``etmppo_tpu/models/initializers.py``).

The distributions are PyTorch's defaults and the reference's explicit ones:
``U(-1/sqrt(fan_in), 1/sqrt(fan_in))`` for Linear/Conv weights and biases,
orthogonal with a gain for the layers the reference orthogonalizes, and
xavier-uniform for GRU gates. Every draw comes from an explicit
``torch.Generator`` so that a model is a function of its seed.
"""
from __future__ import annotations

import math

import torch


@torch.no_grad()
def uniform_fan_in_(tensor: torch.Tensor, fan_in: int,
                    generator: torch.Generator) -> torch.Tensor:
    """U(-1/sqrt(fan_in), 1/sqrt(fan_in)), in place."""
    bound = 1.0 / math.sqrt(fan_in)
    values = torch.rand(tensor.shape, generator=generator) * (2 * bound) - bound
    return tensor.copy_(values)


@torch.no_grad()
def orthogonal_(tensor: torch.Tensor, gain: float,
                generator: torch.Generator) -> torch.Tensor:
    """Orthogonal init of ``tensor`` viewed as (shape[0], rest), in place."""
    rows = tensor.shape[0]
    cols = tensor.numel() // rows
    flat = torch.randn(rows, cols, generator=generator, dtype=torch.float64)
    if rows < cols:
        flat = flat.T
    q, r = torch.linalg.qr(flat)
    q = q * torch.sign(torch.diagonal(r))[None, :]
    if rows < cols:
        q = q.T
    return tensor.copy_((gain * q).reshape(tensor.shape))


@torch.no_grad()
def xavier_uniform_(tensor: torch.Tensor,
                    generator: torch.Generator) -> torch.Tensor:
    """Xavier/Glorot uniform for a 2-D weight, in place."""
    fan_a, fan_b = tensor.shape
    bound = math.sqrt(6.0 / (fan_a + fan_b))
    values = torch.rand(tensor.shape, generator=generator) * (2 * bound) - bound
    return tensor.copy_(values)


@torch.no_grad()
def normal_(tensor: torch.Tensor, std: float,
            generator: torch.Generator) -> torch.Tensor:
    return tensor.copy_(torch.randn(tensor.shape, generator=generator) * std)
