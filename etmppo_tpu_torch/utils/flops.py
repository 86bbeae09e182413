"""FLOP accounting and MFU (counterpart of ``etmppo_tpu/utils/flops.py``).

* ``counted_flops``: the FLOPs of one call, counted by PyTorch's
  ``FlopCounterMode`` (matrix products and convolutions, the counterpart of
  XLA's cost analysis). It cannot see the window-attention kernels, which
  are launched through ctypes: add ``window_attention_flops`` for them
  where the caller runs the pair.
* ``window_attention_flops``: the analytic count of one window-attention
  application.
* ``mfu``: achieved FLOP/s as a fraction of the device's peak.

The peak is the dense bf16 tensor-core rate, as the JAX package takes the
bf16 MXU rate, even for float32 programs: MFU then reads "how far from the
card's speed of light".
"""
from __future__ import annotations

from typing import Optional

import torch

# Dense (no sparsity) bf16 tensor-core peak of the H100 SXM5 in FLOP/s, from
# NVIDIA's "H100 Tensor Core GPU" datasheet (which gives twice it with
# sparsity). Every CUDA device is measured against it, so that MFU stays
# comparable from card to card.
H100_BF16_PEAK_FLOPS = 989.4e12
CPU_NOMINAL_FLOPS = 1e11         # nominal, for testing the plumbing


def device_peak_flops(device="cuda") -> float:
    """Peak FLOP/s of ``device`` (default: the CUDA device; raises without a
    GPU)."""
    device = torch.device(device)
    if device.type == "cpu":
        return CPU_NOMINAL_FLOPS
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to use the CPU's nominal peak")
    return H100_BF16_PEAK_FLOPS


def counted_flops(fn, *args, **kwargs) -> float:
    """FLOPs of one call ``fn(*args, **kwargs)`` (a backward run inside the
    call counts too). The ctypes kernels are invisible to the counter: add
    ``window_attention_flops`` for them."""
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    return float(counter.get_total_flops())


def window_attention_flops(B: int, L: int, D: int, backward: bool = False
                           ) -> float:
    """Analytic FLOPs for one episodic window-attention application:
    B queries (one per sample), each attending over L memory slots of model
    width D (multi-head split does not change the total).

    Forward: scores Q·K^T (2·B·L·D) + mix P·V (2·B·L·D) = 4·B·L·D.
    Backward: dV, dP, dQ, dK each 2·B·L·D -> 8·B·L·D (softmax/elementwise
    terms are O(B·L) and ignored, as the counter ignores them).
    """
    return (8.0 if backward else 4.0) * B * L * D


def mfu(flops_per_step: float, seconds_per_step: float,
        peak_flops: Optional[float] = None) -> float:
    """Achieved fraction of peak: (FLOPs/step / s/step) / peak FLOP/s."""
    if peak_flops is None:
        peak_flops = device_peak_flops()
    return flops_per_step / max(seconds_per_step, 1e-12) / peak_flops
