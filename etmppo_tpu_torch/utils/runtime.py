"""Runtime settings of the process (counterpart of
``etmppo_tpu/utils/runtime.py``, which sets JAX's compilation cache).

``resolve_device`` chooses the device and decides float32 precision: it
turns TF32 off for matmuls and for cuDNN's convolutions. PyTorch leaves
``torch.backends.cudnn.allow_tf32`` on by default, so without this the card
would run the CNN's convolutions in TF32 while the parity tests hold
float32. The flags are process-wide, so they are set whatever the device
(harmless on the CPU, where a test can see them).

Every entry point goes through it: ``PPOTrainer.__init__`` (training and
``cli.py``) and ``training/checkpoint.load_model``, which ``PolicyServer``,
``serve_http``, ``Evaluation`` through ``evaluate_model`` /
``evaluate_protocol``, and ``enjoy.run_episodes`` call. No other module of
the package sets either flag.
"""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """The device to run on, with float32 precision set; raises rather than
    fall back to the CPU."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "(--cpu) to run on the CPU")
    return device
