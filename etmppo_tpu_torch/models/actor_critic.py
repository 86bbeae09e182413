"""Actor-critic policy with an episodic-memory transformer core
(counterpart of ``etmppo_tpu/models/actor_critic.py``).

* Observation encoder: for images, a 3-layer Atari CNN (32x8s4 -> 64x4s2 ->
  64x3s1, VALID, orthogonal gain sqrt(2)); identity for vectors.
  Observations are NHWC at the API, as in the JAX package. They are permuted
  to NCHW for ``conv2d`` and the feature map is permuted back to NHWC before
  it is flattened, so ``lin_hidden`` sees features in the JAX package's (HWC)
  order and takes its weights unchanged.
* ``lin_hidden`` to embed_dim, the transformer, then decoupled policy/value
  hidden layers, one policy head per action branch (gain sqrt(0.01)) and a
  value head (gain 1).

Every module is built on an explicit ``device`` and initialised from an
explicit ``torch.Generator``.

``config.compute_dtype`` is the dtype of the encoder (observations cast to
it first), ``lin_hidden``, the transformer and ``lin_policy`` /
``lin_value``, with flax's semantics (``models/transformer.py``); the value
and policy heads are float32 layers on a float32 input, the memory enters
the transformer in the compute dtype and ``new_memory`` leaves it as
float32, as in the JAX package. The parameters are float32 either way.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import TrainConfig
from ..utils.runtime import compute_dtype
from .initializers import orthogonal_, uniform_fan_in_
from .transformer import Transformer, _linear


def _conv_out_hw(hw: int) -> int:
    """Spatial size after the 8s4 / 4s2 / 3s1 VALID conv stack."""
    hw = (hw - 8) // 4 + 1
    hw = (hw - 4) // 2 + 1
    return (hw - 3) // 1 + 1


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` (VALID) that computes in ``compute_dtype``: input,
    weight and bias cast to it (flax's ``Conv(dtype=...)``); float32
    parameters."""

    def __init__(self, c_in: int, c_out: int, kernel: int, stride: int,
                 device, compute_dtype: torch.dtype):
        super().__init__(c_in, c_out, kernel, stride=stride, device=device)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return self._conv_forward(x.to(dt), self.weight.to(dt),
                                  self.bias.to(dt))


def _conv(c_in: int, c_out: int, kernel: int, stride: int, device,
          generator, dtype: torch.dtype) -> Conv2d:
    conv = Conv2d(c_in, c_out, kernel, stride, device, dtype)
    orthogonal_(conv.weight, math.sqrt(2), generator)
    uniform_fan_in_(conv.bias, c_in * kernel * kernel, generator)
    return conv


class ActorCriticModel(nn.Module):
    """``forward`` returns (branch_logits: list of (B, A_i), value: (B,),
    new_memory: (B, blocks, D))."""

    def __init__(self, config: TrainConfig, obs_shape: Tuple[int, ...],
                 action_branches: Tuple[int, ...], max_episode_steps: int,
                 device="cuda", generator: Optional[torch.Generator] = None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(config.seed)
        self.config = config
        self.obs_shape = tuple(obs_shape)
        self.action_branches = tuple(action_branches)
        self.max_episode_steps = max_episode_steps
        D = config.transformer.embed_dim
        hidden = config.hidden_layer_size
        self.compute_dtype = dt = compute_dtype(config)
        self.is_visual = len(self.obs_shape) > 1
        if self.is_visual:
            H, W, C = self.obs_shape
            self.conv1 = _conv(C, 32, 8, 4, device, generator, dt)
            self.conv2 = _conv(32, 64, 4, 2, device, generator, dt)
            self.conv3 = _conv(64, 64, 3, 1, device, generator, dt)
            feat_in = _conv_out_hw(H) * _conv_out_hw(W) * 64
        else:
            feat_in = self.obs_shape[0]
        sqrt2 = math.sqrt(2)
        self.lin_hidden = _linear(feat_in, D, True, device, generator,
                                  gain=sqrt2, dtype=dt)
        self.transformer = Transformer(config.transformer, max_episode_steps,
                                       device, generator, dt)
        self.lin_policy = _linear(D, hidden, True, device, generator,
                                  gain=sqrt2, dtype=dt)
        self.lin_value = _linear(D, hidden, True, device, generator,
                                 gain=sqrt2, dtype=dt)
        self.value = _linear(hidden, 1, True, device, generator, gain=1.0)
        self.policy_branches = nn.ModuleList(
            [_linear(hidden, n, True, device, generator, gain=math.sqrt(0.01))
             for n in self.action_branches])

    # --- pieces ----------------------------------------------------------

    def encode(self, obs: torch.Tensor) -> torch.Tensor:
        h = obs.to(self.compute_dtype)
        if self.is_visual:
            h = h.permute(0, 3, 1, 2)                  # NHWC -> NCHW
            h = F.relu(self.conv1(h))
            h = F.relu(self.conv2(h))
            h = F.relu(self.conv3(h))
            h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)   # HWC order
        return F.relu(self.lin_hidden(h))

    def heads(self, h: torch.Tensor):
        h_policy = F.relu(self.lin_policy(h)).float()
        h_value = F.relu(self.lin_value(h)).float()
        value = self.value(h_value).reshape(-1)
        return [branch(h_policy) for branch in self.policy_branches], value

    # --- entry points ----------------------------------------------------

    def forward(self, obs, memory, memory_mask, memory_indices):
        """Reference-semantics forward on a raw memory window."""
        h = self.encode(obs)
        h, new_memory = self.transformer(h, memory.to(h.dtype), memory_mask,
                                         memory_indices)
        logits, value = self.heads(h)
        return logits, value, new_memory.float()

    def forward_with_kv(self, obs, k_win, v_win, memory_mask):
        h, new_memory = self.transformer.forward_with_kv(
            self.encode(obs), k_win, v_win, memory_mask)
        logits, value = self.heads(h)
        return logits, value, new_memory.float()

    def forward_with_ops(self, obs, ops: Sequence[Callable]):
        h, new_memory = self.transformer.forward_with_ops(self.encode(obs), ops)
        logits, value = self.heads(h)
        return logits, value, new_memory.float()

    def project_memory(self, memory, slots):
        return self.transformer.project_memory(memory, slots)

    def project_memory_blocks(self, memory, slots):
        return self.transformer.project_memory_blocks(memory, slots)

    def pe_kv(self):
        return self.transformer.pe_kv()

    def pe_kv_blocks(self):
        return self.transformer.pe_kv_blocks()
