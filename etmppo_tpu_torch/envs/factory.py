"""Environment factory (counterpart of ``etmppo_tpu/envs/factory.py``).

Only MiniGrid-Memory is ported so far; every other type raises.
"""
from __future__ import annotations

from ..config import EnvConfig
from .core import TorchEnv


def create_env(config: EnvConfig, n_workers: int, device) -> TorchEnv:
    if config.type == "Minigrid":
        from .minigrid_memory import MinigridMemoryEnv
        return MinigridMemoryEnv(config.name, n_workers, device)
    raise NotImplementedError(
        f"environment type {config.type!r} is not ported to PyTorch yet")
