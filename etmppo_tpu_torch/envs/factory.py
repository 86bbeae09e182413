"""Environment factory (counterpart of ``etmppo_tpu/envs/factory.py``).

MiniGrid-Memory, Mystery Path Grid and Mortar Mayhem Grid are ported; every
other type raises.
"""
from __future__ import annotations

from ..config import EnvConfig
from .core import TorchEnv


def create_env(config: EnvConfig, n_workers: int, device) -> TorchEnv:
    if config.type == "Minigrid":
        from .minigrid_memory import MinigridMemoryEnv
        return MinigridMemoryEnv(config.name, n_workers, device)
    if config.type == "MysteryPath-Grid":
        from .mystery_path import MysteryPathGridEnv
        return MysteryPathGridEnv(config.reset_params, n_workers, device)
    if config.type == "MortarMayhem-Grid":
        from .mortar_mayhem import MortarMayhemGridEnv
        return MortarMayhemGridEnv(config.reset_params, n_workers, device)
    raise NotImplementedError(
        f"environment type {config.type!r} is not ported to PyTorch yet")
