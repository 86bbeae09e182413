"""Environment factory (counterpart of ``etmppo_tpu/envs/factory.py``).

The on-device envs are ported: PocMemory, CartPole (plain and masked),
MiniGrid-Memory, Mystery Path Grid, Mortar Mayhem Grid and Searing
Spotlights. Every other type (the host bridge's ``-host`` types and the
non-Grid MemoryGym names, the ``-native`` types) raises.
"""
from __future__ import annotations

from ..config import EnvConfig
from .core import TorchEnv


def create_env(config: EnvConfig, n_workers: int, device) -> TorchEnv:
    if config.type == "PocMemoryEnv":
        from .poc_memory import PocMemoryEnv
        return PocMemoryEnv(glob=False, freeze=True, max_episode_steps=32,
                            n_workers=n_workers, device=device)
    if config.type in ("CartPole", "CartPoleMasked"):
        from .cartpole import CartPole
        return CartPole(config.type == "CartPoleMasked", n_workers, device)
    if config.type == "Minigrid":
        from .minigrid_memory import MinigridMemoryEnv
        return MinigridMemoryEnv(config.name, n_workers, device)
    if config.type == "MysteryPath-Grid":
        from .mystery_path import MysteryPathGridEnv
        return MysteryPathGridEnv(config.reset_params, n_workers, device)
    if config.type == "MortarMayhem-Grid":
        from .mortar_mayhem import MortarMayhemGridEnv
        return MortarMayhemGridEnv(config.reset_params, n_workers, device)
    if config.type == "SearingSpotlights":
        from .searing_spotlights import SearingSpotlightsEnv
        return SearingSpotlightsEnv(config.reset_params, n_workers, device)
    raise NotImplementedError(
        f"environment type {config.type!r} is not ported to PyTorch yet")
