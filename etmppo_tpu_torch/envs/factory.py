"""Environment factory (counterpart of ``etmppo_tpu/envs/factory.py``).

The on-device envs (PocMemory, CartPole plain and masked, MiniGrid-Memory,
Mystery Path Grid, Mortar Mayhem Grid, Searing Spotlights) step all
``n_workers`` workers on ``device``. The host envs step on the CPU behind a
vectorized ``reset_all`` / ``step`` API and take their worker count at
``start``: the ``-native`` types in the C++ engine (``envs/native.py``),
and ``HOST_ENV_TYPES`` (the original Python packages, memory-gym and
gym-minigrid, where installed) in the process pool (``envs/host.py``).

Under data parallelism a rank builds its ``n_workers`` of the run's
``draw_workers``, starting at worker ``first_worker``: an on-device env
draws for all ``draw_workers`` (``TorchEnv.draw_width``); the C++ engine
takes the seed that makes its envs the single engine's envs from
``first_worker`` on (``native_seed``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from ..config import EnvConfig
from .core import TorchEnv

# memory-gym env families: the "-Grid" types are the on-device
# reimplementations (envs/mortar_mayhem.py, envs/mystery_path.py); append
# "-host" (or use a non-Grid type) to run the original Python packages
# through the host bridge.
HOST_ENV_TYPES = (
    "MortarMayhem", "MysteryPath",
    "MortarMayhem-Grid-host", "MysteryPath-Grid-host",
    "SearingSpotlights-host", "Minigrid-host",
)


# The C++ engine seeds env i of a batch seeded s with s + i * this (mod 2^64,
# csrc/env_batch.cpp's EnvBatch).
ENGINE_SEED_STRIDE = 0x9E3779B97F4A7C15


def native_seed(first_worker: int, seed: int = 0) -> int:
    """The batch seed whose env 0 is env ``first_worker`` of a batch seeded
    ``seed``."""
    return (seed + first_worker * ENGINE_SEED_STRIDE) % 2 ** 64


def create_env(config: EnvConfig, n_workers: int, device,
               first_worker: int = 0,
               draw_workers: Optional[int] = None) -> TorchEnv:
    env = _create_env(config, n_workers, device, first_worker)
    if draw_workers is not None and not hasattr(env, "reset_all"):
        env.draw_workers = draw_workers
    return env


def _create_env(config: EnvConfig, n_workers: int, device,
                first_worker: int) -> TorchEnv:
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
    if config.type.endswith("-native"):
        # As in the JAX package, the engine's seed is 0 (on one device).
        from .native import NativeEnvBatch
        return NativeEnvBatch(config.type, seed=native_seed(first_worker))
    if config.type in HOST_ENV_TYPES:
        from .host import HostEnvBatch
        host_config = config
        if config.type.endswith("-host"):
            host_config = dataclasses.replace(
                config, type=config.type[: -len("-host")])
        return HostEnvBatch(host_config)
    raise ValueError(f"Unknown environment type: {config.type!r}")
