"""memory-gym wrapper for the host-environment bridge (counterpart of
``etmppo_tpu/envs/memory_gym_wrapper.py``).

Behavioral spec (reference: environments/memory_gym_env.py): gymnasium
``memory_gym`` envs (MortarMayhem / MysteryPath / SearingSpotlights, +Grid
variants); per-reset seed sampled uniformly from
[start-seed, start-seed + num-seeds); non-seed reset params forwarded as
gymnasium options; observations scaled to [0, 1]; episode info from the env's
final info dict.  Only importable when the optional memory-gym package is
installed.
"""
from __future__ import annotations

import random
from typing import Any, Dict, Optional

import numpy as np

import gymnasium as gym
import memory_gym  # noqa: F401  (registers the envs)


class _Space:
    def __init__(self, shape=None, n=None):
        self.shape = shape
        self.n = n


class MemoryGymWrapper:
    def __init__(self, env_name: str, reset_params: Optional[Dict] = None,
                 realtime_mode: bool = False):
        self._reset_params = dict(reset_params or
                                  {"start-seed": 0, "num-seeds": 100})
        render_mode = "human" if realtime_mode else None
        self._env = gym.make(env_name, disable_env_checker=True,
                             render_mode=render_mode)
        shape = self._env.observation_space.shape
        self.observation_space = _Space(shape=(shape[2], shape[1], shape[0]))
        self.action_space = _Space(n=int(np.prod(
            getattr(self._env.action_space, "nvec", None)
            if hasattr(self._env.action_space, "nvec")
            else self._env.action_space.n)))
        self._rewards = []

    @property
    def max_episode_steps(self) -> int:
        self._env.reset()
        # .unwrapped: gymnasium >= 1.0 removed implicit attribute forwarding
        # through wrapper chains (gym.make adds OrderEnforcing etc.).
        return int(self._env.unwrapped.max_episode_steps)

    def reset(self):
        params = self._reset_params
        seed = random.randint(params["start-seed"],
                              params["start-seed"] + params["num-seeds"] - 1)
        options = {k: v for k, v in params.items()
                   if k not in ("start-seed", "num-seeds", "seed")}
        self._rewards = []
        obs, _ = self._env.reset(seed=seed, options=options)
        return np.swapaxes(np.swapaxes(obs, 0, 2), 2, 1) / 255.0

    def step(self, action):
        if isinstance(action, (list, np.ndarray)) and len(action) == 1:
            action = action[0]
        obs, reward, done, truncation, info = self._env.step(action)
        self._rewards.append(reward)
        obs = np.swapaxes(np.swapaxes(obs, 0, 2), 2, 1) / 255.0
        if done:
            info = {"reward": sum(self._rewards),
                    "length": len(self._rewards), **(info or {})}
        else:
            info = None
        return obs, reward, done, info

    def render(self):
        self._env.render()

    def close(self):
        self._env.close()
