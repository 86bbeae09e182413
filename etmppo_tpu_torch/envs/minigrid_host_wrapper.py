"""gym-minigrid wrapper for the host-environment bridge (counterpart of
``etmppo_tpu/envs/minigrid_host_wrapper.py``).

Behavioral spec (reference: environments/minigrid_env.py): any gym-minigrid
env rendered as RGB partial observations; Memory-* tasks get view size 3,
tile size 28 (84x84 obs), a 96-step cap and a 3-action space; other tasks get
view size 7, tile size 8, 64 steps.  Obs scaled to [0,1]; random seed per
reset.  Only importable when the optional gym-minigrid package is installed
(the on-device envs/minigrid_memory.py covers the Memory tasks without it).
"""
from __future__ import annotations

import numpy as np

import gym
from gym import spaces
from gym_minigrid.wrappers import (ImgObsWrapper, RGBImgPartialObsWrapper,
                                   ViewSizeWrapper)


class MinigridHostWrapper:
    def __init__(self, name: str):
        self._env = gym.make(name)
        if "Memory" in name:
            view_size, self.tile_size = 3, 28
            self.max_episode_steps = 96
            self._action_space = spaces.Discrete(3)
        else:
            view_size, self.tile_size = 7, 8
            self.max_episode_steps = 64
            self._action_space = self._env.action_space
        hw = view_size * self.tile_size
        self._env = ViewSizeWrapper(self._env, view_size)
        self._env = RGBImgPartialObsWrapper(self._env, tile_size=self.tile_size)
        self._env = ImgObsWrapper(self._env)
        self.observation_space = spaces.Box(
            low=0, high=1.0, shape=(3, hw, hw), dtype=np.float32)

    @property
    def action_space(self):
        return self._action_space

    def _to_chw(self, obs):
        obs = obs.astype(np.float32) / 255.0
        return np.swapaxes(np.swapaxes(obs, 0, 2), 2, 1)

    def reset(self):
        self._env.seed(np.random.randint(0, 999))
        self.t = 0
        self._rewards = []
        return self._to_chw(self._env.reset())

    def step(self, action):
        obs, reward, done, info = self._env.step(action[0])
        self._rewards.append(reward)
        if self.t == self.max_episode_steps - 1:
            done = True
        info = ({"reward": sum(self._rewards), "length": len(self._rewards)}
                if done else None)
        self.t += 1
        return self._to_chw(obs), reward, done, info

    def render(self):
        return self._env.render(tile_size=96)

    def close(self):
        self._env.close()
