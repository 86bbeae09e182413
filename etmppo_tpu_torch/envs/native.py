"""ctypes wrapper for the native (C++) batched environment engine
(counterpart of ``etmppo_tpu/envs/native.py``).

Presents the same vectorized API as ``envs/host.py``'s ``HostEnvBatch``
(``reset_all`` / ``step`` with auto-reset and per-episode info), so the host
rollout (``training/host_rollout.py``) drives it unchanged; the envs step in
a native thread pool without the interpreter (``csrc/env_batch.cpp``, a copy
of the JAX package's ``native/env_batch.cpp``).

The shared library is built on first use with g++ into the package's
``_build/`` directory by ``utils/build.build``, keyed by a hash of the
source and the flags, with the JAX package's flags exactly (no
``-ffast-math``), so the two engines give the same bits. Each env has its
own ``std::mt19937``, seeded from the batch seed and its index, so results
do not depend on the thread count.
Environment types: ``CartPole-native``, ``CartPoleMasked-native``,
``PocMemoryEnv-native``.
"""
from __future__ import annotations

import ctypes
import os
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..utils import build

SOURCE = build.CSRC / "env_batch.cpp"
GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17", "-pthread")

ENV_TYPE_IDS = {
    "CartPole-native": 0,
    "CartPoleMasked-native": 1,
    "PocMemoryEnv-native": 2,
}


def library_path() -> Path:
    """The library's path, keyed by the source and g++'s flags."""
    return build.library_path(SOURCE, GXX_FLAGS, build.BUILD_DIR)


def build_native_library() -> Path:
    """Compiles ``csrc/env_batch.cpp`` with g++ (``utils/build.build``)
    unless a library built from the same source and flags is already there;
    returns its path."""
    return build.build("g++", GXX_FLAGS, SOURCE, build.BUILD_DIR)


def _load_library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_native_library()))
    lib.etmppo_create.restype = ctypes.c_void_p
    lib.etmppo_create.argtypes = [ctypes.c_int, ctypes.c_int,
                                  ctypes.c_uint64, ctypes.c_int]
    lib.etmppo_destroy.restype = None
    lib.etmppo_destroy.argtypes = [ctypes.c_void_p]
    lib.etmppo_spec.restype = None
    lib.etmppo_spec.argtypes = [ctypes.c_void_p] + [
        ctypes.POINTER(ctypes.c_int)] * 3
    lib.etmppo_reset_all.restype = None
    lib.etmppo_reset_all.argtypes = [ctypes.c_void_p,
                                     ctypes.POINTER(ctypes.c_float)]
    lib.etmppo_step.restype = None
    lib.etmppo_step.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_float)]
    lib.etmppo_info_fields.restype = ctypes.c_int
    lib.etmppo_info_fields.argtypes = []
    return lib


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


class NativeEnvBatch:
    """HostEnvBatch-compatible native environment batch."""

    info_keys = ("reward", "length", "success")
    kernels = ()        # it launches no CUDA kernel

    def __init__(self, env_type: str, seed: int = 0,
                 n_threads: Optional[int] = None):
        if env_type not in ENV_TYPE_IDS:
            raise ValueError(
                f"unknown native env type {env_type!r}; "
                f"available: {sorted(ENV_TYPE_IDS)}")
        self._lib = _load_library()
        self._type_id = ENV_TYPE_IDS[env_type]
        self._seed = seed
        self._n_threads = n_threads or (os.cpu_count() or 1)
        self._handle = None
        self._n_envs = 0
        # The spec, from a 1-env instance.
        handle = self._lib.etmppo_create(self._type_id, 1, seed, 1)
        obs_dim, n_actions, max_steps = (ctypes.c_int(), ctypes.c_int(),
                                         ctypes.c_int())
        self._lib.etmppo_spec(handle, ctypes.byref(obs_dim),
                              ctypes.byref(n_actions), ctypes.byref(max_steps))
        self._lib.etmppo_destroy(handle)
        self.observation_shape: Tuple[int, ...] = (obs_dim.value,)
        self.action_branches: Tuple[int, ...] = (n_actions.value,)
        self.max_episode_steps = max_steps.value
        self._info_fields = self._lib.etmppo_info_fields()

    def start(self, n_envs: int) -> None:
        self._n_envs = n_envs
        self._handle = self._lib.etmppo_create(
            self._type_id, n_envs, self._seed, self._n_threads)
        d = self.observation_shape[0]
        self._obs = np.empty((n_envs, d), np.float32)
        self._rewards = np.empty(n_envs, np.float32)
        self._dones = np.empty(n_envs, np.uint8)
        self._infos = np.empty((n_envs, self._info_fields), np.float32)

    def reset_all(self) -> np.ndarray:
        self._lib.etmppo_reset_all(self._handle,
                                   _ptr(self._obs, ctypes.c_float))
        return self._obs.copy()

    def step(self, actions: np.ndarray
             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                        List[Optional[Dict]]]:
        """actions: (n_envs, n_branches) ints; the first branch is taken."""
        acts = np.ascontiguousarray(
            np.asarray(actions).reshape(self._n_envs, -1)[:, 0], np.int32)
        self._lib.etmppo_step(
            self._handle, _ptr(acts, ctypes.c_int32),
            _ptr(self._obs, ctypes.c_float),
            _ptr(self._rewards, ctypes.c_float),
            _ptr(self._dones, ctypes.c_uint8),
            _ptr(self._infos, ctypes.c_float))
        infos: List[Optional[Dict]] = []
        for i in range(self._n_envs):
            if self._infos[i, 0] > 0:
                infos.append({"reward": float(self._infos[i, 1]),
                              "length": float(self._infos[i, 2]),
                              "success": float(self._infos[i, 3])})
            else:
                infos.append(None)
        return (self._obs.copy(), self._rewards.copy(),
                self._dones.astype(bool), infos)

    def close(self) -> None:
        if self._handle is not None:
            self._lib.etmppo_destroy(self._handle)
            self._handle = None
