"""Host-environment bridge: batched process-parallel driver for Python envs
(counterpart of ``etmppo_tpu/envs/host.py``).

Replacement for the reference's one-process-per-env pipe RPC
(worker.py:36-48, trainer.py:189-194).  Differences:

* P worker processes each own a *slice* of environments (default: one process
  per CPU), so a 32-env step costs P pipe round-trips, not 32.
* Messages carry batched numpy arrays; the parent exposes a vectorized
  ``reset_all() -> obs`` / ``step(actions) -> (obs, rewards, dones, infos)``
  with auto-reset inside the worker (mirroring trainer.py:195-213: on done the
  returned obs is the next episode's first observation and the completed
  episode's info dict is surfaced).
* Worker exceptions propagate with tracebacks (reference: worker.py:50-62).

The Python env protocol is the reference's duck-typed one (README.md:216):
``observation_space.shape``, ``action_space.n``, ``max_episode_steps``,
``reset()``, ``step(action) -> (obs, reward, done, info)``.

Observations are converted CHW -> HWC at the bridge boundary (the layout of
the on-device envs and the model's input).

Workers are forked, as in the JAX package, and may be forked after the
parent has started using the CUDA device (``chip_smoke.py`` does). That is
safe only because this module and its workers use numpy alone: a forked
child must never touch torch, since the parent's CUDA context and torch's
thread pools do not survive a fork. Envs made by ``make_env`` must keep to
that too.
"""
from __future__ import annotations

import multiprocessing as mp
import os
import sys
import traceback
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np


def _worker_loop(remote, make_env: Callable[[], Any], n_envs: int):
    try:
        envs = [make_env() for _ in range(n_envs)]
        while True:
            cmd, data = remote.recv()
            if cmd == "reset":
                obs = np.stack([_to_hwc(e.reset()) for e in envs])
                remote.send(("ok", obs))
            elif cmd == "step":
                obs_list, rewards, dones, infos = [], [], [], []
                for env, action in zip(envs, data):
                    obs, reward, done, info = env.step(list(action))
                    if done:
                        infos.append(info or {})
                        obs = env.reset()
                    else:
                        infos.append(None)
                    obs_list.append(_to_hwc(obs))
                    rewards.append(reward)
                    dones.append(done)
                remote.send(("ok", (np.stack(obs_list),
                                    np.asarray(rewards, np.float32),
                                    np.asarray(dones, bool), infos)))
            elif cmd == "spec":
                e = envs[0]
                shape = tuple(e.observation_space.shape)
                if len(shape) == 3:
                    shape = (shape[1], shape[2], shape[0])  # CHW -> HWC
                remote.send(("ok", {
                    "obs_shape": shape,
                    "n_actions": int(e.action_space.n),
                    "max_episode_steps": int(e.max_episode_steps)}))
            elif cmd == "close":
                for e in envs:
                    e.close()
                remote.send(("ok", None))
                remote.close()
                return
    except Exception as exc:  # propagate with traceback (worker.py:50-62)
        remote.send(("error", (repr(exc), traceback.format_exc())))


def _to_hwc(obs: np.ndarray) -> np.ndarray:
    obs = np.asarray(obs, np.float32)
    if obs.ndim == 3 and obs.shape[0] in (1, 3, 4) and obs.shape[0] < obs.shape[2]:
        obs = np.transpose(obs, (1, 2, 0))
    return obs


class HostEnvBatch:
    """Process-parallel batch of Python environments behind a vectorized API.

    Construct with an EnvConfig (uses the reference's env packages when
    installed) or pass ``make_env`` explicitly for custom/test envs.
    """

    kernels = ()        # it launches no CUDA kernel

    def __init__(self, config=None, make_env: Optional[Callable] = None,
                 n_envs: int = 0, n_procs: int = 0):
        if make_env is None:
            make_env = _python_env_factory(config)
        self.make_env = make_env
        self._pipes: List[Any] = []
        self._procs: List[Any] = []
        self._counts: List[int] = []
        self._n_envs = n_envs
        self._n_procs = n_procs or min(max(os.cpu_count() or 1, 1), 8)
        self._started = False
        # Probe a single env for the spec (reference: trainer.py:44-49).
        probe = make_env()
        shape = tuple(probe.observation_space.shape)
        if len(shape) == 3:
            shape = (shape[1], shape[2], shape[0])
        self.observation_shape = shape
        self.action_branches = (int(probe.action_space.n),)
        self.max_episode_steps = int(probe.max_episode_steps)
        probe.close()
        self.info_keys = ("reward", "length")

    def start(self, n_envs: int, n_groups: int = 1) -> None:
        """Spawns worker processes. With ``n_groups`` > 1 the env range is
        split into equal groups whose processes are disjoint, enabling
        ``step_group`` (used by the pipelined host rollout to overlap one
        group's env stepping with the other group's device compute)."""
        if self._started:
            raise RuntimeError("the host env batch is already started")
        if n_envs % n_groups != 0:
            raise ValueError(f"{n_envs} envs do not split into {n_groups} "
                             "equal groups: host_pipeline_groups must "
                             "divide a pool's envs, n_workers / "
                             "num_devices under data parallelism")
        self._n_envs = n_envs
        self._n_groups = n_groups
        self._group_pipes: List[List[int]] = [[] for _ in range(n_groups)]
        per_group = n_envs // n_groups
        procs_per_group = max(1, min(self._n_procs, per_group) // n_groups
                              if n_groups > 1 else min(self._n_procs, n_envs))
        ctx = mp.get_context("fork")
        for g in range(n_groups):
            base, extra = divmod(per_group, procs_per_group)
            for i in range(procs_per_group):
                count = base + (1 if i < extra else 0)
                if count == 0:
                    continue
                parent, child = ctx.Pipe()
                proc = ctx.Process(
                    target=_worker_loop, args=(child, self.make_env, count),
                    daemon=True)
                proc.start()
                self._group_pipes[g].append(len(self._pipes))
                self._pipes.append(parent)
                self._procs.append(proc)
                self._counts.append(count)
        self._started = True

    def _recv(self, pipe):
        status, payload = pipe.recv()
        if status == "error":
            raise RuntimeError(
                f"host env worker failed: {payload[0]}\n{payload[1]}")
        return payload

    def _respawn(self, i: int) -> np.ndarray:
        """Failure recovery (no reference equivalent — a worker crash kills
        the reference's training, worker.py:33-34): replace a dead/failed
        worker process with a fresh one and return its envs' reset obs."""
        try:
            self._procs[i].terminate()
        except Exception:
            pass
        ctx = mp.get_context("fork")
        parent, child = ctx.Pipe()
        proc = ctx.Process(
            target=_worker_loop, args=(child, self.make_env, self._counts[i]),
            daemon=True)
        proc.start()
        self._pipes[i] = parent
        self._procs[i] = proc
        parent.send(("reset", None))
        return self._recv(parent)

    def reset_all(self) -> np.ndarray:
        for pipe in self._pipes:
            pipe.send(("reset", None))
        return np.concatenate([self._recv(p) for p in self._pipes])

    def step_group(self, group: int, actions: np.ndarray
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                              List[Optional[Dict]]]:
        """Steps only the envs of ``group`` (actions indexed within the
        group).  Groups own disjoint worker processes, so concurrent use of
        different groups never contends on a pipe."""
        pipe_ids = self._group_pipes[group]
        offset = 0
        for pid in pipe_ids:
            count = self._counts[pid]
            self._pipes[pid].send(("step", actions[offset:offset + count]))
            offset += count
        obs, rewards, dones, infos = [], [], [], []
        for pid in pipe_ids:
            o, r, d, i = self._recv(self._pipes[pid])
            obs.append(o)
            rewards.append(r)
            dones.append(d)
            infos.extend(i)
        return (np.concatenate(obs), np.concatenate(rewards),
                np.concatenate(dones), infos)

    def step(self, actions: np.ndarray, restart_on_failure: bool = True
             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, List[Optional[Dict]]]:
        """actions: (n_envs, n_branches) int array.

        With ``restart_on_failure`` a crashed worker is respawned and its envs
        report a truncated episode (done=True, no info) instead of killing
        training."""
        offset = 0
        for pipe, count in zip(self._pipes, self._counts):
            pipe.send(("step", actions[offset:offset + count]))
            offset += count
        obs, rewards, dones, infos = [], [], [], []
        for i, pipe in enumerate(self._pipes):
            try:
                o, r, d, info = self._recv(pipe)
            except (RuntimeError, EOFError, OSError) as exc:
                if not restart_on_failure:
                    raise
                print(f"[host-env] worker {i} failed, restarting: {exc}",
                      file=sys.stderr)
                o = self._respawn(i)
                count = self._counts[i]
                r = np.zeros(count, np.float32)
                d = np.ones(count, bool)
                info = [None] * count
            obs.append(o)
            rewards.append(r)
            dones.append(d)
            infos.extend(info)
        return (np.concatenate(obs), np.concatenate(rewards),
                np.concatenate(dones), infos)

    def close(self) -> None:
        """Asks each worker to close its envs, waiting a bounded time for
        the answer, then joins it, terminating one that does not exit."""
        for pipe in self._pipes:
            try:
                pipe.send(("close", None))
                if pipe.poll(2.0):
                    pipe.recv()
            except (OSError, EOFError):   # the worker is already gone
                pass
        for proc in self._procs:
            proc.join(timeout=2.0)
            if proc.is_alive():
                proc.terminate()
                proc.join(timeout=2.0)
        self._started = False
        self._pipes, self._procs, self._counts = [], [], []


def _python_env_factory(config) -> Callable[[], Any]:
    """Factory for the reference's Python envs; import-gated because the
    packages (memory-gym, gym-minigrid) are optional."""
    env_type = config.type
    name = config.name
    reset_params = dict(config.reset_params)

    def make():
        if env_type == "Minigrid":
            try:
                from .minigrid_host_wrapper import MinigridHostWrapper
            except ImportError as exc:
                raise ImportError(
                    "environment type 'Minigrid-host' needs the gym-minigrid "
                    "package (the on-device Memory tasks need no package)"
                ) from exc
            return MinigridHostWrapper(name)
        if env_type in ("SearingSpotlights", "MortarMayhem",
                        "MortarMayhem-Grid", "MysteryPath", "MysteryPath-Grid"):
            try:
                from .memory_gym_wrapper import MemoryGymWrapper
            except ImportError as exc:
                raise ImportError(
                    f"environment type {env_type!r} needs the memory-gym "
                    f"package (pip install memory-gym)") from exc
            return MemoryGymWrapper(name, reset_params)
        raise ValueError(f"Unknown host environment type: {env_type!r}")

    return make
