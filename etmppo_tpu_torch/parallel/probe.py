"""Rank functions that train through ``PPOTrainer`` and return what a check
of a data-parallel run needs, on the CPU: the stats, the parameters and
their digests after each update, rows of the first update's batch, the
actions its rollout drew and their Gumbel-max margins, each kernel's
launches, the seconds of each rollout and PPO update, and the collectives'
traffic.

``tests/test_torch_data_parallel.py`` and chip_smoke.py's data-parallel
phase start ``train`` with ``mesh.spawn`` (a spawned rank imports it from
the package) and call it with no mesh for the one-device run they compare
with. ``Replay`` hands a run actions and draws made elsewhere (the JAX
package's, or the one-device run's), through the rollout's and the update's
seams. ``check_global_moments`` is one process of a multi-process check of
``multihost``.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..config import TrainConfig
from ..ops import distributions
from ..ops import window_attention as wa
from ..training.trainer import PPOTrainer
from .mesh import DataMesh, make_mesh, replica_digest, shard_worker_tree
from .multihost import (global_worker_array, initialize_multihost,
                        is_primary_host, local_worker_range,
                        process_index)

KERNELS = ("window_attention_fwd", "window_attention_bwd",
           "window_attention_fwd_grouped", "window_attention_bwd_grouped")


class Replay(NamedTuple):
    """Draws for all W workers, made elsewhere: the reset draws in the order
    the rollout consumes them (``init_state``'s first; None: the run's own),
    the actions of the first steps (W, steps, n_branches; the run's own
    after them), and each update's permutations (epochs, W * T; None: the
    run's own). A run keeps its rows of each."""
    reset: Optional[Sequence[Any]]
    actions: torch.Tensor
    perms: Optional[Sequence[torch.Tensor]]


class StubEnv:
    """A deterministic env of the reference's Python protocol (numpy only,
    the counterpart of the JAX package's sharding test's mock env): 3-float
    observations of the step count, 2 actions that change nothing, episodes
    of 9 steps. ``train(..., stub_pool=n)`` runs a process pool of them."""

    class _Space:
        def __init__(self, shape=None, n=None):
            self.shape = shape
            self.n = n

    observation_space = _Space(shape=(3,))
    action_space = _Space(n=2)
    max_episode_steps = 10

    def _obs(self):
        t = float(self.t)
        return np.asarray([np.sin(t), np.cos(t), t / 10.0], np.float32)

    def reset(self):
        self.t = 0
        return self._obs()

    def step(self, action):
        self.t += 1
        done = self.t >= 9
        info = ({"reward": 0.1 * self.t, "length": float(self.t)}
                if done else None)
        return self._obs(), np.float32(0.1 * self.t), done, info

    def close(self):
        pass


class _Timed:
    """Stands in for a trainer's rollout or update function: synchronises
    the device around each call and keeps its seconds, and the outputs of
    the next ``keep`` calls; passes each call's keyword arguments from
    ``extra`` (one dict a call) on."""

    def __init__(self, fn, seconds: List[float], device,
                 extra: Optional[Sequence[dict]] = None):
        self._fn, self._seconds, self._device = fn, seconds, device
        self._extra = list(extra or [])
        self.keep = 0
        self.outputs: List[Any] = []

    def __getattr__(self, name):
        return getattr(self._fn, name)

    def __call__(self, *args, **kwargs):
        if self._extra:
            kwargs.update(self._extra.pop(0))
        sync = (torch.cuda.synchronize if self._device.type == "cuda"
                else lambda *a: None)
        sync(self._device)
        start = time.perf_counter()
        out = self._fn(*args, **kwargs)
        sync(self._device)
        self._seconds.append(time.perf_counter() - start)
        if self.keep > 0:
            self.keep -= 1
            self.outputs.append(out)
        return out


def _sample_actions(fn, replay: Optional[Replay], sampled: list,
                    margins: list) -> None:
    """Makes rollout ``fn`` keep, per step, the actions it draws and each
    worker's smallest Gumbel-max margin over its branches
    (``distributions.sample``), and take ``replay``'s actions (its rows)
    where there are any: its own are drawn all the same, so its generator
    runs as an unreplayed run's does."""
    taken = [0]

    def sample_actions(logits, step):
        found: list = []
        actions, log_probs = distributions.sample_multi(
            logits, fn.generator, *fn._draw_rows, margins=found)
        sampled.append(actions)
        margins.append(torch.stack(found).min(dim=0).values)
        if replay is not None and taken[0] < replay.actions.shape[1]:
            actions = replay.actions[fn.rows, taken[0]].to(actions.device)
            log_probs = torch.stack([distributions.log_prob(lg, actions[:, i])
                                     for i, lg in enumerate(logits)], dim=-1)
        taken[0] += 1
        return actions, log_probs
    fn.sample_actions = sample_actions
    if replay is not None and replay.reset is not None:
        resets = iter(replay.reset)
        fn.reset_draws = lambda: shard_worker_tree(
            next(resets), fn.mesh, fn.config.n_workers)


def train(mesh: Optional[DataMesh], config: TrainConfig, run_id: str = "probe",
          updates: int = 1, grouped: bool = False, resume: bool = False,
          replay: Optional[Replay] = None,
          state_dict: Optional[Dict[str, torch.Tensor]] = None,
          batch_fields: Sequence[str] = (), keep_params: bool = True,
          threads: Optional[int] = None, timed_collectives: bool = False,
          device="cpu", checkpoint_after: int = 0, save_model: bool = False,
          stub_pool: int = 0) -> Dict[str, Any]:
    """Trains ``updates`` updates of ``config`` on this rank (one device
    without a mesh) and returns, on the CPU: ``results`` (each update's
    result dict), ``digests`` and, with ``keep_params``, ``params`` (the
    parameters after each update) and ``first_grads`` (the clipped
    gradients the first optimizer step takes), ``batch`` (the first update's
    ``batch_fields``, this rank's rows, with the actions the rollout drew
    itself, ``sampled``, which a ``replay`` may have replaced, and their
    ``margins``), ``launches`` (each kernel's launches in each update,
    counted from 0),
    ``seconds`` (each rollout and PPO update, the device synchronised around
    each) and ``traffic`` (the mesh's collectives). ``state_dict`` replaces
    the initial parameters; ``resume`` restores the run's checkpoint;
    ``checkpoint_after`` > 0 saves one after that many updates (the config
    needs a ``checkpoint_interval``), and ``save_model`` the ``.nn`` at the
    end; ``stub_pool`` > 0 trains on a process pool of that many
    processes over ``StubEnv`` in place of the config's env."""
    if threads:
        torch.set_num_threads(threads)
    if mesh is not None:
        mesh.traffic.clear()    # this run's collectives, from its first
    env = None
    if stub_pool:
        from ..envs.host import HostEnvBatch
        env = HostEnvBatch(make_env=StubEnv, n_procs=stub_pool)
    trainer = PPOTrainer(config, run_id=run_id, device=device,
                         enable_metrics=False, grouped=grouped, mesh=mesh,
                         env=env)
    try:
        if state_dict is not None:
            trainer.model.load_state_dict(state_dict)
        rollout_fn = trainer.rollout_fn
        sampled: List[torch.Tensor] = []
        margins: List[torch.Tensor] = []
        if not trainer.is_host_env:
            _sample_actions(rollout_fn, replay, sampled, margins)
            if replay is not None and replay.reset is not None:
                trainer.rollout_state = rollout_fn.init_state()
        if resume and not trainer.resume_from_checkpoint():
            raise RuntimeError(f"{run_id}: no checkpoint to resume from")
        if mesh is not None:
            mesh.timed = timed_collectives
        seconds = dict(rollout=[], ppo_update=[])
        trainer.rollout_fn = _Timed(rollout_fn, seconds["rollout"],
                                    trainer.device)
        trainer.rollout_fn.keep = 1
        # The trainer runs each PPO update through PPOUpdate.run.
        trainer.update_fn.run = _Timed(
            trainer.update_fn.run, seconds["ppo_update"], trainer.device,
            [dict(perms=p) for p in replay.perms]
            if replay is not None and replay.perms is not None else None)
        first_grads: List[Dict[str, torch.Tensor]] = []

        def keep_first_grads(optimizer, args, kwargs):
            first_grads.append({n: p.grad.detach().cpu().clone() for n, p
                                in trainer.model.named_parameters()})
            hook.remove()
        hook = trainer.update_fn.optimizer.register_step_pre_hook(
            keep_first_grads)
        if not keep_params:
            hook.remove()
        kernels = {name: getattr(wa, name) for name in KERNELS}
        for k in kernels.values():
            k.launches = 0
        out: Dict[str, Any] = dict(results=[], digests=[], params=[],
                                   launches=[], rank_samples=[])
        for u in range(updates):
            before = {n: k.launches for n, k in kernels.items()}
            out["results"].append(trainer.train_one_update())
            out["launches"].append({n: k.launches - before[n]
                                    for n, k in kernels.items()})
            out["rank_samples"].append(list(trainer.update_fn.rank_samples))
            if u + 1 == checkpoint_after:
                trainer._save_checkpoint()
            params = list(trainer.model.parameters())
            out["digests"].append(replica_digest(params).cpu())
            if keep_params:
                out["params"].append({n: p.detach().cpu().clone() for n, p
                                      in trainer.model.named_parameters()})
            if u == 0:
                batch = trainer.rollout_fn.outputs.pop()[1]
                out["batch"] = {f: getattr(batch, f).cpu()
                                for f in batch_fields}
                if margins:
                    T = config.worker_steps
                    out["batch"]["sampled"] = torch.stack(
                        sampled[:T], dim=1).cpu()
                    out["batch"]["margins"] = torch.stack(
                        margins[:T], dim=1).cpu()
                del batch
        trainer.rollout_fn = rollout_fn
        if save_model:
            trainer._save_model()
        out["first_grads"] = first_grads[0] if first_grads else {}
        out["seconds"] = seconds
        out["traffic"] = dict(mesh.traffic) if mesh is not None else {}
        out["rank"] = 0 if mesh is None else mesh.rank
        return out
    finally:
        trainer.close()


def train_runs(mesh: Optional[DataMesh], runs: Sequence[tuple]
               ) -> List[Dict[str, Any]]:
    """``train`` of each (config, keyword arguments) of ``runs`` in turn, on
    the same ranks."""
    return [train(mesh, config, **kwargs) for config, kwargs in runs]


def check_global_moments(process_id: int, num_processes: int,
                         coordinator_address: str, n_workers: int = 8,
                         backend: str = "gloo") -> dict:
    """One process of a multi-process check of ``multihost`` (the
    counterpart of the JAX package's two-process test): initialises the group at
    ``coordinator_address``, fills each of its workers' rows (of
    ``n_workers``, 4 values each) with the global worker index, assembles
    the global array and returns its sum and mean of squares, which every
    process must agree on, with its primacy and worker range."""
    initialize_multihost(coordinator_address, num_processes, process_id,
                         backend=backend)
    try:
        mesh = make_mesh(num_processes, "cpu", backend)
        rows = local_worker_range(n_workers)
        local = np.repeat(np.asarray(rows, np.float32)[:, None], 4, axis=1)
        x = global_worker_array(local, mesh)
        return dict(process=process_index(), primary=is_primary_host(),
                    rows=list(rows), shape=tuple(x.shape),
                    total=float(x.sum()), mean_sq=float((x * x).mean()))
    finally:
        torch.distributed.destroy_process_group()
