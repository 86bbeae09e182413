"""Training orchestration (counterpart of ``etmppo_tpu/training/trainer.py``).

``PPOTrainer(config, run_id, device)`` builds the env, the model, the rollout
and the update on ``device`` (a host env, one with ``reset_all``, gets the
host rollout of ``training/host_rollout.py``); ``train_one_update`` runs one
rollout and one PPO update; ``train_chunk(k)`` runs k of them as one fused
launch (``training/fused.py``); ``run_training`` runs ``config.updates`` of
them, saves a full checkpoint every ``checkpoint_interval`` updates and the
final model as ``<checkpoint_dir>/<run_id>.nn``; ``resume_from_checkpoint``
restores the latest checkpoint of the run.

As in the JAX package, ``run_training`` runs a device env's updates in
chunks of k = min(``updates_per_launch``, the updates left, the updates to
the next checkpoint) when ``updates_per_launch`` > 1, so checkpoints fall at
chunk boundaries, and prints each update's line after its chunk. A host env
runs update by update. The steady env-steps/s leaves out the whole first
launch and is there only when there was more than one launch. The fused
launch's route (``fused_route``: on CUDA a CUDA graph of one update, or
under a mesh CUDA graphs of its segments with the collectives between them,
replayed; the same chunks run eagerly on the CPU or under
``--debug-nans``) is printed at the first chunk.

The loss and kernel choice is this trainer's (``config.use_pallas_attention``,
``config.pallas_backward``, and the keyword ``grouped`` for the grouped
pair), not a module global: ``pallas_backward`` without
``use_pallas_attention`` warns and takes the gathered-window loss, as in the
JAX package. Each eager update's rollout and PPO update are the spans
``rollout`` and ``ppo_update`` of a profiler trace (``utils/profiling.py``);
a chunk is the span ``launch``.

The trainer's ``clock`` (``utils/profiling.PhaseClock``, on with the keyword
``phase_clock``, which ``cli.py --profile`` sets) times its set-up
(``setup.trainer``: the env, the model, the optimizer and the CUDA kernels,
which are built and loaded here rather than at their first launch), each
launch's host spans (``launch``: the warm-up, the capture and the
instantiation, the replays, the drain and the log) and, inside every update,
replayed or eager, its phases on the device: the rollout's policy, env
step, reset paths and GAE, the PPO update's preparation, losses and
optimizer steps, and the outputs. Its record is keyed by the update index.

``compute_dtype: bfloat16`` and ``obs_uint8`` train on either rollout,
except ``obs_uint8`` with a host env, which ``HostRolloutFn`` refuses. Under
``utils/runtime.set_debug_nans`` (``cli.py --debug-nans``) the model's
modules and parameters are named in the checks' errors.

``num_devices: N > 1`` is data parallelism (``parallel/mesh.py``): the
trainer is one rank of N, given as ``mesh`` (``parallel.mesh.spawn`` or
torchrun start the ranks; ``cli.py`` does either). The rank's env holds its
W/N workers and draws for all W; the parameters are broadcast from rank 0
and checked bit-identical on every rank after every update (at the end of
each fused launch, for every update of it). Only rank 0
writes: the CSV and TensorBoard, the checkpoints, the ``.nn`` and the
per-update line. The episode statistics and ``value_mean`` /
``advantage_mean`` it logs are the global ones (the dones, the episode
infos, the values and the advantages of all workers are gathered once per
update), and every rank returns them. A checkpoint is one file in the
single-device format (rank 0 gathers the rollout state), so a run resumes at
any ``num_devices`` that divides W.
"""
from __future__ import annotations

import os
import time
import warnings
from collections import deque
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..config import TrainConfig
from ..envs.factory import create_env
from ..models.actor_critic import ActorCriticModel
from ..parallel.mesh import (DataMesh, check_replicated, gather_worker_tree,
                             replicate_tree, shard_worker_tree)
from ..utils.profiling import PhaseClock
from ..utils.runtime import debug_nans_enabled, name_modules, resolve_device
from . import metrics as metrics_lib
from .checkpoint import Checkpointer, save_model
from .fused import ChunkOutputs, FusedTrainLoop, choose_route, run_update
from .host_rollout import HostRolloutFn, HostRolloutState
from .ppo import STAT_NAMES, PPOUpdate
from .rollout import RolloutFn, RolloutState


def _check_mesh(config: TrainConfig, mesh: Optional[DataMesh]
                ) -> Optional[DataMesh]:
    """The mesh a run of ``config.num_devices`` takes (None on one
    device)."""
    if config.num_devices == 1:
        if mesh is not None and mesh.size != 1:
            raise ValueError(f"num_devices: 1, but the mesh holds "
                             f"{mesh.size} ranks")
        return None
    if mesh is None:
        raise RuntimeError(
            f"num_devices: {config.num_devices} runs {config.num_devices} "
            "ranks: start them with etmppo_tpu_torch.parallel.mesh.spawn "
            "(python -m etmppo_tpu_torch.cli spawns them) or torchrun, and "
            "give each PPOTrainer its mesh")
    if mesh.size != config.num_devices:
        raise ValueError(f"num_devices: {config.num_devices}, but the mesh "
                         f"holds {mesh.size} ranks")
    return mesh


class PPOTrainer:
    def __init__(self, config: TrainConfig, run_id: str = "run",
                 device="cuda", enable_metrics: bool = True,
                 grouped: bool = False, mesh: Optional[DataMesh] = None,
                 env: Any = None, phase_clock: bool = False):
        """With ``config.num_devices > 1``, ``mesh`` is this rank's
        (``parallel/mesh.py``) and the trainer runs on ``mesh.device``.
        ``env`` replaces the config's env (``envs.factory.create_env``): a
        host env of the caller's (a process pool of its own envs), which
        the host rollout starts with this rank's workers. ``phase_clock``
        turns the trainer's clock on (``utils/profiling.PhaseClock``)."""
        mesh = _check_mesh(config, mesh)
        if config.pallas_backward and not config.use_pallas_attention:
            warnings.warn(
                "pallas_backward=True has no effect without "
                "use_pallas_attention=True; the gathered-window loss (plain "
                "PyTorch attention) is used.")
        self.config = config
        self.run_id = run_id
        self.mesh = mesh
        self.is_primary = mesh is None or mesh.is_primary
        self.device = resolve_device(device if mesh is None else mesh.device)
        self.clock = PhaseClock(phase_clock, self.device)
        with self.clock.setup_span("setup.trainer"):
            self._build(config, grouped, mesh, env)
            self.update = 0
            self.writer = (
                metrics_lib.MetricsWriter(config.summary_dir, run_id)
                if enable_metrics and self.is_primary else None)
            self.checkpointer = (Checkpointer(config.checkpoint_dir, run_id)
                                 if config.checkpoint_interval > 0 else None)
            self.episode_infos: deque = deque(maxlen=100)
            self.env_steps_per_update = config.n_workers * config.worker_steps

    def _build(self, config: TrainConfig, grouped: bool,
               mesh: Optional[DataMesh], env: Any) -> None:
        """The env, the model, the rollout, the update, the fused loop and
        the CUDA kernels, each of the first two and the update's optimizer
        and the kernels a span of the clock's set-up."""
        clock = self.clock
        with clock.setup_span("setup.env"):
            if env is not None:
                self.env = env
            elif mesh is None:
                self.env = create_env(config.environment, config.n_workers,
                                      self.device)
            else:
                rows = mesh.worker_rows(config.n_workers)
                self.env = create_env(config.environment,
                                      rows.stop - rows.start, self.device,
                                      first_worker=rows.start,
                                      draw_workers=config.n_workers)
        self.max_episode_steps = self.env.max_episode_steps
        with clock.setup_span("setup.model"):
            self.model = ActorCriticModel(
                config, self.env.observation_shape, self.env.action_branches,
                self.max_episode_steps, device=self.device,
                generator=torch.Generator().manual_seed(config.seed))
            replicate_tree(self.model.state_dict(), mesh)
            if debug_nans_enabled():
                name_modules(self.model)
        rollout_gen = torch.Generator(self.device).manual_seed(config.seed + 1)
        update_gen = torch.Generator(self.device).manual_seed(config.seed + 2)
        # Host envs (the C++ engine or the Python process pool) expose the
        # vectorized reset_all / step API instead of the batched protocol.
        self.is_host_env = hasattr(self.env, "reset_all")
        if self.is_host_env:
            try:
                self.rollout_fn = HostRolloutFn(config, self.env, self.model,
                                                rollout_gen, mesh=mesh)
            except ValueError:  # obs_uint8, or groups that do not divide W/N
                self.env.close()
                raise
        else:
            self.rollout_fn = RolloutFn(config, self.env, self.model,
                                        rollout_gen, mesh=mesh, clock=clock)
        with clock.setup_span("setup.optimizer"):
            self.update_fn = PPOUpdate(config, self.model,
                                       self.max_episode_steps, update_gen,
                                       grouped=grouped, mesh=mesh,
                                       clock=clock)
        self.rollout_state = self.rollout_fn.init_state()
        # Fusing updates needs the device rollout, as in the JAX package.
        self.fused_loop = self.fused_route = self._route_reason = None
        if not self.is_host_env:
            self.fused_route, self._route_reason = choose_route(self.device,
                                                                mesh)
            self.fused_loop = FusedTrainLoop(self.rollout_fn, self.update_fn,
                                             self.fused_route, mesh)
        with clock.setup_span("setup.kernels"):
            if self.device.type == "cuda":
                upd = self.update_fn
                if config.use_pallas_attention:
                    for kernel in (upd.kernel, upd.backward_kernel):
                        if kernel is not None:
                            kernel.load()
                for kernel in getattr(self.env, "kernels", ()):
                    kernel.load()
                clock.load()

    @staticmethod
    def _extract_episode_infos(dones: np.ndarray, infos: Dict[str, np.ndarray]
                               ) -> List[Dict[str, float]]:
        """Completed-episode statistics in (t, w) completion order."""
        ws, ts = np.nonzero(dones)
        order = np.argsort(ts * dones.shape[0] + ws, kind="stable")
        return [{k: float(v[ws[i], ts[i]]) for k, v in infos.items()}
                for i in order]

    def _record(self, outs: ChunkOutputs) -> List[Dict[str, float]]:
        """Logs a launch's updates (host side) from its packed outputs, two
        device-to-host copies (with the clock on, a third: its stamps), and
        counts them: the clock's spans ``launch.drain`` and ``launch.log``."""
        with self.clock.span("launch.drain"):
            scalars = outs.scalars.cpu().numpy()        # (k, 6 + G + 2)
            per_step = outs.per_step.cpu().numpy()      # (k, 1 + I, W, T)
            self.clock.drain(self.update)
        with self.clock.span("launch.log"):
            return self._log(outs, scalars, per_step)

    def _log(self, outs: ChunkOutputs, scalars: np.ndarray,
             per_step: np.ndarray) -> List[Dict[str, float]]:
        n, G = len(STAT_NAMES), len(outs.grad_keys)
        results = []
        for row, steps in zip(scalars, per_step):
            self.episode_infos.extend(self._extract_episode_infos(
                steps[0].astype(bool),
                {key: steps[1 + j] for j, key in enumerate(outs.info_keys)}))
            episode_result = metrics_lib.process_episode_info(
                list(self.episode_infos))
            stat_dict = {name: float(row[i])
                         for i, name in enumerate(STAT_NAMES)}
            value_mean = float(row[n + G])
            advantage_mean = float(row[n + G + 1])
            if self.writer is not None:
                logged = metrics_lib.training_scalars(
                    stat_dict, episode_result, value_mean, advantage_mean)
                for j, key in enumerate(outs.grad_keys):
                    logged["gradients/" + key] = float(row[n + j])
                self.writer.write(self.update, logged)
            result = dict(stat_dict)
            result.update(episode_result)
            result["value_mean"] = value_mean
            result["advantage_mean"] = advantage_mean
            self.update += 1
            results.append(result)
        return results

    def _schedule_values(self, k: int) -> np.ndarray:
        """(k, 3) float32: (learning rate, clip range, beta) of the next k
        updates."""
        cfg = self.config
        return np.array([[cfg.learning_rate_schedule.value(u),
                          cfg.clip_range_schedule.value(u),
                          cfg.beta_schedule.value(u)]
                         for u in range(self.update, self.update + k)],
                        np.float32)

    def train_chunk(self, k: int) -> List[Dict[str, float]]:
        """Runs k updates as one fused launch (``training/fused.py``) and
        logs them: two device-to-host copies for the chunk. The launch is
        the clock's span ``launch``."""
        if self.fused_loop is None:
            raise RuntimeError("a host env runs update by update: no fused "
                               "launch")
        if self.fused_route == "graph" and debug_nans_enabled():
            raise RuntimeError("--debug-nans was turned on after this trainer "
                               "chose the graph route; build the trainer "
                               "with the checks on")
        if self._route_reason is not None:
            if self.is_primary:
                print(f"fused launches: {self.fused_route} route "
                      f"({self._route_reason})")
            self._route_reason = None
        with self.clock.launch(self.update, k):
            self.rollout_state, outs = self.fused_loop(
                self.rollout_state, self._schedule_values(k))
            return self._record(outs)

    def train_one_update(self) -> Dict[str, float]:
        """One eager update: the body of a fused launch, run alone."""
        cfg = self.config
        self.update_fn.set_schedule(
            cfg.learning_rate_schedule.value(self.update),
            cfg.clip_range_schedule.value(self.update),
            cfg.beta_schedule.value(self.update))
        self.rollout_state, scalars, per_step, grad_keys, info_keys, digest = (
            run_update(self.rollout_fn, self.update_fn, self.mesh,
                       self.rollout_state))
        if self.mesh is not None:
            check_replicated(digest[None], self.mesh)
        return self._record(ChunkOutputs(scalars[None], per_step[None],
                                         grad_keys, info_keys))[0]

    def run_training(self, print_every: int = 1) -> Dict[str, float]:
        cfg = self.config
        start_update = self.update  # > 0 after a resume
        start = time.perf_counter()
        # The first launch carries the warm-up (and, on the graph route, the
        # capture): the steady rate leaves it out, as the JAX package's does.
        first_launch_end, first_launch_updates = 0.0, 0
        result: Dict[str, float] = {}
        while self.update < cfg.updates:
            if cfg.updates_per_launch > 1 and self.fused_loop is not None:
                k = min(cfg.updates_per_launch, cfg.updates - self.update)
                if cfg.checkpoint_interval > 0:
                    k = min(k, cfg.checkpoint_interval
                            - self.update % cfg.checkpoint_interval)
                results = self.train_chunk(k)
            else:
                results = [self.train_one_update()]
            if first_launch_updates == 0:
                self._synchronize()
                first_launch_end = time.perf_counter()
                first_launch_updates = self.update - start_update
            for i, result in enumerate(results):
                update = self.update - len(results) + i
                if (print_every and self.is_primary
                        and update % print_every == 0):
                    print(format_update(update, result))
            if (self.checkpointer is not None
                    and self.update % cfg.checkpoint_interval == 0):
                self._save_checkpoint()
        self._synchronize()
        elapsed = time.perf_counter() - start
        updates = self.update - start_update
        result["env_steps_per_second"] = (
            updates * self.env_steps_per_update / max(elapsed, 1e-9))
        if updates > first_launch_updates > 0:
            result["env_steps_per_second_steady"] = (
                (updates - first_launch_updates) * self.env_steps_per_update
                / max(time.perf_counter() - first_launch_end, 1e-9))
        self._save_model()
        return result

    def _synchronize(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # --- checkpoints ---------------------------------------------------

    def _training_state(self) -> Dict[str, Any]:
        """Everything a resumed run needs to continue bit for bit. A host
        env's own state lives in its processes or its engine and is not
        saved: a resumed host run restores the obs into freshly started
        envs, as in the JAX package, so it is not bit for bit. Under a mesh
        every rank gathers the rollout state of all workers (one device's
        layout); the generators are replicated, so rank 0's are saved."""
        rs = self.rollout_state
        if self.is_host_env:
            rollout_state = dict(obs=torch.from_numpy(rs.obs))
        else:
            rollout_state = dict(env_state=rs.env_state._asdict(), obs=rs.obs)
        rollout_state.update(episode_step=rs.episode_step, memory=rs.memory)
        rollout_state = gather_worker_tree(rollout_state, self.mesh)
        return dict(
            model=self.model.state_dict(),
            optimizer=self.update_fn.optimizer.state_dict(),
            rollout_state=rollout_state,
            rollout_generator=self.rollout_fn.generator.get_state(),
            update_generator=self.update_fn.generator.get_state(),
            update=self.update)

    def _save_checkpoint(self) -> None:
        state = self._training_state()
        if self.is_primary:
            self.checkpointer.save(self.update, state)

    def resume_from_checkpoint(self) -> bool:
        """Restores the latest checkpoint of this run if there is one; under
        a mesh every rank reads the file and keeps its workers' rows, whatever
        ``num_devices`` wrote it."""
        if self.checkpointer is None or self.checkpointer.latest_update() is None:
            return False
        state = self.checkpointer.restore()
        self.model.load_state_dict(state["model"])
        self.update_fn.load_optimizer_state(state["optimizer"])
        if self.fused_loop is not None:
            self.fused_loop.reset()     # the optimizer's state is new tensors
        rs = shard_worker_tree(state["rollout_state"], self.mesh,
                               self.config.n_workers)
        to_dev = lambda t: t.to(self.device)
        if self.is_host_env:
            self.rollout_state = HostRolloutState(
                rs["obs"].numpy(), to_dev(rs["episode_step"]),
                to_dev(rs["memory"]))
        else:
            env_state = type(self.rollout_state.env_state)(
                **{k: to_dev(v) for k, v in rs["env_state"].items()})
            self.rollout_state = RolloutState(
                env_state, to_dev(rs["obs"]), to_dev(rs["episode_step"]),
                to_dev(rs["memory"]))
        self.rollout_fn.generator.set_state(state["rollout_generator"])
        self.update_fn.generator.set_state(state["update_generator"])
        self.update = int(state["update"])
        return True

    def _save_model(self) -> None:
        if not self.is_primary:
            return
        path = os.path.join(self.config.checkpoint_dir, self.run_id + ".nn")
        save_model(path, self.model, self.config)
        print("Model saved to " + path)

    def close(self) -> None:
        if self.writer is not None:
            self.writer.close()
        if self.is_host_env:
            self.env.close()


def format_update(update: int, r: Dict[str, float]) -> str:
    """Stdout line in the reference's format."""
    line = (f"{update:4} reward={r.get('reward_mean', 0.0):.2f} "
            f"std={r.get('reward_std', 0.0):.2f} "
            f"length={r.get('length_mean', 0.0):.1f} "
            f"std={r.get('length_std', 0.0):.2f} ")
    if "success" in r:
        line += f"success={r['success']:.2f} "
    return line + (
        f"pi_loss={r['policy_loss']:3f} v_loss={r['value_loss']:3f} "
        f"entropy={r['entropy']:.3f} loss={r['loss']:3f} "
        f"value={r['value_mean']:.3f} advantage={r['advantage_mean']:.3f}")
