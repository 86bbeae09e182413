"""Training orchestration (counterpart of ``etmppo_tpu/training/trainer.py``).

``PPOTrainer(config, run_id, device)`` builds the env, the model, the rollout
and the update on ``device`` (a host env, one with ``reset_all``, gets the
host rollout of ``training/host_rollout.py``); ``train_one_update`` runs one
rollout and one PPO update; ``run_training`` runs ``config.updates`` of
them, saves a full checkpoint every ``checkpoint_interval`` updates and the
final model as ``<checkpoint_dir>/<run_id>.nn``; ``resume_from_checkpoint``
restores the latest checkpoint of the run.

What the JAX package runs as fused device programs (``training/fused.py``)
has no counterpart: PyTorch runs eagerly. The loss and kernel choice is this
trainer's (``config.use_pallas_attention``, ``config.pallas_backward``, and
the keyword ``grouped`` for the grouped pair), not a module global:
``pallas_backward`` without ``use_pallas_attention`` warns and takes the
gathered-window loss, as in the JAX package. Each update's rollout and PPO
update are the spans ``rollout`` and ``ppo_update`` of a profiler trace
(``utils/profiling.py``).

``compute_dtype: bfloat16`` and ``obs_uint8`` train on either rollout,
except ``obs_uint8`` with a host env, which ``HostRolloutFn`` refuses. Under
``utils/runtime.set_debug_nans`` (``cli.py --debug-nans``) the model's
modules and parameters are named in the checks' errors.

``num_devices: N > 1`` is data parallelism (``parallel/mesh.py``): the
trainer is one rank of N, given as ``mesh`` (``parallel.mesh.spawn`` or
torchrun start the ranks; ``cli.py`` does either). The rank's env holds its
W/N workers and draws for all W; the parameters are broadcast from rank 0
and checked bit-identical on every rank after every update. Only rank 0
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
from ..utils.profiling import annotate
from ..utils.runtime import (debug_nans_enabled, name_modules, nan_errors,
                             resolve_device)
from . import metrics as metrics_lib
from .checkpoint import Checkpointer, save_model
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
                 env: Any = None):
        """With ``config.num_devices > 1``, ``mesh`` is this rank's
        (``parallel/mesh.py``) and the trainer runs on ``mesh.device``.
        ``env`` replaces the config's env (``envs.factory.create_env``): a
        host env of the caller's (a process pool of its own envs), which
        the host rollout starts with this rank's workers."""
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

        if env is not None:
            self.env = env
        elif mesh is None:
            self.env = create_env(config.environment, config.n_workers,
                                  self.device)
        else:
            rows = mesh.worker_rows(config.n_workers)
            self.env = create_env(config.environment, rows.stop - rows.start,
                                  self.device, first_worker=rows.start,
                                  draw_workers=config.n_workers)
        self.max_episode_steps = self.env.max_episode_steps
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
                                        rollout_gen, mesh=mesh)
        self.update_fn = PPOUpdate(config, self.model, self.max_episode_steps,
                                   update_gen, grouped=grouped, mesh=mesh)
        self.rollout_state = self.rollout_fn.init_state()

        self.update = 0
        self.writer = (metrics_lib.MetricsWriter(config.summary_dir, run_id)
                       if enable_metrics and self.is_primary else None)
        self.checkpointer = (Checkpointer(config.checkpoint_dir, run_id)
                             if config.checkpoint_interval > 0 else None)
        self.episode_infos: deque = deque(maxlen=100)
        self.env_steps_per_update = config.n_workers * config.worker_steps

    @staticmethod
    def _extract_episode_infos(dones: np.ndarray, infos: Dict[str, np.ndarray]
                               ) -> List[Dict[str, float]]:
        """Completed-episode statistics in (t, w) completion order."""
        ws, ts = np.nonzero(dones)
        order = np.argsort(ts * dones.shape[0] + ws, kind="stable")
        return [{k: float(v[ws[i], ts[i]]) for k, v in infos.items()}
                for i in order]

    def train_one_update(self) -> Dict[str, float]:
        cfg = self.config
        lr = cfg.learning_rate_schedule.value(self.update)
        beta = cfg.beta_schedule.value(self.update)
        clip_range = cfg.clip_range_schedule.value(self.update)

        with annotate("rollout"):
            self.rollout_state, batch = self.rollout_fn(self.rollout_state)
        with annotate("ppo_update"), nan_errors():
            stats, grad_info = self.update_fn(batch, lr, clip_range, beta)
        if self.mesh is not None:
            check_replicated(list(self.model.parameters()), self.mesh,
                             f"after update {self.update}")

        dones, infos, values, advantages = self._global_rows(batch)
        self.episode_infos.extend(self._extract_episode_infos(
            dones.cpu().numpy(), {k: v.cpu().numpy() for k, v in infos.items()}))
        episode_result = metrics_lib.process_episode_info(
            list(self.episode_infos))
        stats = stats.cpu().numpy()
        stat_dict = {name: float(stats[i]) for i, name in enumerate(STAT_NAMES)}
        value_mean = float(values.mean())
        advantage_mean = float(advantages.mean())
        if self.writer is not None:
            scalars = metrics_lib.training_scalars(
                stat_dict, episode_result, value_mean, advantage_mean)
            for key, value in grad_info.items():
                scalars["gradients/" + key] = float(value)
            self.writer.write(self.update, scalars)

        result = dict(stat_dict)
        result.update(episode_result)
        result["value_mean"] = value_mean
        result["advantage_mean"] = advantage_mean
        self.update += 1
        return result

    def _global_rows(self, batch):
        """The dones, episode infos, values and advantages of all workers:
        the batch's own on one device; under a mesh, every rank's rows
        gathered in one call (the infos' keys are the union of the ranks'
        keys: a host env's infos may carry keys only some ranks saw)."""
        if self.mesh is None:
            return (batch.dones, batch.episode_infos, batch.values,
                    batch.advantages)
        keys = sorted(set().union(*self.mesh.all_gather_object(
            sorted(batch.episode_infos))))
        zeros = torch.zeros_like(batch.values)
        rows = torch.stack([batch.dones.float(), batch.values,
                            batch.advantages] + [
            batch.episode_infos.get(k, zeros).float() for k in keys], dim=1)
        rows = self.mesh.gather_workers(rows, "episode rows")
        return (rows[:, 0].bool(), {k: rows[:, 3 + i]
                                    for i, k in enumerate(keys)},
                rows[:, 1], rows[:, 2])

    def run_training(self, print_every: int = 1) -> Dict[str, float]:
        cfg = self.config
        start_update = self.update  # > 0 after a resume
        start = time.perf_counter()
        first_update_end = None
        result: Dict[str, float] = {}
        while self.update < cfg.updates:
            result = self.train_one_update()
            if first_update_end is None:
                self._synchronize()
                first_update_end = time.perf_counter()
            if (print_every and self.is_primary
                    and (self.update - 1) % print_every == 0):
                print(format_update(self.update - 1, result))
            if (self.checkpointer is not None
                    and self.update % cfg.checkpoint_interval == 0):
                self._save_checkpoint()
        self._synchronize()
        elapsed = time.perf_counter() - start
        updates = self.update - start_update
        result["env_steps_per_second"] = (
            updates * self.env_steps_per_update / max(elapsed, 1e-9))
        if updates > 1:
            # Without the first update, which carries the warm-up.
            result["env_steps_per_second_steady"] = (
                (updates - 1) * self.env_steps_per_update
                / max(time.perf_counter() - first_update_end, 1e-9))
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
        self.update_fn.optimizer.load_state_dict(state["optimizer"])
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
