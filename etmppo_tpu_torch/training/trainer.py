"""Training orchestration (counterpart of ``etmppo_tpu/training/trainer.py``).

``PPOTrainer(config, run_id, device)`` builds the env, the model, the rollout
and the update on ``device``; ``train_one_update`` runs one rollout and one
PPO update; ``run_training`` runs ``config.updates`` of them, saves a full
checkpoint every ``checkpoint_interval`` updates and the final model as
``<checkpoint_dir>/<run_id>.nn``; ``resume_from_checkpoint`` restores the
latest checkpoint of the run.

What the JAX package runs as fused device programs (``training/fused.py``)
has no counterpart: PyTorch runs eagerly. The kernel choice is this
trainer's (``config.use_pallas_attention``, ``config.pallas_backward``, and
the keyword ``grouped`` for the grouped pair), not a module global.
"""
from __future__ import annotations

import os
import time
from collections import deque
from typing import Any, Dict, List

import numpy as np
import torch

from ..config import TrainConfig
from ..envs.factory import create_env
from ..models.actor_critic import ActorCriticModel
from . import metrics as metrics_lib
from .checkpoint import Checkpointer, save_model
from .ppo import STAT_NAMES, PPOUpdate
from .rollout import RolloutFn, RolloutState


def resolve_device(device) -> torch.device:
    """The device to run on; raises rather than fall back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "(--cpu) to run on the CPU")
    return device


def _check_supported(config: TrainConfig) -> None:
    if config.num_devices != 1:
        raise NotImplementedError("only num_devices: 1 is ported")
    if config.compute_dtype != "float32":
        raise NotImplementedError("only compute_dtype: float32 is ported")
    if config.obs_uint8:
        raise NotImplementedError("obs_uint8 is not ported")


class PPOTrainer:
    def __init__(self, config: TrainConfig, run_id: str = "run",
                 device="cuda", enable_metrics: bool = True,
                 grouped: bool = False):
        _check_supported(config)
        self.config = config
        self.run_id = run_id
        self.device = resolve_device(device)

        self.env = create_env(config.environment, config.n_workers,
                              self.device)
        self.max_episode_steps = self.env.max_episode_steps
        self.model = ActorCriticModel(
            config, self.env.observation_shape, self.env.action_branches,
            self.max_episode_steps, device=self.device,
            generator=torch.Generator().manual_seed(config.seed))
        rollout_gen = torch.Generator(self.device).manual_seed(config.seed + 1)
        update_gen = torch.Generator(self.device).manual_seed(config.seed + 2)
        self.rollout_fn = RolloutFn(config, self.env, self.model, rollout_gen)
        self.update_fn = PPOUpdate(config, self.model, self.max_episode_steps,
                                   update_gen, grouped=grouped)
        self.rollout_state = self.rollout_fn.init_state()

        self.update = 0
        self.writer = (metrics_lib.MetricsWriter(config.summary_dir, run_id)
                       if enable_metrics else None)
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

        self.rollout_state, batch = self.rollout_fn(self.rollout_state)
        stats, grad_info = self.update_fn(batch, lr, clip_range, beta)

        self.episode_infos.extend(self._extract_episode_infos(
            batch.dones.cpu().numpy(),
            {k: v.cpu().numpy() for k, v in batch.episode_infos.items()}))
        episode_result = metrics_lib.process_episode_info(
            list(self.episode_infos))
        stats = stats.cpu().numpy()
        stat_dict = {name: float(stats[i]) for i, name in enumerate(STAT_NAMES)}
        value_mean = float(batch.values.mean())
        advantage_mean = float(batch.advantages.mean())
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
            if print_every and (self.update - 1) % print_every == 0:
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
        """Everything a resumed run needs to continue bit for bit."""
        rs = self.rollout_state
        return dict(
            model=self.model.state_dict(),
            optimizer=self.update_fn.optimizer.state_dict(),
            rollout_state=dict(env_state=rs.env_state._asdict(), obs=rs.obs,
                               episode_step=rs.episode_step,
                               memory=rs.memory),
            rollout_generator=self.rollout_fn.generator.get_state(),
            update_generator=self.update_fn.generator.get_state(),
            update=self.update)

    def _save_checkpoint(self) -> None:
        self.checkpointer.save(self.update, self._training_state())

    def resume_from_checkpoint(self) -> bool:
        """Restores the latest checkpoint of this run if there is one."""
        if self.checkpointer is None or self.checkpointer.latest_update() is None:
            return False
        state = self.checkpointer.restore()
        self.model.load_state_dict(state["model"])
        self.update_fn.optimizer.load_state_dict(state["optimizer"])
        rs = state["rollout_state"]
        to_dev = lambda t: t.to(self.device)
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
        path = os.path.join(self.config.checkpoint_dir, self.run_id + ".nn")
        save_model(path, self.model, self.config)
        print("Model saved to " + path)

    def close(self) -> None:
        if self.writer is not None:
            self.writer.close()


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
