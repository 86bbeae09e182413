"""Training orchestration (counterpart of ``etmppo_tpu/training/trainer.py``).

``PPOTrainer(config, run_id, device)`` builds the env, the model, the rollout
and the update on ``device``; ``train_one_update`` runs one rollout and one
PPO update; ``run_training`` runs ``config.updates`` of them.

What the JAX package runs as fused device programs (``training/fused.py``)
has no counterpart: PyTorch runs eagerly. The kernel choice is this
trainer's (``config.use_pallas_attention``), not a module global.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Dict, List

import numpy as np
import torch

from ..config import TrainConfig
from ..envs.factory import create_env
from ..models.actor_critic import ActorCriticModel
from . import metrics as metrics_lib
from .ppo import STAT_NAMES, PPOUpdate
from .rollout import RolloutFn


def resolve_device(device) -> torch.device:
    """The device to run on; raises rather than fall back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "(--cpu) to run on the CPU")
    return device


def _check_supported(config: TrainConfig) -> None:
    if config.checkpoint_interval > 0:
        raise NotImplementedError("checkpointing is not ported yet "
                                  "(checkpoint_interval must be 0)")
    if config.num_devices != 1:
        raise NotImplementedError("only num_devices: 1 is ported")
    if config.compute_dtype != "float32":
        raise NotImplementedError("only compute_dtype: float32 is ported")
    if config.obs_uint8:
        raise NotImplementedError("obs_uint8 is not ported")


class PPOTrainer:
    def __init__(self, config: TrainConfig, run_id: str = "run",
                 device="cuda", enable_metrics: bool = True):
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
                                   update_gen)
        self.rollout_state = self.rollout_fn.init_state()

        self.update = 0
        self.writer = (metrics_lib.MetricsWriter(config.summary_dir, run_id)
                       if enable_metrics else None)
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
        start_update = self.update
        start = time.perf_counter()
        result: Dict[str, float] = {}
        while self.update < self.config.updates:
            result = self.train_one_update()
            if print_every and (self.update - 1) % print_every == 0:
                print(format_update(self.update - 1, result))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        elapsed = time.perf_counter() - start
        steps = (self.update - start_update) * self.env_steps_per_update
        result["env_steps_per_second"] = steps / max(elapsed, 1e-9)
        return result

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
