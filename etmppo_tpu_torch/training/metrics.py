"""Metrics (counterpart of ``etmppo_tpu/training/metrics.py``).

The scalar groups keep the reference's names (``episode/*``, ``losses/*``,
``training/*``, ``other/*``, ``gradients/*``). They go to a CSV file and,
where ``torch.utils.tensorboard`` imports (it needs the ``tensorboard``
package), to TensorBoard event files beside it, as the JAX package's writer
does.
"""
from __future__ import annotations

import csv
import os
import time
from typing import Dict, List, Optional

import numpy as np


def process_episode_info(episode_info: List[dict]) -> Dict[str, float]:
    """Mean/std per info key over recent episodes."""
    result: Dict[str, float] = {}
    if len(episode_info) > 0:
        for key in episode_info[0].keys():
            if key == "success":
                values = [info[key] for info in episode_info]
                result["success_percent"] = float(np.sum(values) / len(values))
                result["success"] = float(np.mean(values))
            result[key + "_mean"] = float(np.mean([i[key] for i in episode_info]))
            result[key + "_std"] = float(np.std([i[key] for i in episode_info]))
    return result


class MetricsWriter:
    """Appends one CSV row per update under ``summary_dir/run_id/<time>/``
    and, with ``use_tensorboard`` where TensorBoard imports, writes each
    scalar to TensorBoard there too."""

    def __init__(self, summary_dir: str, run_id: str,
                 use_tensorboard: bool = True):
        timestamp = time.strftime("%Y%m%d-%H%M%S")
        self.log_dir = os.path.join(summary_dir, run_id, timestamp)
        os.makedirs(self.log_dir, exist_ok=True)
        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError as e:
                print(f"TensorBoard is off ({e}); metrics go to the CSV only")
            else:
                self._tb = SummaryWriter(self.log_dir)
        self.csv_path = os.path.join(self.log_dir, "metrics.csv")
        self._csv_file = open(self.csv_path, "w", newline="")
        self._csv: Optional[csv.DictWriter] = None

    def write(self, update: int, scalars: Dict[str, float]) -> None:
        if self._tb is not None:
            for key, value in scalars.items():
                self._tb.add_scalar(key, value, update)
        row = {"update": update, **scalars}
        if self._csv is None:
            self._csv = csv.DictWriter(self._csv_file, fieldnames=list(row),
                                       extrasaction="ignore")
            self._csv.writeheader()
        self._csv.writerow(row)
        self._csv_file.flush()

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
        self._csv_file.close()


def training_scalars(stats: Dict[str, float], episode_result: Dict[str, float],
                     value_mean: float, advantage_mean: float) -> Dict[str, float]:
    """Scalar dict in the reference's naming scheme."""
    scalars = {}
    for key, value in episode_result.items():
        if "std" not in key:
            scalars["episode/" + key] = value
    scalars["losses/loss"] = stats["loss"]
    scalars["losses/policy_loss"] = stats["policy_loss"]
    scalars["losses/value_loss"] = stats["value_loss"]
    scalars["losses/entropy"] = stats["entropy"]
    scalars["training/value_mean"] = value_mean
    scalars["training/advantage_mean"] = advantage_mean
    scalars["other/clip_fraction"] = stats["clip_fraction"]
    scalars["other/kl"] = stats["kl"]
    return scalars
