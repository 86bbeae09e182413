"""Typed training configuration (counterpart of ``etmppo_tpu/config.py``).

The YAML layout is the reference's, so the JAX package's config files load
unchanged:

    environment: {type, name, reset_params}
    gamma, lamda, updates, epochs, n_workers, worker_steps, n_mini_batch,
    value_loss_coefficient, hidden_layer_size, max_grad_norm
    transformer: {num_blocks, embed_dim, num_heads, memory_length,
                  positional_encoding, layer_norm, gtrxl, gtrxl_bias}
    {learning_rate,beta,clip_range}_schedule: {initial, final, power, max_decay_steps}

``use_pallas_attention`` keeps its name for compatibility with those files; in
this package it selects the CUDA window-attention kernel for the PPO loss.
PyYAML is imported only by ``load_config``: nothing else reads a YAML file.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict

# The shipped configurations as dicts, exactly as their YAML files say, so
# that a machine without PyYAML can build them:
# the MiniGrid-Memory S9 flagship (etmppo_tpu/configs/minigrid.yaml) ...
MINIGRID_FLAGSHIP: Dict[str, Any] = {
    "environment": {"type": "Minigrid", "name": "MiniGrid-MemoryS9-v0"},
    "gamma": 0.995,
    "lamda": 0.95,
    "updates": 100,
    "epochs": 5,
    "n_workers": 16,
    "worker_steps": 512,
    "n_mini_batch": 8,
    "value_loss_coefficient": 0.5,
    "hidden_layer_size": 384,
    "max_grad_norm": 0.5,
    "transformer": {
        "num_blocks": 3,
        "embed_dim": 384,
        "num_heads": 4,
        "memory_length": 64,
        "positional_encoding": "relative",
        "layer_norm": "post",
        "gtrxl": False,
        "gtrxl_bias": 0.0,
    },
    "learning_rate_schedule": {"initial": 3.5e-4, "final": 1.0e-4, "power": 1.0,
                               "max_decay_steps": 250},
    "beta_schedule": {"initial": 0.001, "final": 0.001, "power": 1.0,
                      "max_decay_steps": 10000},
    "clip_range_schedule": {"initial": 0.1, "final": 0.1, "power": 1.0,
                            "max_decay_steps": 10000},
    "seed": 0,
    "updates_per_launch": 4,
    "use_pallas_attention": True,
    "pallas_backward": True,
}

# ... and the MemoryGym Mystery Path Grid long-memory flagship
# (etmppo_tpu/configs/mystery_path_grid.yaml).
MYSTERY_PATH_GRID: Dict[str, Any] = {
    "environment": {
        "type": "MysteryPath-Grid",
        "name": "MysteryPath-Grid-v0",
        "reset_params": {
            "start-seed": 0,
            "num-seeds": 100000,
            "cardinal_origin_choice": [0, 1, 2, 3],
            "show_origin": False,
            "show_goal": False,
            "visual_feedback": True,
            "reward_goal": 1.0,
            "reward_fall_off": 0.0,
            "reward_path_progress": 0.0,
        },
    },
    "gamma": 0.995,
    "lamda": 0.95,
    "updates": 5000,
    "epochs": 3,
    "n_workers": 32,
    "worker_steps": 512,
    "n_mini_batch": 8,
    "value_loss_coefficient": 0.5,
    "hidden_layer_size": 256,
    "max_grad_norm": 0.25,
    "transformer": {
        "num_blocks": 2,
        "embed_dim": 256,
        "num_heads": 4,
        "memory_length": 96,
        "positional_encoding": "",
        "layer_norm": "pre",
        "gtrxl": False,
        "gtrxl_bias": 0.0,
    },
    "learning_rate_schedule": {"initial": 2.75e-4, "final": 1.0e-5,
                               "power": 1.0, "max_decay_steps": 10000},
    "beta_schedule": {"initial": 0.001, "final": 0.000001, "power": 1.0,
                      "max_decay_steps": 10000},
    "clip_range_schedule": {"initial": 0.1, "final": 0.1, "power": 1.0,
                            "max_decay_steps": 10000},
    "seed": 0,
    "updates_per_launch": 4,
    "checkpoint_interval": 100,
    "use_pallas_attention": True,
    "pallas_backward": True,
}


# ... and the MemoryGym Mortar Mayhem Grid long-memory flagship
# (etmppo_tpu/configs/mortar_mayhem_grid.yaml).
MORTAR_MAYHEM_GRID: Dict[str, Any] = {
    "environment": {
        "type": "MortarMayhem-Grid",
        "name": "MortarMayhem-Grid-v0",
        "reset_params": {
            "start-seed": 0,
            "num-seeds": 10000,
            "arena_size": 5,
            "allowed_commands": 5,
            "command_count": [10],
            "explosion_duration": [2],
            "explosion_delay": [6],
            "reward_command_failure": 0.0,
            "reward_command_success": 0.1,
            "reward_episode_success": 0.0,
        },
    },
    "gamma": 0.995,
    "lamda": 0.95,
    "updates": 3000,
    "epochs": 3,
    "n_workers": 32,
    "worker_steps": 512,
    "n_mini_batch": 8,
    "value_loss_coefficient": 0.5,
    "hidden_layer_size": 384,
    "max_grad_norm": 0.25,
    "transformer": {
        "num_blocks": 3,
        "embed_dim": 384,
        "num_heads": 4,
        "memory_length": 118,
        "positional_encoding": "relative",
        "layer_norm": "pre",
        "gtrxl": False,
        "gtrxl_bias": 0.0,
    },
    "learning_rate_schedule": {"initial": 2.5e-4, "final": 1.0e-5,
                               "power": 1.0, "max_decay_steps": 10000},
    "beta_schedule": {"initial": 0.0001, "final": 0.000001, "power": 1.0,
                      "max_decay_steps": 10000},
    "clip_range_schedule": {"initial": 0.1, "final": 0.1, "power": 1.0,
                            "max_decay_steps": 10000},
    "seed": 0,
    "updates_per_launch": 4,
    "checkpoint_interval": 100,
    "use_pallas_attention": True,
    "pallas_backward": True,
}


@dataclass(frozen=True)
class ScheduleConfig:
    """Polynomial decay schedule, stepped per update."""
    initial: float
    final: float
    power: float = 1.0
    max_decay_steps: int = 1

    def value(self, step: int) -> float:
        if step > self.max_decay_steps or self.initial == self.final:
            return self.final
        return (self.initial - self.final) * (
            (1.0 - step / self.max_decay_steps) ** self.power
        ) + self.final


@dataclass(frozen=True)
class TransformerConfig:
    """TrXL / GTrXL architecture."""
    num_blocks: int = 3
    embed_dim: int = 384
    num_heads: int = 4
    memory_length: int = 64
    positional_encoding: str = ""   # "" | "relative" | "learned"
    layer_norm: str = ""            # "" | "pre" | "post"
    gtrxl: bool = False
    gtrxl_bias: float = 0.0

    def __post_init__(self):
        if self.embed_dim % self.num_heads != 0:
            raise ValueError(
                f"embed_dim ({self.embed_dim}) must be divisible by num_heads "
                f"({self.num_heads})")
        if self.positional_encoding not in ("", "relative", "learned"):
            raise ValueError(
                f"positional_encoding must be '', 'relative' or 'learned', got "
                f"{self.positional_encoding!r}")
        if self.layer_norm not in ("", "pre", "post"):
            raise ValueError(
                f"layer_norm must be '', 'pre' or 'post', got {self.layer_norm!r}")


@dataclass(frozen=True)
class EnvConfig:
    type: str = "PocMemoryEnv"
    name: str = ""
    reset_params: Dict[str, Any] = field(default_factory=dict)


@dataclass(frozen=True)
class TrainConfig:
    environment: EnvConfig = field(default_factory=EnvConfig)
    gamma: float = 0.99
    lamda: float = 0.95
    updates: int = 200
    epochs: int = 4
    n_workers: int = 16
    worker_steps: int = 128
    n_mini_batch: int = 8
    value_loss_coefficient: float = 0.1
    hidden_layer_size: int = 64
    max_grad_norm: float = 0.5
    transformer: TransformerConfig = field(default_factory=TransformerConfig)
    learning_rate_schedule: ScheduleConfig = field(
        default_factory=lambda: ScheduleConfig(3.0e-4, 3.0e-4, 1.0, 200))
    beta_schedule: ScheduleConfig = field(
        default_factory=lambda: ScheduleConfig(0.001, 0.0001, 1.0, 200))
    clip_range_schedule: ScheduleConfig = field(
        default_factory=lambda: ScheduleConfig(0.2, 0.2, 1.0, 200))
    seed: int = 0
    # Only "float32" is supported by this package's trainer.
    compute_dtype: str = "float32"
    # Use the CUDA window-attention kernel in the PPO loss.
    use_pallas_attention: bool = False
    # The CUDA backward kernel for the window attention (else the plain
    # PyTorch VJP runs on the card).
    pallas_backward: bool = False
    # Save a full training-state checkpoint every this many updates (0: never).
    checkpoint_interval: int = 0
    checkpoint_dir: str = "./models"
    summary_dir: str = "./summaries"
    num_devices: int = 1
    # Read by the JAX package (fused device programs, host env pipelining);
    # kept so its config files load, unused here: PyTorch runs eagerly.
    updates_per_launch: int = 8
    host_pipeline_groups: int = 2
    obs_uint8: bool = False

    def __post_init__(self):
        if (self.n_workers * self.worker_steps) % self.n_mini_batch != 0:
            raise ValueError(
                "n_workers * worker_steps must be divisible by n_mini_batch")
        if self.num_devices > 1 and self.n_workers % self.num_devices != 0:
            raise ValueError("n_workers must be divisible by num_devices")

    @property
    def batch_size(self) -> int:
        return self.n_workers * self.worker_steps

    @property
    def mini_batch_size(self) -> int:
        return self.batch_size // self.n_mini_batch


def _schedule_from_dict(d: Dict[str, Any]) -> ScheduleConfig:
    return ScheduleConfig(
        initial=float(d["initial"]), final=float(d["final"]),
        power=float(d.get("power", 1.0)),
        max_decay_steps=int(d.get("max_decay_steps", 1)))


def config_from_dict(raw: Dict[str, Any]) -> TrainConfig:
    """Builds a TrainConfig from a (possibly reference-format) nested dict."""
    raw = dict(raw)
    env_raw = dict(raw.get("environment", {}))
    env = EnvConfig(
        type=env_raw.get("type", "PocMemoryEnv"),
        name=env_raw.get("name", ""),
        reset_params=dict(env_raw.get("reset_params", {}) or {}))
    trx_raw = dict(raw.get("transformer", {}))
    trx = TransformerConfig(
        num_blocks=int(trx_raw.get("num_blocks", 3)),
        embed_dim=int(trx_raw.get("embed_dim", 384)),
        num_heads=int(trx_raw.get("num_heads", 4)),
        memory_length=int(trx_raw.get("memory_length", 64)),
        positional_encoding=trx_raw.get("positional_encoding", "") or "",
        layer_norm=trx_raw.get("layer_norm", "") or "",
        gtrxl=bool(trx_raw.get("gtrxl", False)),
        gtrxl_bias=float(trx_raw.get("gtrxl_bias", 0.0)))

    kwargs: Dict[str, Any] = dict(environment=env, transformer=trx)
    for name in ("gamma", "lamda", "value_loss_coefficient", "max_grad_norm"):
        if name in raw:
            kwargs[name] = float(raw[name])
    for name in ("updates", "epochs", "n_workers", "worker_steps", "n_mini_batch",
                 "hidden_layer_size", "seed", "checkpoint_interval", "num_devices",
                 "updates_per_launch", "host_pipeline_groups"):
        if name in raw:
            kwargs[name] = int(raw[name])
    for name in ("compute_dtype", "checkpoint_dir", "summary_dir"):
        if name in raw:
            kwargs[name] = str(raw[name])
    for name in ("use_pallas_attention", "pallas_backward", "obs_uint8"):
        if name in raw:
            kwargs[name] = bool(raw[name])
    for name in ("learning_rate_schedule", "beta_schedule", "clip_range_schedule"):
        if name in raw:
            kwargs[name] = _schedule_from_dict(raw[name])
    return TrainConfig(**kwargs)


def load_config(path: str) -> TrainConfig:
    """Loads a YAML config file in the reference's format."""
    import yaml
    with open(path, "r") as f:
        raw = yaml.safe_load(f)
    return config_from_dict(raw)


def config_to_dict(config: TrainConfig) -> Dict[str, Any]:
    """The config as a nested dict of plain values."""
    return dataclasses.asdict(config)
