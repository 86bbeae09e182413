"""Checkpoint / resume (counterpart of ``etmppo_tpu/training/checkpoint.py``).

* ``save_model`` / ``read_model_config`` / ``load_model``: the final
  inference artifact, in the JAX package's on-disk format: a pickle of
  ``{"params_bytes", "config", "format": "etmppo_tpu/flax-msgpack/v1"}``,
  where ``params_bytes`` is the flax msgpack of the JAX parameter tree
  (``utils/flax_msgpack.py``, ``interop.py``). So the port loads the
  committed ``models/*.nn`` and the JAX package loads what the port writes.
  It is read with an unpickler that admits no class at all: the payload is
  builtin values only.
* ``Checkpointer``: periodic full training-state checkpoints (the JAX package
  uses Orbax), ``torch.save`` files under ``<directory>/<run_id>_ckpt/``,
  the last three kept, read back with ``weights_only=True``.
"""
from __future__ import annotations

import io
import os
import pickle
import re
from typing import Any, Dict, Optional, Tuple

import torch

from ..config import TrainConfig, config_from_dict, config_to_dict
from ..interop import flax_to_state_dict, state_dict_to_flax
from ..utils import flax_msgpack
from ..utils.runtime import resolve_device

FORMAT = "etmppo_tpu/flax-msgpack/v1"


class _BuiltinsOnly(pickle.Unpickler):
    def find_class(self, module, name):
        raise pickle.UnpicklingError(
            f"model artifacts hold builtin values only, not {module}.{name}")


def _read_payload(path: str) -> Dict[str, Any]:
    with open(path, "rb") as f:
        payload = _BuiltinsOnly(io.BytesIO(f.read())).load()
    if not isinstance(payload, dict) or payload.get("format") != FORMAT:
        raise ValueError(f"{path} is not an {FORMAT} model artifact")
    return payload


def save_model(path: str, model: torch.nn.Module, config: TrainConfig
               ) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    payload = {
        "params_bytes": flax_msgpack.packb(
            state_dict_to_flax(model.state_dict())),
        "config": config_to_dict(config),
        "format": FORMAT,
    }
    with open(path, "wb") as f:
        pickle.dump(payload, f)


def read_model_config(path: str) -> TrainConfig:
    """Reads only the config that travels with the weights."""
    return config_from_dict(_read_payload(path)["config"])


def load_model(path: str, device="cuda"
               ) -> Tuple[torch.nn.Module, TrainConfig]:
    """The saved model, rebuilt on ``device`` (the CUDA device unless the
    caller asks for another; raises without a GPU) for its config's
    environment, and that config."""
    from ..envs.factory import create_env
    from ..models.actor_critic import ActorCriticModel
    device = resolve_device(device)
    payload = _read_payload(path)
    config = config_from_dict(payload["config"])
    env = create_env(config.environment, 1, device)
    model = ActorCriticModel(config, env.observation_shape,
                             env.action_branches, env.max_episode_steps,
                             device=device)
    model.load_state_dict(
        flax_to_state_dict(flax_msgpack.unpackb(payload["params_bytes"])),
        strict=True)
    return model, config


class Checkpointer:
    """Periodic full training-state checkpoints: one ``<update>.pt`` file per
    save under ``<directory>/<run_id>_ckpt/``, the newest three kept (as the
    JAX package's Orbax manager keeps them)."""

    MAX_TO_KEEP = 3

    def __init__(self, directory: str, run_id: str):
        self.directory = os.path.abspath(
            os.path.join(directory, run_id + "_ckpt"))
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, update: int) -> str:
        return os.path.join(self.directory, f"{update}.pt")

    def updates(self):
        found = [re.fullmatch(r"(\d+)\.pt", n) for n in
                 os.listdir(self.directory)]
        return sorted(int(m.group(1)) for m in found if m)

    def save(self, update: int, state: Dict[str, Any]) -> None:
        tmp = self._path(update) + ".tmp"
        torch.save(state, tmp)
        os.replace(tmp, self._path(update))
        for old in self.updates()[:-self.MAX_TO_KEEP]:
            os.unlink(self._path(old))

    def latest_update(self) -> Optional[int]:
        updates = self.updates()
        return updates[-1] if updates else None

    def restore(self, update: Optional[int] = None) -> Dict[str, Any]:
        """The state saved at ``update`` (default: the latest), on the CPU."""
        update = self.latest_update() if update is None else update
        return torch.load(self._path(update), map_location="cpu",
                          weights_only=True)
