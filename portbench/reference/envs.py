"""The reference envs, found by type: the env of a configuration's
``environment`` type is a frozen plain copy in a file of its own,
``env_<slug>.py`` beside this one, where the slug is the type in lower case
with every run of other characters than letters and digits written as
``_`` (``MysteryPath-Grid``: ``env_mysterypath_grid.py``). Each such file
exposes ``make(env_cfg, n_workers, device)``, so adding an env is adding
its file.

Each env follows the environment as published and draws its resets as the
benchmarked program documents its draws: each reset takes its values from
a generator in a fixed order, so that the reference, seeded alike, steps
the same episodes. Each imports nothing of the port.
"""
from __future__ import annotations

import importlib
import re
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent


def where_rows(mask, new, old):
    """Field-wise ``where(mask[w], new, old)`` over a state's worker axis."""
    return type(old)(*(torch.where(mask.reshape((-1,) + (1,) * (a.dim() - 1)),
                                   a, b) for a, b in zip(new, old)))


def env_file(env_type: str) -> Path:
    """The file that holds the reference env of ``env_type``."""
    slug = re.sub(r"[^a-z0-9]+", "_", env_type.lower())
    return HERE / f"env_{slug}.py"


def make_env(env_cfg: dict, n_workers: int, device):
    """The reference env of a configuration's ``environment``."""
    path = env_file(env_cfg["type"])
    if not path.is_file():
        raise NotImplementedError(
            f"no reference env for {env_cfg['type']!r}: no file {path.name} "
            f"in {HERE}")
    module = importlib.import_module(f"{__package__}.{path.stem}")
    return module.make(env_cfg, n_workers, device)
