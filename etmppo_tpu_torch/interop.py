"""Weight bridge from the JAX package's parameter tree to this package.

``flax_to_state_dict`` takes the JAX model's parameters as nested dicts of
arrays (``{"params": {...}}`` or the inner dict; no flax needed) and returns
the ``state_dict`` of the matching ``ActorCriticModel``:

* Dense ``kernel`` (in, out) -> ``weight`` (out, in);
* Conv ``kernel`` HWIO -> ``weight`` OIHW;
* LayerNorm ``scale`` -> ``weight``, ``bias`` -> ``bias``;
* GRU gate weights (in, out), ``bg`` and a learned ``pos_embedding`` as they
  are;
* ``block_i`` -> ``blocks.i``, ``policy_branch_i`` -> ``policy_branches.i``.

``lin_hidden`` needs no row permutation: the port flattens the CNN features
in HWC order, as the JAX model does.
"""
from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

_INDEXED = re.compile(r"^(block|policy_branch)_(\d+)$")
_LIST_NAMES = {"block": "blocks", "policy_branch": "policy_branches"}


def _module_name(part: str) -> str:
    m = _INDEXED.match(part)
    return f"{_LIST_NAMES[m.group(1)]}.{m.group(2)}" if m else part


def _convert_leaf(name: str, value: np.ndarray):
    if name == "kernel":
        if value.ndim == 4:
            return "weight", value.transpose(3, 2, 0, 1)
        return "weight", value.T
    if name == "scale":
        return "weight", value
    return name, value


def flax_to_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX parameter tree -> ``ActorCriticModel.state_dict()`` layout."""
    if "params" in params:
        params = params["params"]
    out: Dict[str, torch.Tensor] = {}

    def visit(tree: Mapping, prefix: str):
        for key, value in tree.items():
            if isinstance(value, Mapping):
                visit(value, prefix + _module_name(key) + ".")
            else:
                name, array = _convert_leaf(key, np.asarray(value))
                out[prefix + name] = torch.tensor(array, dtype=torch.float32)

    visit(params, "")
    return out


def load_flax_params(model: torch.nn.Module, params: Mapping) -> None:
    """Copies a JAX parameter tree into ``model`` (every parameter must be
    matched)."""
    model.load_state_dict(flax_to_state_dict(params), strict=True)
