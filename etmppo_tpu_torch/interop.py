"""Weight bridge between the JAX package's parameter tree and this package.

``flax_to_state_dict`` takes the JAX model's parameters as nested dicts of
arrays (``{"params": {...}}`` or the inner dict; no flax needed) and returns
the ``state_dict`` of the matching ``ActorCriticModel``:

* Dense ``kernel`` (in, out) -> ``weight`` (out, in);
* Conv ``kernel`` HWIO -> ``weight`` OIHW;
* LayerNorm ``scale`` -> ``weight``, ``bias`` -> ``bias``;
* GRU gate weights (in, out), ``bg`` and a learned ``pos_embedding`` as they
  are; a gate weight in the layout of earlier versions of the JAX package,
  a bias-free Dense module ``{"kernel": (in, out)}`` (``models/poc-full.nn``),
  is the same matrix;
* ``block_i`` -> ``blocks.i``, ``policy_branch_i`` -> ``policy_branches.i``.

``lin_hidden`` needs no row permutation: the port flattens the CNN features
in HWC order, as the JAX model does.

``state_dict_to_flax`` is the inverse: a ``state_dict`` back to the JAX
package's ``{"params": {...}}`` tree of numpy arrays, keys sorted at every
level, as ``flax.serialization.to_bytes`` writes them.
"""
from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

_INDEXED = re.compile(r"^(block|policy_branch)_(\d+)$")
_GATE_WEIGHTS = {"Wr", "Wz", "Wg", "Ur", "Uz", "Ug"}
_LIST_NAMES = {"block": "blocks", "policy_branch": "policy_branches"}
_FLAX_NAMES = {v: k for k, v in _LIST_NAMES.items()}


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
            if key in _GATE_WEIGHTS and isinstance(value, Mapping):
                value = value["kernel"]
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


def _flax_leaf(name: str, value: np.ndarray):
    """Inverse of ``_convert_leaf``: a 1-D ``weight`` is a LayerNorm scale,
    a 2-D one a Dense kernel, a 4-D one a Conv kernel."""
    if name != "weight":
        return name, value
    if value.ndim == 1:
        return "scale", value
    if value.ndim == 4:
        return "kernel", value.transpose(2, 3, 1, 0)
    return "kernel", value.T


def state_dict_to_flax(state_dict: Mapping[str, torch.Tensor]) -> Dict:
    """``ActorCriticModel.state_dict()`` -> the JAX parameter tree
    ``{"params": {...}}`` with float32 numpy leaves."""
    tree: Dict = {}
    for key, tensor in state_dict.items():
        parts = key.split(".")
        path = []
        i = 0
        while i < len(parts) - 1:
            if parts[i] in _FLAX_NAMES:
                path.append(f"{_FLAX_NAMES[parts[i]]}_{parts[i + 1]}")
                i += 2
            else:
                path.append(parts[i])
                i += 1
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        name, array = _flax_leaf(
            parts[-1], tensor.detach().cpu().numpy().astype(np.float32))
        node[name] = np.ascontiguousarray(array)

    def sort(node):
        return {k: sort(v) if isinstance(v, dict) else v
                for k, v in sorted(node.items())}
    return {"params": sort(tree)}
