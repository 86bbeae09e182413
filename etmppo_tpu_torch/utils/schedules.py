"""Polynomial hyperparameter decay, stepped per update
(counterpart of ``etmppo_tpu/utils/schedules.py``)."""
from __future__ import annotations


def polynomial_decay(initial: float, final: float, max_decay_steps: int,
                     power: float, current_step: int) -> float:
    """power=1.0 gives linear decay; past max_decay_steps returns final."""
    if current_step > max_decay_steps or initial == final:
        return final
    return (initial - final) * ((1 - current_step / max_decay_steps) ** power) + final
