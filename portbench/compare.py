"""The comparison that decides ``correct``: the numbers compared, each held
to its limit in ``limits/<cell>.json``, and readings printed beside them
that no limit holds.

Training (the first ``follow_updates`` updates of the program's first
launch: the eager warm-up update, then replays of its CUDA graph). The
reference takes the program's actions, and from update 2 on the program's
parameters and AdamW state at the update's start (its own state, which
AdamW's amplification of rounding would otherwise carry apart):

* ``dones_mismatch``: the (worker, step) pairs whose episode end differs, in
  all followed updates: the envs' steps and resets, exact.
* ``value_gap``: the widest gap of a rollout value over the root mean square
  of the reference's values, in any followed update: the policy forward
  through the K/V cache. ``adv_gap`` the same of the advantages (GAE).
* ``logp_gap``: the widest gap of an action's log-probability.
* ``action_gap``: the widest gap by which the program's action's
  Gumbel-perturbed logit lies below the reference's best (0 where they
  pick the same): the sampling.
* ``loss_gap.s1``: the loss of the first optimizer step (the first
  minibatch), over the sum of its terms' magnitudes in the reference (the
  loss itself can cancel to near 0: at step 1 the surrogate is the
  normalised advantages' mean, 0, and the value term can meet the entropy
  bonus). Steps 2 and 3's are readings: AdamW's first steps move every
  element by the learning rate whatever its gradient's size, so rounding
  already separates them from seed to seed; their change is held by
  ``dparam_gap``.
* ``loss_gap.replay_s1``: the same of the first minibatch's loss of each
  followed update after the first (on the card, replays of the captured
  graph), from the program's state at the update's start, before the
  update's first step: the replays' PPO loss on their own batch, minibatch
  indices and advantages, which ``loss_gap.s1`` (the eager warm-up update)
  does not see.
* ``grad1_gap``: the first gradient, as AdamW holds it after one step, by
  its worst leaf: the gap of the norms over the larger of the reference
  leaf's norm and the median leaf's.
* ``dparam_gap``: the parameters' change over the first ``follow_steps``
  steps, by the median leaf's gap (the worst leaf's is a reading: in a
  bias of a few hundred elements, one element whose gradient sits at
  AdamW's epsilon in one run and not the other moves that leaf's norm by a
  few 1e-3), leaving out leaves whose first gradient in the reference is
  under a thousandth of the median leaf's (they move under AdamW by
  round-off alone).
* ``dparam_update_gap``: the parameters' change over each followed update
  from the same start, by the median leaf's gap (AdamW's amplified
  rounding moves single leaves): the replayed updates' PPO step.

Serving (a sample of the finished episodes, replayed by the reference on
the program's observations):

* ``value_gap``: the widest gap of a served value over the root mean square
  of the reference's values.
* ``action_gap``: the widest gap by which a served action's
  Gumbel-perturbed logit (the uniforms of its draw) lies below the
  reference's best one.
"""
from __future__ import annotations

import math
from typing import Dict, List

import torch

STATS = ("policy_loss", "value_loss", "loss", "entropy", "kl",
         "clip_fraction")
SMALL_LEAF = 1e-3


def _rms(x: torch.Tensor) -> float:
    return float(x.double().square().mean().sqrt())


def _gap(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max())


def median(values) -> float:
    values = sorted(values)
    return values[len(values) // 2]


def leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor]
              ) -> Dict[str, float]:
    """Per leaf, the gap between the program's and the reference's norm,
    over the larger of the reference leaf's norm and the median leaf's."""
    norms = {n: float(ref[n].double().norm()) for n in ref}
    middle = median(norms.values())
    return {n: abs(float(prog[n].double().norm()) - norms[n])
            / max(norms[n], middle, 1e-30) for n in ref}


def loss_scale(stats: dict, cfg: dict) -> float:
    """The sum of the magnitudes of a loss's terms (the entropy's at the
    initial beta): the scale of a loss gap."""
    beta = cfg["beta_schedule"]["initial"]
    return (abs(stats["policy_loss"])
            + cfg["value_loss_coefficient"] * abs(stats["value_loss"])
            + beta * abs(stats["entropy"]))


def training(record: dict, followed: List[dict], ref, weights):
    """(numbers, readings) for a training cell. ``record``: the program's
    (or a stand-in's) ``updates`` (batch fields), ``starts`` (state at each
    update's start, None for the first), ``ends`` (parameters after each
    update), ``step_stats``, ``first_grad``, ``params_watched``, the
    updates' mean ``stats`` and their first minibatches' ``first_stats``;
    ``followed``: the reference's updates on them;
    ``ref``: the reference trainer after them."""
    readings: Dict[str, object] = {}
    worst = dict(value=0.0, adv=0.0, logp=0.0, action=0.0, update=0.0)
    mismatch = 0
    for u, (prog, mine) in enumerate(zip(record["updates"], followed), 1):
        mismatch += int((prog["dones"].bool() != mine["dones"]).sum())
        for key, name in (("values", "value"), ("advantages", "adv")):
            worst[name] = max(worst[name], _gap(prog[key], mine[key]) / max(
                _rms(mine[key]), 1e-12))
        worst["logp"] = max(worst["logp"], _gap(prog["log_probs"],
                                                mine["log_probs"]))
        worst["action"] = max(worst["action"], float(mine["gaps"].max()))
        start = (weights if record["starts"][u - 1] is None
                 else record["starts"][u - 1]["params"])
        gaps = leaf_gaps({n: record["ends"][u - 1][n] - start[n]
                          for n in start},
                         {n: mine["params_end"][n] - start[n] for n in start})
        worst["update"] = max(worst["update"], median(gaps.values()))
        readings[f"dparam_worst_leaf_gap.u{u}"] = max(gaps.values())
        ps, rs = record["stats"][u - 1], mine["stats"]
        for name in STATS:
            readings[f"{name}_gap.u{u}"] = abs(ps[name] - rs[name]) / max(
                abs(rs[name]), 1e-12)
        if u > 1:
            ps, rs = record["first_stats"][u - 1], mine["first_stats"]
            readings[f"loss_gap.u{u}.s1"] = gap = abs(
                ps["loss"] - rs["loss"]) / max(loss_scale(rs, ref.cfg), 1e-12)
            worst["replay_s1"] = max(worst.get("replay_s1", 0.0), gap)
    numbers = {"dones_mismatch": float(mismatch),
               "value_gap": worst["value"], "adv_gap": worst["adv"],
               "logp_gap": worst["logp"], "action_gap": worst["action"],
               "dparam_update_gap": worst["update"],
               "loss_gap.replay_s1": worst.get("replay_s1", math.nan)}
    for k, (ps, rs) in enumerate(zip(record["step_stats"], ref.step_stats),
                                 1):
        gap = abs(ps["loss"] - rs["loss"]) / max(loss_scale(rs, ref.cfg),
                                                 1e-12)
        (numbers if k == 1 else readings)[f"loss_gap.s{k}"] = gap
    gaps = leaf_gaps(record["first_grad"], ref.first_grad)
    numbers["grad1_gap"] = max(gaps.values())
    readings["grad1_worst_leaf"] = max(gaps, key=gaps.get)
    norms = {n: float(g.double().norm()) for n, g in ref.first_grad.items()}
    keep = [n for n, v in norms.items()
            if v >= SMALL_LEAF * median(norms.values())]
    readings["dparam_left_out"] = " ".join(
        sorted(n for n in norms if n not in keep)) or "none"
    gaps = leaf_gaps({n: record["params_watched"][n] - weights[n]
                      for n in keep},
                     {n: ref.params_watched[n] - weights[n] for n in keep})
    numbers["dparam_gap"] = median(gaps.values())
    readings["dparam_worst_leaf"] = max(gaps, key=gaps.get)
    readings["dparam_worst_leaf_gap"] = max(gaps.values())
    return numbers, readings


def serving(served_values: torch.Tensor, replayed: dict) -> Dict[str, float]:
    """Numbers for a serving cell: ``served_values`` are the program's (or
    a stand-in's) values at the sampled steps, ``replayed`` holds the
    reference's ``values`` and the Gumbel ``gaps`` of the served actions
    there, and which steps are ``valid``."""
    valid = replayed["valid"]
    values = replayed["values"][valid]
    return {"value_gap": _gap(served_values[valid], values) / max(
        _rms(values), 1e-12),
            "action_gap": float(replayed["gaps"][valid].max())}


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number within its limit, and a limit for every number."""
    return set(numbers) == set(limits) and all(
        math.isfinite(v) and v <= limits[k] for k, v in numbers.items())
