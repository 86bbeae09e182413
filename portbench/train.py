"""The training driver: a ``train_launches`` cell.

Set-up builds the program's ``PPOTrainer`` from the configuration, loads the
benchmark's weights into it and runs its first launch, ``train_chunk(k)``
with k = ``updates_per_launch`` (on the card: the eager warm-up update, the
capture of the update's CUDA graph and k - 1 replays). During that launch a
``Tap`` reads, outside the program's code, what the comparison judges of its
first ``follow_updates`` updates. The window then calls ``train_chunk(k)``
until ``--seconds`` have passed and counts the env steps of the launches
that completed. With ``--trace 1`` a profiled launch takes the window's
place. Once the program is freed, the plain reference (``reference/``)
follows those first updates from the same weights and seeds and
``compare.training`` judges them.
"""
from __future__ import annotations

import copy
import gc
import math
import time
from typing import Dict, List, Optional

import torch

from . import compare, trace as trace_lib, yardstick
from .harness import stamp
from .reference import model as ref_model
from .reference.ppo import Trainer as RefTrainer

BATCH_FIELDS = ("actions", "values", "log_probs", "dones", "advantages",
                "episode_steps")


def capturing() -> bool:
    return (torch.cuda.is_available()
            and torch.cuda.is_current_stream_capturing())


class _RolloutTap:
    """Stands in for the loop's rollout function: calls it and hands the
    batch to the tap (during a capture, the graph's own tensors)."""

    def __init__(self, rollout_fn, tap: "Tap"):
        self._fn, self._tap = rollout_fn, tap

    def __call__(self, state):
        final, batch = self._fn(state)
        self._tap.batch = batch
        return final, batch

    def __getattr__(self, name):
        return getattr(self._fn, name)


class Tap:
    """Reads the program's first updates without changing what they compute:
    each update's batch fields, the stats of its first minibatch (computed
    before the update's first optimizer step), the parameters and AdamW
    state at its start and the parameters at its end; of the first update,
    the stats of its first ``steps`` minibatches, the first gradient as
    AdamW holds it after its first step (``exp_avg / (1 - beta1)``), and the
    parameters after step ``steps``, before the next step changes them. It
    wraps the fused loop's rollout function, body and replay and the
    update's permutations and minibatch backward, and hooks the optimizer's
    step; ``close`` takes all of it away. The batch, permutation and
    first-minibatch stats tensors it keeps from a capture are the graph's,
    which every replay refills; ``per_replay`` is called after each replay,
    to read them. ``check`` raises unless everything was seen."""

    HOOKED = (("loop", "rollout_fn"), ("loop", "body"), ("loop", "_replay"),
              ("update_fn", "permutations"), ("update_fn", "_backward"))

    def __init__(self, trainer, n_follow: int, steps: int):
        self.trainer, self.n_follow, self.steps = trainer, n_follow, steps
        self.loop, self.update_fn = trainer.fused_loop, trainer.update_fn
        for owner, name in self.HOOKED:
            if not callable(getattr(getattr(self, owner), name, None)):
                raise RuntimeError(f"the program has no {owner}.{name} for "
                                   "the comparison to read")
        self.optimizer = self.update_fn.optimizer
        self.batch = self.perms = None
        self.s1: Optional[torch.Tensor] = None
        self.capture_s1: Optional[torch.Tensor] = None
        self.count = self.step_count = 0
        self.updates: List[Dict[str, torch.Tensor]] = []
        self.first_stats: List[torch.Tensor] = []
        self.starts: List[Optional[dict]] = [None]
        self.ends: List[Dict[str, torch.Tensor]] = []
        self.step_stats: List[torch.Tensor] = []
        self.first_grad: Optional[Dict[str, torch.Tensor]] = None
        self.params_watched: Optional[Dict[str, torch.Tensor]] = None
        self.per_replay = None
        self._body, self._replay = self.loop.body, self.loop._replay
        self._permutations = self.update_fn.permutations
        self._backward = self.update_fn._backward
        self.loop.rollout_fn = _RolloutTap(self.loop.rollout_fn, self)
        self.loop.body = self.body
        self.loop._replay = self.replay
        self.update_fn.permutations = self.permutations
        self.update_fn._backward = self.backward
        self._hook = self.optimizer.register_step_post_hook(self.after_step)

    def named_params(self):
        return self.trainer.model.named_parameters()

    def params(self) -> Dict[str, torch.Tensor]:
        return {n: p.detach().clone() for n, p in self.named_params()}

    def state(self) -> dict:
        """The program's parameters and AdamW state, copied."""
        opt = self.optimizer.state
        return dict(params=self.params(),
                    exp_avg={n: opt[p]["exp_avg"].clone()
                             for n, p in self.named_params()},
                    exp_avg_sq={n: opt[p]["exp_avg_sq"].clone()
                                for n, p in self.named_params()},
                    steps=int(next(iter(opt.values()))["step"]))

    def permutations(self, device):
        self.perms = self._permutations(device)
        return self.perms

    def backward(self, *args):
        stats = self._backward(*args)
        if capturing():
            if self.capture_s1 is None:
                self.capture_s1 = stats     # the graph's own buffer
        else:
            if self.s1 is None:
                self.s1 = stats.clone()
            if len(self.step_stats) < self.steps:
                self.step_stats.append(stats.clone())
        return stats

    def body(self, state):
        out = self._body(state)
        if not capturing():
            self.update_done(self.s1)
        self.s1 = None
        return out

    def replay(self):
        out = self._replay()
        self.update_done(self.capture_s1)
        if self.per_replay is not None:
            self.per_replay(self)
        return out

    def after_step(self, optimizer, args, kwargs) -> None:
        if capturing() or self.step_count >= self.steps:
            return
        self.step_count += 1
        if self.step_count == 1:
            beta1 = optimizer.param_groups[0]["betas"][0]
            self.first_grad = {
                n: (optimizer.state[p]["exp_avg"] / (1 - beta1)).clone()
                for n, p in self.named_params()}
        if self.step_count == self.steps:
            self.params_watched = self.params()

    def update_done(self, s1: Optional[torch.Tensor]) -> None:
        self.count += 1
        if self.count > self.n_follow:
            return
        self.updates.append({k: getattr(self.batch, k).clone()
                             for k in BATCH_FIELDS})
        self.first_stats.append(None if s1 is None else s1.clone())
        self.ends.append(self.params())
        if self.count < self.n_follow:
            self.starts.append(self.state())

    def check(self) -> None:
        """Raises unless the first launch showed every update and step the
        comparison follows (a hook the program no longer calls sees
        nothing, and the comparison would cover less)."""
        seen = dict(updates=len(self.updates),
                    first_minibatches=sum(s is not None
                                          for s in self.first_stats),
                    steps=len(self.step_stats))
        due = dict(updates=self.n_follow, first_minibatches=self.n_follow,
                   steps=self.steps)
        if (seen != due or self.first_grad is None
                or self.params_watched is None):
            raise RuntimeError(
                f"the first launch showed {seen} of {due}, first gradient "
                f"{self.first_grad is not None}, parameters after step "
                f"{self.steps} {self.params_watched is not None}")

    def record(self, results) -> dict:
        return dict(updates=self.updates, starts=self.starts, ends=self.ends,
                    first_stats=[dict(zip(compare.STATS, s.tolist()))
                                 for s in self.first_stats],
                    step_stats=[dict(zip(compare.STATS, s.tolist()))
                                for s in self.step_stats],
                    first_grad=self.first_grad,
                    params_watched=self.params_watched,
                    stats=[{k: r[k] for k in compare.STATS}
                           for r in results[:self.n_follow]])

    def close(self) -> None:
        self.loop.rollout_fn = self.loop.rollout_fn._fn
        del self.loop.body, self.loop._replay
        del self.update_fn.permutations, self.update_fn._backward
        self._hook.remove()


def follow(ref, record: dict) -> List[dict]:
    """The reference over the recorded updates: each on the recorded
    actions, from the recorded state at its start (the first from the
    reference's own, equal to the program's)."""
    out = []
    for u, update in enumerate(record["updates"]):
        if record["starts"][u] is not None:
            ref.load_state(record["starts"][u])
        out.append(ref.run_update(update["actions"]))
    return out


def build_config(spec, seed: int, tmp: str) -> dict:
    cfg = copy.deepcopy(spec.config["config"])
    cfg.update(seed=seed, checkpoint_dir=f"{tmp}/checkpoints",
               summary_dir=f"{tmp}/summaries",
               num_devices=spec.traffic.get("num_devices", 1))
    cfg.update(spec.overrides)
    return cfg


def run(spec, seed: int, seconds: float, trace: bool, tmp: str, device,
        t_start: float) -> dict:
    from etmppo_tpu_torch.config import config_from_dict
    from etmppo_tpu_torch.training.trainer import PPOTrainer

    traffic = spec.traffic
    cfg = build_config(spec, seed, tmp)
    n_follow = traffic["follow_updates"]
    trainer = PPOTrainer(config_from_dict(cfg), run_id="portbench",
                         device=device, enable_metrics=False)
    env = trainer.env
    param_spec = ref_model.param_spec(cfg, env.observation_shape,
                                      env.action_branches)
    weights = ref_model.make_weights(param_spec, seed, device)
    trainer.model.load_state_dict(weights, strict=True)
    stamp(t_start, "trainer built, weights loaded")
    k = cfg["updates_per_launch"]
    if k < n_follow:
        raise ValueError(f"a launch of {k} updates cannot show the first "
                         f"{n_follow}")
    tap = Tap(trainer, n_follow, traffic["follow_steps"])
    for plant in spec.faults:
        plant(trainer)
    t0 = time.perf_counter()
    results = trainer.train_chunk(k)
    sync(device)
    first_launch_s = time.perf_counter() - t0
    stamp(t_start, f"first launch of {k} updates: {first_launch_s:.3f} s, "
          f"capture {trainer.fused_loop.capture}")
    tap.check()
    record = tap.record(results)
    setup_s = time.perf_counter() - t_start
    steps_per_update = cfg["n_workers"] * cfg["worker_steps"]

    metrics: Dict[str, float] = {}
    context: Dict = dict(first_launch_s=first_launch_s)
    attempted = failed = 0
    launch_s: Dict[str, float] = {}
    if trace:
        attempted, failed = traced_launch(trainer, tap, cfg, k, device,
                                          context)
    else:
        ends = [time.perf_counter()]
        while ends[-1] - ends[0] < seconds:
            for r in trainer.train_chunk(k):
                attempted += 1
                failed += not all(map(math.isfinite, r.values()))
            ends.append(time.perf_counter())
        window_s = ends[-1] - ends[0]
        metrics["env_steps_per_s"] = ((len(ends) - 1) * k * steps_per_update
                                      / window_s)
        each = sorted(b - a for a, b in zip(ends, ends[1:]))
        mid = compare.median(each)
        launch_s = dict(min=each[0], median=mid, max=each[-1],
                        over_5pct=sum(t > 1.05 * mid for t in each))
        metrics["setup_s"] = setup_s
    stamp(t_start, f"window closed: {attempted} updates")
    tap.close()
    memory_peak = (torch.cuda.max_memory_allocated(device)
                   if torch.device(device).type == "cuda" else 0)
    del trainer, tap, results
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()

    ref = RefTrainer(cfg, weights, seed, device,
                     watch_steps=traffic["follow_steps"])
    numbers, readings = compare.training(record, follow(ref, record), ref,
                                         weights)
    readings.update({f"launch_s.{k}": v for k, v in launch_s.items()})
    stamp(t_start, f"reference followed {n_follow} updates")
    return dict(metrics=metrics, context=context, numbers=numbers,
                readings=readings, attempted=attempted, failed=failed,
                memory_peak_bytes=memory_peak)


def traced_launch(trainer, tap, cfg, k: int, device, context):
    """One launch after the first, profiled; what the per-layer metrics
    read goes into ``context``. Returns (updates attempted, failed)."""
    seen = []

    def per_replay(tap):
        seen.append((tap.batch.episode_steps.clone(), tap.batch.dones.clone(),
                     tap.perms.clone()))
    tap.per_replay = per_replay
    with trace_lib.Profile() as prof:
        with prof.window():
            results = trainer.train_chunk(k)
        sync(device)
    tap.per_replay = None
    summary = prof.summary()
    context.update(trace=summary, updates_traced=k,
                   flops_per_update=yardstick.update_flops(cfg, trainer.env))
    if seen:
        context["attn_bound_s"] = attention_bounds(cfg, trainer, seen)
    failed = sum(not all(map(math.isfinite, r.values()))
                 for r in results)
    return len(results), failed


def attention_bounds(cfg, trainer, seen) -> Dict[str, float]:
    """The frozen bound of every window-attention call of the traced
    updates, summed: forward and backward."""
    trx = cfg["transformer"]
    L, D = trx["memory_length"], trx["embed_dim"]
    W, T = cfg["n_workers"], cfg["worker_steps"]
    max_ep = trainer.env.max_episode_steps
    mb = W * T // cfg["n_mini_batch"]
    fwd = bwd = 0.0
    for steps, dones, perms in seen:
        src = yardstick.timeline_sources(steps, dones, max_ep, L)
        for idx in perms.reshape(-1, mb):
            calls = trx["num_blocks"]
            fwd += calls * yardstick.window_bound_s(src, idx, T, W, max_ep, L,
                                                    D, backward=False)
            bwd += calls * yardstick.window_bound_s(src, idx, T, W, max_ep, L,
                                                    D, backward=True)
    return dict(fwd=fwd, bwd=bwd)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
