"""The serving driver: a ``serve_lockstep`` cell.

A closed loop of ``streams`` episode streams in lockstep, one
``PolicyServer.step`` a tick, as an evaluation sweep or a game host batches
its sessions. Set-up writes the benchmark's weights as a ``.nn`` under the
run's temporary directory, loads it into the program's ``PolicyServer``
(sampling, its generator seeded from ``--seed``), makes a bank of float32
84x84x3 frames in [0, 1] and each stream's episode lengths (uniform over
``episode_steps``) from the seed, and runs ``warmup_ticks`` ticks. The
window then ticks until ``--seconds`` have passed: the streams whose episode
ended are reset with ``PolicyServer.reset``, then one timed ``step`` hands
in the host frames and takes the actions and values back to the host.
With ``--trace 1`` ``trace_ticks`` profiled ticks take the window's place.
Once the window has closed, a sample of the finished episodes drawn from
the seed, the longest among them, is replayed by the plain reference on the
same frames, with the uniforms of each served draw, and
``compare.serving`` judges the served values and actions.
"""
from __future__ import annotations

import gc
import time
from typing import Dict, List

import numpy as np
import torch

from . import compare, trace as trace_lib, yardstick
from .harness import stamp
from .reference import model as ref_model
from .reference.envs import make_env


class Traffic:
    """The lockstep schedule: the frame of every stream at every tick, and
    the episodes that end."""

    def __init__(self, traffic: dict, seed: int, obs_shape):
        rng = np.random.default_rng(seed)
        self.M = traffic["streams"]
        self.lo, self.hi = traffic["episode_steps"]
        self.bank = rng.random((traffic["bank_batches"], self.M) + obs_shape,
                               dtype=np.float32)
        self.rng = rng
        self.left = self._lengths(self.M)
        self.start = np.zeros(self.M, np.int64)
        self.tick = 0
        self.finished: List[tuple] = []   # (stream, first tick, length)

    def _lengths(self, n: int) -> np.ndarray:
        return self.rng.integers(self.lo, self.hi + 1, n)

    def frames(self, tick: int) -> np.ndarray:
        return self.bank[tick % len(self.bank)]

    def ended(self) -> np.ndarray:
        """The streams whose episode has ended, each given a new length."""
        done = np.flatnonzero(self.left == 0)
        for s in done:
            self.finished.append((int(s), int(self.start[s]),
                                  int(self.tick - self.start[s])))
        self.left[done] = self._lengths(done.size)
        self.start[done] = self.tick
        return done

    def advance(self) -> None:
        self.left -= 1
        self.tick += 1


def tick(server, traffic: Traffic, served: list) -> float:
    """One tick: the resets, then the timed step. Returns its seconds."""
    done = traffic.ended()
    if done.size:
        server.reset(done.tolist())
    t0 = time.perf_counter()
    actions, values = server.step(traffic.frames(traffic.tick))
    seconds = time.perf_counter() - t0
    served.append((actions, values))
    traffic.advance()
    return seconds


def run(spec, seed: int, seconds: float, trace: bool, tmp: str, device,
        t_start: float) -> dict:
    from etmppo_tpu_torch.config import config_from_dict
    from etmppo_tpu_torch.models.actor_critic import ActorCriticModel
    from etmppo_tpu_torch.serve import PolicyServer
    from etmppo_tpu_torch.training.checkpoint import save_model

    t = spec.traffic
    cfg = dict(spec.config["config"], **spec.overrides)
    env = make_env(cfg["environment"], 1, "cpu")
    obs_shape, branches = env.observation_shape, env.action_branches
    max_ep = env.max_episode_steps
    if t["episode_steps"][1] > max_ep:
        raise ValueError(f"episodes longer than the env's {max_ep} steps")
    weights = ref_model.make_weights(
        ref_model.param_spec(cfg, obs_shape, branches), seed, device)
    model = ActorCriticModel(config_from_dict(cfg), obs_shape, branches,
                             max_ep, device=device)
    model.load_state_dict(weights, strict=True)
    path = f"{tmp}/policy.nn"
    save_model(path, model, config_from_dict(cfg))
    del model
    server = PolicyServer(path, max_streams=t["streams"], greedy=False,
                          seed=seed, device=device)
    for plant in spec.faults:
        plant(server)
    traffic = Traffic(t, seed, obs_shape)
    served: list = []
    for _ in range(t["warmup_ticks"]):
        tick(server, traffic, served)
    setup_s = time.perf_counter() - t_start
    stamp(t_start, "server loaded, warm-up ticks done")

    metrics: Dict[str, float] = {}
    context: Dict = {}
    window_ticks = t["trace_ticks"] if trace else 0
    if trace:
        with trace_lib.Profile() as prof:
            with prof.window():
                for _ in range(window_ticks):
                    tick(server, traffic, served)
        context.update(trace=prof.summary(), ticks_traced=window_ticks,
                       flops_per_tick=yardstick.step_flops(
                           cfg, obs_shape, branches, t["streams"]))
    else:
        latencies = []
        w0 = time.perf_counter()
        while time.perf_counter() - w0 < seconds:
            latencies.append(tick(server, traffic, served))
        window_s = time.perf_counter() - w0
        window_ticks = len(latencies)
        metrics.update(
            policy_steps_per_s=t["streams"] * window_ticks / window_s,
            serve_step_p95_ms=float(np.percentile(latencies, 95)) * 1e3,
            setup_s=setup_s)
        context["samples"] = window_ticks
    stamp(t_start, f"window closed: {window_ticks} ticks")
    memory_peak = (torch.cuda.max_memory_allocated(device)
                   if torch.device(device).type == "cuda" else 0)
    del server
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()

    traffic.ended()         # the episodes that ended at the last tick
    sample = sample_episodes(traffic.finished, t["sample_episodes"], seed)
    actions = torch.as_tensor(np.stack([a for a, _ in served]), device=device)
    values = torch.as_tensor(np.stack([v for _, v in served]), device=device)
    replayed = replay(cfg, weights, traffic, sample, seed, device, actions)
    numbers = compare.serving(at_steps(values, replayed), replayed)
    stamp(t_start, f"reference replayed {len(sample)} episodes")
    return dict(metrics=metrics, context=context, numbers=numbers,
                readings=dict(episodes_checked=len(sample),
                              steps_checked=int(replayed["valid"].sum())),
                attempted=len(served) - t["warmup_ticks"], failed=0,
                memory_peak_bytes=memory_peak)


def sample_episodes(finished: List[tuple], n: int, seed: int) -> List[tuple]:
    """The longest finished episode and n - 1 others drawn from the seed."""
    if not finished:
        raise RuntimeError("no episode finished: the run checked nothing")
    longest = max(range(len(finished)), key=lambda i: finished[i][2])
    rest = [i for i in range(len(finished)) if i != longest]
    rng = np.random.default_rng(seed + 1)
    picked = rng.choice(rest, size=min(n - 1, len(rest)), replace=False)
    return [finished[longest]] + [finished[i] for i in sorted(picked)]


def uniforms(seed: int, ticks: int, rows: int, branches, device):
    """The uniforms of every served draw, (ticks, rows, A) per branch: the
    server's generator, seeded alike, draws one (rows, A) block per branch
    at every step."""
    gen = torch.Generator(device).manual_seed(seed)
    draws = [[torch.rand((rows, a), generator=gen, device=device)
              for a in branches] for _ in range(ticks)]
    return [torch.stack(d) for d in zip(*draws)]


def at_steps(table: torch.Tensor, replayed: dict) -> torch.Tensor:
    """``table`` (ticks, streams, ...) at each sampled episode's steps:
    (episodes, longest, ...), zero past an episode's end."""
    out = table[replayed["ticks"].clamp(max=len(table) - 1),
                replayed["streams"][:, None]]
    mask = replayed["valid"].reshape(replayed["valid"].shape
                                     + (1,) * (out.dim() - 2))
    return torch.where(mask, out, torch.zeros_like(out))


@torch.no_grad()
def replay(cfg, weights, traffic: Traffic, sample, seed: int, device,
           served_actions=None, tf32: bool = False, alter: int = 0) -> dict:
    """The reference over the sampled episodes, in lockstep, each from a
    fresh memory on its stream's frames. Returns, as (episodes, longest)
    tensors: its ``values``, the ``actions`` (the served ones, or with
    ``served_actions`` None the ones it draws itself with the same
    uniforms, as a stand-in for the program), the Gumbel ``gaps`` of those
    actions, and where each step lies (``ticks``, ``streams``, ``valid``).
    ``alter`` > 0 plants a fault in a stand-in: every ``alter``-th step of
    each episode serves the next action instead of its draw."""
    env = make_env(cfg["environment"], 1, "cpu")
    branches = env.action_branches
    m = ref_model.Model(cfg, env.observation_shape, branches,
                        env.max_episode_steps, device,
                        ref_model.Precision(tf32))
    streams = torch.tensor([s for s, _, _ in sample], device=device)
    first = torch.tensor([n0 for _, n0, _ in sample], device=device)
    length = torch.tensor([n for _, _, n in sample], device=device)
    E, longest = len(sample), int(length.max())
    bank = torch.as_tensor(traffic.bank, device=device)
    u = uniforms(seed, int((first + length).max()), traffic.M, branches,
                 device)
    trx = cfg["transformer"]
    memory = torch.zeros(E, env.max_episode_steps, trx["num_blocks"],
                         trx["embed_dim"], device=device)
    steps = torch.arange(longest, device=device)
    out = dict(ticks=first[:, None] + steps, streams=streams,
               valid=steps[None] < length[:, None],
               values=torch.zeros(E, longest, device=device),
               gaps=torch.zeros(E, longest, device=device),
               actions=torch.zeros(E, longest, len(branches),
                                   dtype=torch.long, device=device))
    for i in range(longest):
        live = torch.nonzero(length > i)[:, 0]
        ticks, rows = first[live] + i, streams[live]
        e = torch.full((len(live),), i, device=device)
        window, mask, slots = m.window(memory, e, live)
        logits, value, items = m.forward(weights, bank[ticks % len(bank),
                                                       rows],
                                         window, mask, slots)
        memory[live, i] = items
        draws = [ub[ticks, rows] for ub in u]
        if served_actions is None:
            chosen = torch.stack([ref_model.sample(lg, d) for lg, d in
                                  zip(logits, draws)], -1)
            if alter and i % alter == alter - 1:
                chosen = (chosen + 1) % torch.tensor(branches, device=device)
        else:
            chosen = served_actions[ticks, rows].long()
        out["values"][live, i] = value
        out["actions"][live, i] = chosen
        out["gaps"][live, i] = torch.stack([
            ref_model.gumbel_gap(lg, d, chosen[:, j])
            for j, (lg, d) in enumerate(zip(logits, draws))],
            -1).max(-1).values
    return out
