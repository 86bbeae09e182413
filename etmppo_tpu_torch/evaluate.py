"""Batched policy evaluation (counterpart of ``etmppo_tpu/evaluate.py``).

N episodes run side by side: N environments reset from one generator,
stepped for ``max_episode_steps`` steps on the KV-cache path with each
episode's statistics latched at its end; per-episode statistics and their
aggregates (mean, std, IQM) come back. The reference's protocol (5 training
seeds x 50 env seeds x 5 repeats, IQM with a bootstrapped CI) is
``evaluate_protocol``.

    python -m etmppo_tpu_torch.evaluate --model=a.nn,b.nn --episodes=50 \
        --repeats=5 [--seed=0] [--cpu]

Evaluation runs on the CUDA device unless ``--cpu`` is given, and raises
without a GPU.
"""
from __future__ import annotations

import argparse
from typing import Dict, Tuple

import numpy as np
import torch

from .config import TrainConfig
from .envs.factory import create_env
from .models.actor_critic import ActorCriticModel
from .models.kv_cache import KVCacheStep
from .ops import distributions
from .training.checkpoint import load_model


def interquartile_mean(values: np.ndarray) -> float:
    """IQM: mean of the middle 50% (rliable's headline statistic)."""
    v = np.sort(np.asarray(values).ravel())
    n = len(v)
    lo, hi = n // 4, n - n // 4
    return float(v[lo:hi].mean()) if hi > lo else float(v.mean())


def stratified_bootstrap_ci(per_seed: list, n_boot: int = 2000,
                            alpha: float = 0.05, seed: int = 0
                            ) -> Tuple[float, float]:
    """Bootstrapped CI for the cross-seed IQM (reference protocol: IQM +
    bootstrapped CI over 5 training seeds, README.md:230 / rliable).

    Stratified over training seeds, rliable-style: each replicate resamples
    the seeds with replacement, then the episodes within each chosen seed,
    and takes the IQM of the pooled episode scores.
    """
    rng = np.random.default_rng(seed)
    arrays = [np.asarray(a).ravel() for a in per_seed]
    n_seeds = len(arrays)
    stats = np.empty(n_boot)
    for b in range(n_boot):
        picked = rng.integers(0, n_seeds, size=n_seeds)
        pooled = np.concatenate([
            arrays[i][rng.integers(0, len(arrays[i]), size=len(arrays[i]))]
            for i in picked])
        stats[b] = interquartile_mean(pooled)
    lo, hi = np.quantile(stats, [alpha / 2, 1 - alpha / 2])
    return float(lo), float(hi)


class Evaluation:
    """``episodes`` episodes of ``model`` on its config's env, side by side.
    The resets draw from a generator seeded ``env_seed``; the actions and
    the env's step draws from one seeded ``seed``, actions first at each
    step. Each draw goes through one method, so that a test can replace
    it."""

    def __init__(self, model: ActorCriticModel, config: TrainConfig,
                 episodes: int, seed: int, env_seed: int):
        self.model = model
        self.config = config
        self.episodes = episodes
        self.env_seed = env_seed
        self.device = model.lin_hidden.weight.device
        self.env = create_env(config.environment, episodes, self.device)
        self.reset_generator = torch.Generator(self.device).manual_seed(
            env_seed)
        self.generator = torch.Generator(self.device).manual_seed(seed)

    def reset_draws(self):
        return self.env.sample_reset_draws(self.reset_generator)

    def step_draws(self):
        return self.env.sample_step_draws(self.generator)

    def sample_actions(self, logits, step: int):
        del step
        return distributions.sample_multi(logits, self.generator)[0]

    @torch.no_grad()
    def __call__(self) -> Dict[str, np.ndarray]:
        """Runs the ``max_episode_steps`` steps (no early stop, so the
        generators are consumed at every step) and returns each info key's
        per-episode values, read at each episode's end."""
        model, env, N, dev = self.model, self.env, self.episodes, self.device
        max_ep = env.max_episode_steps
        kv_step = KVCacheStep(model, N, max_ep,
                              self.config.transformer.memory_length, dev)
        rows = torch.arange(N, device=dev)
        env_state, obs = env.reset(self.reset_draws())
        pe_k, pe_v = model.pe_kv()
        k_cache = pe_k.expand(N, -1, -1, -1).clone()
        v_cache = pe_v.expand(N, -1, -1, -1).clone()
        t = torch.zeros(N, dtype=torch.int64, device=dev)
        finished = torch.zeros(N, dtype=torch.bool, device=dev)
        infos = {k: torch.zeros(N, device=dev) for k in env.info_keys}
        for step in range(max_ep):
            logits, _, _, slot, k_item, v_item = kv_step(obs, k_cache,
                                                          v_cache, t)
            k_cache[rows, slot], v_cache[rows, slot] = k_item, v_item
            actions = self.sample_actions(logits, step)
            env_state, obs, _, done, info = env.step(env_state, actions,
                                                     self.step_draws())
            ended_now = done & ~finished
            infos = {k: torch.where(ended_now, info[k].float(), v)
                     for k, v in infos.items()}
            finished = finished | done
            t = torch.where(finished, t, t + 1)
        if not bool(finished.all()):
            raise RuntimeError("episodes must terminate within "
                               f"max_episode_steps={max_ep}")
        return {k: v.cpu().numpy() for k, v in infos.items()}


def evaluate_params(model: ActorCriticModel, config: TrainConfig,
                    episodes: int = 50, seed: int = 0, env_seed: int = None
                    ) -> Dict[str, np.ndarray]:
    """Per-episode arrays for each env info key (reward/length/...), on the
    model's device. ``env_seed`` (default: ``seed``) seeds the resets apart
    from the policy's sampling, so the reference's "50 novel env seeds x 5
    repeats" is a fixed ``env_seed`` with ``seed`` varied per repeat."""
    if env_seed is None:
        env_seed = seed
    return Evaluation(model, config, episodes, seed, env_seed)()


def _repeats(model, config, episodes: int, seed: int, repeats: int
             ) -> Dict[str, np.ndarray]:
    """Per key, the episodes of ``repeats`` evaluations with policy seeds
    ``seed + 1000 * r`` over the same env seeds, concatenated."""
    chunks: Dict[str, list] = {}
    for r in range(repeats):
        infos = evaluate_params(model, config, episodes,
                                seed=seed + 1000 * r, env_seed=seed)
        for k, v in infos.items():
            chunks.setdefault(k, []).append(v)
    return {k: np.concatenate(v) for k, v in chunks.items()}


def evaluate_model(model_path: str, episodes: int = 50, seed: int = 0,
                   repeats: int = 1, device="cuda") -> Dict[str, float]:
    """One model's summary: mean, std and IQM of each info key."""
    model, config = load_model(model_path, device)
    summary: Dict[str, float] = {}
    for key, values in _repeats(model, config, episodes, seed,
                                repeats).items():
        summary[key + "_mean"] = float(values.mean())
        summary[key + "_std"] = float(values.std())
        summary[key + "_iqm"] = interquartile_mean(values)
    return summary


def evaluate_protocol(model_paths, episodes: int = 50, repeats: int = 5,
                      seed: int = 0, n_boot: int = 2000, device="cuda"):
    """Reference evaluation protocol (README.md:230): N training seeds (one
    model each) x ``episodes`` env seeds x ``repeats`` policy-sampling
    repeats; cross-seed IQM with a stratified bootstrap CI.

    Returns ``(per_seed, aggregate)``: per_seed maps model path ->
    {key: per-episode array}; aggregate maps key -> (iqm, ci_lo, ci_hi).
    """
    per_seed: Dict[str, Dict[str, np.ndarray]] = {}
    for path in model_paths:
        model, config = load_model(path, device)
        per_seed[path] = _repeats(model, config, episodes, seed, repeats)
    keys = next(iter(per_seed.values())).keys()
    aggregate = {}
    for key in keys:
        arrays = [per_seed[p][key] for p in model_paths]
        pooled = np.concatenate(arrays)
        ci_lo, ci_hi = stratified_bootstrap_ci(arrays, n_boot=n_boot)
        aggregate[key] = (interquartile_mean(pooled), ci_lo, ci_hi)
    return per_seed, aggregate


def main(argv=None):
    parser = argparse.ArgumentParser(description="Evaluate trained model(s)")
    parser.add_argument(
        "--model", default="./models/run.nn",
        help="model path, or comma-separated paths (one per training seed) "
             "to run the cross-seed protocol: IQM + bootstrapped CI")
    parser.add_argument("--episodes", type=int, default=50)
    parser.add_argument("--seed", type=int, default=0,
                        help="env-seed base (fixed across repeats)")
    parser.add_argument("--repeats", type=int, default=1,
                        help="policy-sampling repeats per env seed "
                             "(reference protocol: 5)")
    parser.add_argument("--cpu", action="store_true",
                        help="Evaluate on the CPU instead of the GPU")
    args = parser.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    paths = [p for p in args.model.split(",") if p]
    if len(paths) == 1:
        summary = evaluate_model(paths[0], args.episodes, args.seed,
                                 repeats=args.repeats, device=device)
        for key, value in sorted(summary.items()):
            print(f"{key}: {value:.4f}")
        return
    per_seed, aggregate = evaluate_protocol(
        paths, episodes=args.episodes, repeats=args.repeats, seed=args.seed,
        device=device)
    print(f"# {len(paths)} training seeds x {args.episodes} env seeds x "
          f"{args.repeats} repeats")
    for path in paths:
        row = "  ".join(f"{k}_iqm={interquartile_mean(v):.4f}"
                        for k, v in sorted(per_seed[path].items()))
        print(f"{path}: {row}")
    print("# cross-seed aggregate (IQM [95% bootstrap CI])")
    for key, (iqm, lo, hi) in sorted(aggregate.items()):
        print(f"{key}: {iqm:.4f} [{lo:.4f}, {hi:.4f}]")


if __name__ == "__main__":
    main()
