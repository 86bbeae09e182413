"""Plain PyTorch reference of a PPO update of the episodic-memory agent.

One ``Trainer`` holds the reference's own parameters, AdamW state, env
state and episodic memory, and runs updates as the TrXL-PPO reference
describes them:

* Rollout: W workers x T steps. At each step the policy sees its raw memory
  window (the block inputs of the episode's earlier steps, zeros where none
  were written) and writes the step's block inputs to its memory; actions
  are drawn by Gumbel-max from uniforms of the rollout generator, then the
  env steps, then all workers' resets are drawn and applied where an
  episode ended (its memory zeroed). With ``follow`` the actions are the
  given ones (the program's, which the comparison judges), and the Gumbel
  gap of each is kept.
* Every sample keeps its episode and episode step; training windows are
  taken from the episode's memory as it stands at the end of the rollout.
  The bootstrap value takes the window of the memory's last L rows before
  the final episode step, with the last rollout step's slots (the
  reference's own quirk).
* GAE (gamma, lambda), then epochs x minibatches over permutations of the
  update generator: advantages normalised per minibatch (unbiased std +
  1e-8), the clipped surrogate, the clipped value loss, the entropy bonus;
  the gradients clipped to ``max_grad_norm`` by their global norm; AdamW
  (0.9, 0.999, eps 1e-8, weight decay 0.01) at the update's learning rate.

``load_state`` puts given parameters and AdamW state in place of the
reference's own (the program's at the start of an update, where the
comparison follows it update by update). The first ``watch_steps``
optimizer steps of the first update keep their stats and the parameters
after the last of them.

``half_batch`` and ``alter`` plant faults: each minibatch's loss over its
first half alone; every ``alter``-th rollout step, one worker's next action
in place of its draw.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

from .envs import make_env, where_rows
from .model import Model, Precision, gumbel_gap, sample

STATS = ("policy_loss", "value_loss", "loss", "entropy", "kl",
         "clip_fraction")


def schedule(s: dict, update: int) -> float:
    """Polynomial decay, stepped per update."""
    if update > s["max_decay_steps"] or s["initial"] == s["final"]:
        return s["final"]
    frac = (1.0 - update / s["max_decay_steps"]) ** s.get("power", 1.0)
    return (s["initial"] - s["final"]) * frac + s["final"]


def f32(x: float) -> float:
    return float(torch.tensor(x, dtype=torch.float32))


class Trainer:
    def __init__(self, cfg: dict, weights: Dict[str, torch.Tensor], seed: int,
                 device, tf32: bool = False, half_batch: bool = False,
                 watch_steps: int = 3, alter: int = 0):
        self.cfg = cfg
        self.device = torch.device(device)
        W, T = cfg["n_workers"], cfg["worker_steps"]
        self.W, self.T = W, T
        self.env = make_env(cfg["environment"], W, device)
        self.max_ep = self.env.max_episode_steps
        self.model = Model(cfg, self.env.observation_shape,
                           self.env.action_branches, self.max_ep, device,
                           Precision(tf32))
        self.half_batch = half_batch
        self.alter = alter
        self.params = {k: v.detach().clone().requires_grad_(True)
                       for k, v in weights.items()}
        self.adam_m = {k: torch.zeros_like(v) for k, v in weights.items()}
        self.adam_v = {k: torch.zeros_like(v) for k, v in weights.items()}
        self.steps = 0
        self.update = 0
        self.first_grad: Optional[Dict[str, torch.Tensor]] = None
        self.watch_steps = watch_steps
        self.step_stats: List[dict] = []
        self.params_watched: Optional[Dict[str, torch.Tensor]] = None
        self.rollout_gen = torch.Generator(device).manual_seed(seed + 1)
        self.update_gen = torch.Generator(device).manual_seed(seed + 2)
        self.env_state, self.obs = self.env.reset(
            self.env.reset_draws(self.rollout_gen))
        trx = cfg["transformer"]
        self.e = torch.zeros(W, dtype=torch.int64, device=device)
        self.memory = torch.zeros(W, self.max_ep, trx["num_blocks"],
                                  trx["embed_dim"], device=device)

    # --- rollout ------------------------------------------------------------

    @torch.no_grad()
    def rollout(self, follow: Optional[torch.Tensor] = None) -> dict:
        W, T, dev, m = self.W, self.T, self.device, self.model
        p = self.params
        workers = torch.arange(W, device=dev)
        # The episodes of this rollout, each worker's running one first, in
        # a buffer that doubles when it fills.
        episodes = torch.zeros((4 * W,) + self.memory.shape[1:], device=dev)
        episodes[:W] = self.memory
        n_eps, ep_of = W, workers.clone()
        rec = {k: [] for k in ("obs", "actions", "log_probs", "values",
                               "rewards", "dones", "e", "ep", "gaps")}
        infos: Dict[str, List[torch.Tensor]] = {}
        for t in range(T):
            window, mask, slots = m.window(self.memory, self.e)
            logits, value, items = m.forward(p, self.obs, window, mask, slots)
            slot = self.e.clamp(max=self.max_ep - 1)
            self.memory[workers, slot] = items
            episodes[ep_of, slot] = items
            chosen, log_probs, gaps = [], [], []
            for j, lg in enumerate(logits):
                u = torch.rand(lg.shape, generator=self.rollout_gen,
                               device=dev)
                a = sample(lg, u) if follow is None else follow[:, t, j].long()
                if self.alter and follow is None and t % self.alter == 0:
                    a = a.clone()
                    a[t % W] = (a[t % W] + 1) % lg.shape[-1]
                gaps.append(gumbel_gap(lg, u, a))
                chosen.append(a)
                log_probs.append(torch.log_softmax(lg, -1).gather(
                    -1, a[:, None])[:, 0])
            actions = torch.stack(chosen, -1)
            state, obs, reward, done, info = self.env.step(self.env_state,
                                                           actions)
            reset_state, reset_obs = self.env.reset(
                self.env.reset_draws(self.rollout_gen))
            self.env_state = where_rows(done, reset_state, state)
            obs = torch.where(done[:, None, None, None], reset_obs, obs)
            for k, v in (("obs", self.obs), ("actions", actions),
                         ("log_probs", torch.stack(log_probs, -1)),
                         ("values", value), ("rewards", reward),
                         ("dones", done), ("e", self.e), ("ep", ep_of),
                         ("gaps", torch.stack(gaps, -1))):
                rec[k].append(v)
            for k, v in info.items():
                infos.setdefault(k, []).append(v)
            self.memory[done] = 0.0
            n_done = int(done.sum())
            if n_done:
                if n_eps + n_done > len(episodes):
                    grown = torch.zeros((2 * len(episodes),)
                                        + episodes.shape[1:], device=dev)
                    grown[:n_eps] = episodes[:n_eps]
                    episodes = grown
                ep_of = ep_of.clone()
                ep_of[done] = torch.arange(n_eps, n_eps + n_done, device=dev)
                n_eps += n_done
            self.obs = obs
            self.e = torch.where(done, 0, self.e + 1)
        out = {k: torch.stack(v, 1) for k, v in rec.items()}
        out["infos"] = {k: torch.stack(v, 1) for k, v in infos.items()}
        out["episodes"] = episodes[:n_eps]
        # Bootstrap: rows [max(e - L, 0), + L) of the memory at the final
        # episode step, with the slots of the last rollout step's window.
        L = m.L
        rows = (self.e - L).clamp(min=0)[:, None] + torch.arange(L, device=dev)
        window = self.memory[workers[:, None], rows]
        _, last_value, _ = m.forward(p, self.obs, window,
                                     m.mask_table[self.e.clamp(max=L - 1)],
                                     m.index_table[out["e"][:, -1]])
        out["advantages"] = self.gae(out["rewards"], out["values"],
                                     out["dones"], last_value)
        return out

    def gae(self, rewards, values, dones, last_value):
        gamma, lamda = self.cfg["gamma"], self.cfg["lamda"]
        mask = (~dones).float()
        adv = torch.empty_like(values)
        last_v, last_adv = last_value, torch.zeros_like(last_value)
        for t in range(values.shape[1] - 1, -1, -1):
            last_v = last_v * mask[:, t]
            last_adv = last_adv * mask[:, t]
            delta = rewards[:, t] + gamma * last_v - values[:, t]
            last_adv = delta + gamma * lamda * last_adv
            adv[:, t] = last_adv
            last_v = values[:, t]
        return adv

    # --- the PPO update -----------------------------------------------------

    def loss(self, batch: dict, idx: torch.Tensor, clip: float, beta: float):
        m, cfg = self.model, self.cfg
        if self.half_batch:
            idx = idx[: len(idx) // 2]
        flat = lambda k: batch[k].reshape((-1,) + batch[k].shape[2:])[idx]
        e, ep = flat("e"), flat("ep")
        window, mask, slots = m.window(batch["episodes"], e, ep)
        logits, value, _ = m.forward(self.params, flat("obs"), window, mask,
                                     slots)
        actions, old_lp = flat("actions"), flat("log_probs")
        old_v, adv = flat("values"), flat("advantages")
        logps = [torch.log_softmax(lg, -1) for lg in logits]
        lps = torch.stack([lp.gather(-1, actions[:, j:j + 1])[:, 0]
                           for j, lp in enumerate(logps)], -1)
        ent = torch.stack([-(lp.exp() * lp).sum(-1) for lp in logps],
                          -1).sum(-1)
        norm_adv = ((adv - adv.mean()) / (adv.std() + 1e-8))[:, None]
        ratio = torch.exp(lps - old_lp)
        policy = torch.minimum(ratio * norm_adv, ratio.clamp(
            1 - clip, 1 + clip) * norm_adv).mean()
        ret = old_v + adv
        clipped = old_v + (value - old_v).clamp(-clip, clip)
        value_loss = torch.maximum((value - ret) ** 2,
                                   (clipped - ret) ** 2).mean()
        entropy = ent.mean()
        loss = -(policy - cfg["value_loss_coefficient"] * value_loss
                 + beta * entropy)
        kl = ((ratio - 1) - (lps - old_lp)).mean()
        clip_fraction = ((ratio - 1).abs() > clip).float().mean()
        stats = torch.stack([policy, value_loss, loss, entropy, kl,
                             clip_fraction]).detach()
        return loss, stats

    def adamw(self, lr: float) -> None:
        self.steps += 1
        b1, b2, eps, wd = 0.9, 0.999, 1e-8, 0.01
        c1, c2 = 1 - b1 ** self.steps, 1 - b2 ** self.steps
        with torch.no_grad():
            for k, p in self.params.items():
                g = p.grad
                p.mul_(1 - lr * wd)
                self.adam_m[k].mul_(b1).add_(g, alpha=1 - b1)
                self.adam_v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = self.adam_v[k].sqrt() / c2 ** 0.5 + eps
                p.sub_(lr / c1 * self.adam_m[k] / denom)

    def ppo(self, batch: dict) -> tuple:
        """The update's epochs x minibatches; returns its mean stats and its
        first minibatch's (before any step of the update)."""
        cfg, u = self.cfg, self.update
        lr = f32(schedule(cfg["learning_rate_schedule"], u))
        clip = f32(schedule(cfg["clip_range_schedule"], u))
        beta = f32(schedule(cfg["beta_schedule"], u))
        B = self.W * self.T
        n_mb = cfg["n_mini_batch"]
        perms = [torch.randperm(B, generator=self.update_gen,
                                device=self.device)
                 for _ in range(cfg["epochs"])]
        stats = []
        for perm in perms:
            for idx in perm.reshape(n_mb, B // n_mb):
                for p in self.params.values():
                    p.grad = None
                loss, s = self.loss(batch, idx, clip, beta)
                loss.backward()
                with torch.no_grad():
                    grads = [p.grad for p in self.params.values()]
                    norm = torch.linalg.vector_norm(torch.stack(
                        [torch.linalg.vector_norm(g) for g in grads]))
                    scale = (cfg["max_grad_norm"] / (norm + 1e-6)).clamp(
                        max=1.0)
                    for g in grads:
                        g.mul_(scale)
                if self.first_grad is None:
                    self.first_grad = {k: p.grad.clone()
                                       for k, p in self.params.items()}
                self.adamw(lr)
                stats.append(s)
                if self.steps <= self.watch_steps and self.update == 0:
                    self.step_stats.append(dict(zip(STATS, s.tolist())))
                    if self.steps == self.watch_steps:
                        self.params_watched = self.state()["params"]
        self.update += 1
        mean = torch.stack(stats).mean(0)
        return (dict(zip(STATS, mean.tolist())),
                dict(zip(STATS, stats[0].tolist())))

    def state(self) -> dict:
        """Copies of the parameters and the AdamW state."""
        copy = lambda d: {k: v.detach().clone() for k, v in d.items()}
        return dict(params=copy(self.params), exp_avg=copy(self.adam_m),
                    exp_avg_sq=copy(self.adam_v), steps=self.steps)

    def load_state(self, state: dict) -> None:
        with torch.no_grad():
            for k, p in self.params.items():
                p.copy_(state["params"][k])
                self.adam_m[k].copy_(state["exp_avg"][k])
                self.adam_v[k].copy_(state["exp_avg_sq"][k])
        self.steps = int(state["steps"])

    def run_update(self, follow: Optional[torch.Tensor] = None) -> dict:
        """One update; with ``follow`` (W, T, branches) the rollout takes
        those actions. Returns the rollout's record, the update's mean stats
        under ``stats``, its first minibatch's under ``first_stats`` and the
        parameters after it under ``params_end``."""
        batch = self.rollout(follow)
        batch["stats"], batch["first_stats"] = self.ppo(batch)
        batch["params_end"] = self.state()["params"]
        return batch
