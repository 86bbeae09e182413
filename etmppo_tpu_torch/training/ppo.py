"""PPO update: epochs x shuffled minibatches
(counterpart of ``etmppo_tpu/training/ppo.py``, the window-attention path).

The loss is the reference's: per-minibatch advantage normalisation (unbiased
std + 1e-8), clipped surrogate, clipped value loss (max of the squared
errors), summed branch entropies, ``-(policy - c_v * value + beta * entropy)``;
torch ``clip_grad_norm_`` clipping (scale ``max_norm / (norm + 1e-6)``, at
most 1); AdamW (betas 0.9/0.999, eps 1e-8, decoupled weight decay 0.01) with
the learning rate set each update. Gradient-norm telemetry reads the clipped
gradients.

Memory windows are never gathered: the update projects each worker's memory
timeline once per minibatch, and each block's attention reads its window
straight from the projected timeline (``ops/window_attention.py``, the CUDA
forward kernel on the card). With ``pallas_backward`` the attention backward
is the CUDA backward kernel too; without it, the plain PyTorch VJP. With
``grouped`` (the JAX package's ``GROUPED_MODE``) the pair is the grouped one:
the minibatch sorted by worker, and a backward free of atomics.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..config import TrainConfig
from ..models.actor_critic import ActorCriticModel
from ..ops import distributions
from ..ops.memory_index import (build_memory_indices, build_memory_mask,
                                build_timeline, build_timeline_slots,
                                compute_timeline_sources)
from ..ops.window_attention import (window_attention, window_attention_bwd,
                                    window_attention_bwd_grouped,
                                    window_attention_fwd,
                                    window_attention_fwd_grouped)
from .rollout import RolloutBatch

STAT_NAMES = ("policy_loss", "value_loss", "loss", "entropy", "kl",
              "clip_fraction")


def make_optimizer(model: torch.nn.Module) -> torch.optim.Optimizer:
    """AdamW over all parameters; the learning rate is set each update."""
    return torch.optim.AdamW(model.parameters(), lr=0.0, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=0.01)


def clip_grads_torch(model: torch.nn.Module, max_norm: float) -> torch.Tensor:
    """Scales all gradients by ``min(max_norm / (norm + 1e-6), 1)``; returns
    the norm before clipping."""
    return torch.nn.utils.clip_grad_norm_(model.parameters(), max_norm)


def _sumsq(*modules) -> torch.Tensor:
    return torch.stack([p.grad.square().sum() for m in modules
                        for p in m.parameters() if p.grad is not None]).sum()


def grad_norm_groups(model: ActorCriticModel) -> Dict[str, torch.Tensor]:
    """Per-module gradient norms in the reference's groups."""
    groups = {}
    if model.is_visual:
        groups["encoder"] = _sumsq(model.conv1, model.conv2, model.conv3)
    groups["linear_layer"] = _sumsq(model.lin_hidden)
    for i, block in enumerate(model.transformer.blocks):
        groups[f"transformer_block_{i}"] = _sumsq(block)
    for i, branch in enumerate(model.policy_branches):
        groups[f"policy_head_{i}"] = _sumsq(branch)
    groups["lin_policy"] = _sumsq(model.lin_policy)
    groups["value"] = _sumsq(model.lin_value, model.value)
    # Reference quirk: the "model" group counts the value head twice.
    groups["model"] = _sumsq(model) + _sumsq(model.value)
    return {k: v.sqrt() for k, v in groups.items()}


def loss_from_outputs(logits, value, mb, clip_range: float, beta: float,
                      value_loss_coefficient: float
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """PPO loss and its stats vector (``STAT_NAMES``) for one minibatch."""
    log_probs, entropies = distributions.log_probs_and_entropies(
        logits, mb["actions"])
    adv = mb["advantages"]
    norm_adv = ((adv - adv.mean()) / (adv.std() + 1e-8))[:, None]
    log_ratio = log_probs - mb["log_probs"]
    ratio = torch.exp(log_ratio)
    surr1 = ratio * norm_adv
    surr2 = torch.clamp(ratio, 1.0 - clip_range, 1.0 + clip_range) * norm_adv
    policy_loss = torch.minimum(surr1, surr2).mean()

    sampled_return = mb["values"] + adv
    clipped_value = mb["values"] + torch.clamp(value - mb["values"],
                                               -clip_range, clip_range)
    vf_loss = torch.maximum((value - sampled_return) ** 2,
                            (clipped_value - sampled_return) ** 2).mean()
    entropy_bonus = entropies.mean()
    loss = -(policy_loss - value_loss_coefficient * vf_loss
             + beta * entropy_bonus)

    approx_kl = ((ratio - 1.0) - log_ratio).mean()
    clip_fraction = ((ratio - 1.0).abs() > clip_range).float().mean()
    stats = torch.stack([policy_loss, vf_loss, loss, entropy_bonus,
                         approx_kl, clip_fraction]).detach()
    return loss, stats


class PPOUpdate:
    """One PPO update of ``model`` from a rollout batch. The per-epoch
    permutations come from ``generator`` unless the caller passes them.
    ``grouped`` selects the grouped window-attention kernels (sorted by
    worker) in place of the per-sample ones."""

    def __init__(self, config: TrainConfig, model: ActorCriticModel,
                 max_episode_steps: int, generator: torch.Generator,
                 grouped: bool = False):
        if not config.use_pallas_attention:
            raise NotImplementedError(
                "only the window-attention loss is ported "
                "(use_pallas_attention: true)")
        self.config = config
        self.model = model
        self.max_ep = max_episode_steps
        self.generator = generator
        # The window-attention kernels for CUDA tensors (CPU tensors take
        # their plain versions inside the op); no backward kernel means the
        # plain VJP.
        self.kernel, backward_kernel = (
            (window_attention_fwd_grouped, window_attention_bwd_grouped)
            if grouped else (window_attention_fwd, window_attention_bwd))
        self.backward_kernel = (backward_kernel if config.pallas_backward
                                else None)
        device = next(model.parameters()).device
        L = config.transformer.memory_length
        self.mask_table = torch.as_tensor(build_memory_mask(L), device=device)
        self.index_table = torch.as_tensor(
            build_memory_indices(max_episode_steps, L), device=device)
        self.optimizer = make_optimizer(model)

    def loss(self, mb, timeline, timeline_slots, clip_range: float,
             beta: float) -> Tuple[torch.Tensor, torch.Tensor]:
        """Projects the timeline once, then each block's attention reads its
        windows from it through the window-attention op."""
        trx = self.config.transformer
        kv = self.model.project_memory_blocks(timeline, timeline_slots)
        pe = self.model.pe_kv_blocks()

        def make_op(i):
            tk, tv = (t.contiguous() for t in kv[i])
            pk, pv = (t.contiguous() for t in pe[i])
            return lambda q: window_attention(
                q, tk, tv, pk, pv, mb["w_idx"], mb["tl_start"],
                mb["tl_n_valid"], mb["tl_s_lo"], mb["memory_mask"],
                trx.num_heads, self.kernel, self.backward_kernel)

        logits, value, _ = self.model.forward_with_ops(
            mb["obs"], [make_op(i) for i in range(trx.num_blocks)])
        return loss_from_outputs(logits, value, mb, clip_range, beta,
                                 self.config.value_loss_coefficient)

    def prepare(self, batch: RolloutBatch):
        """Timeline, its slots and the flattened per-sample fields."""
        L = self.config.transformer.memory_length
        timeline = build_timeline(batch.snapshot, batch.tape,
                                  batch.episode_steps[:, 0], pad=L)
        timeline_slots = build_timeline_slots(batch.episode_steps,
                                              self.max_ep, pad=L)
        tl = compute_timeline_sources(batch.episode_steps, batch.dones,
                                      self.index_table, L)
        flat = lambda x: x.reshape((-1,) + tuple(x.shape[2:]))
        fields = dict(
            obs=flat(batch.obs), actions=flat(batch.actions),
            log_probs=flat(batch.log_probs), values=flat(batch.values),
            advantages=flat(batch.advantages),
            memory_mask=self.mask_table[
                flat(batch.episode_steps).clamp(0, L - 1)],
            tl_start=flat(tl.start), tl_n_valid=flat(tl.n_valid),
            tl_s_lo=flat(tl.s_lo))
        return timeline, timeline_slots, fields

    def minibatch(self, fields, idx: torch.Tensor):
        mb = {k: v[idx] for k, v in fields.items()}
        mb["w_idx"] = (idx // self.config.worker_steps).to(torch.int32)
        return mb

    def __call__(self, batch: RolloutBatch, learning_rate: float,
                 clip_range: float, beta: float,
                 perms: Optional[torch.Tensor] = None):
        """Runs epochs x minibatches. ``perms`` (epochs, B) overrides the
        generator's permutations. Returns (mean stats (6,), mean grad-norm
        groups), as tensors on the device."""
        cfg = self.config
        B = cfg.batch_size
        timeline, timeline_slots, fields = self.prepare(batch)
        device = timeline.device
        if perms is None:
            perms = torch.stack([
                torch.randperm(B, generator=self.generator, device=device)
                for _ in range(cfg.epochs)])
        mb_indices = perms.to(device).reshape(
            cfg.epochs * cfg.n_mini_batch, cfg.mini_batch_size)
        for group in self.optimizer.param_groups:
            group["lr"] = learning_rate

        stats_sum = torch.zeros(len(STAT_NAMES), device=device)
        groups_sum: Dict[str, torch.Tensor] = {}
        for idx in mb_indices:
            mb = self.minibatch(fields, idx)
            loss, stats = self.loss(mb, timeline, timeline_slots, clip_range,
                                    beta)
            self.optimizer.zero_grad(set_to_none=True)
            loss.backward()
            clip_grads_torch(self.model, cfg.max_grad_norm)
            for k, v in grad_norm_groups(self.model).items():
                groups_sum[k] = groups_sum.get(k, 0.0) + v
            self.optimizer.step()
            stats_sum += stats
        n = len(mb_indices)
        return stats_sum / n, {k: v / n for k, v in groups_sum.items()}
