"""PPO update: epochs x shuffled minibatches
(counterpart of ``etmppo_tpu/training/ppo.py``).

The loss is the reference's: per-minibatch advantage normalisation (unbiased
std + 1e-8), clipped surrogate, clipped value loss (max of the squared
errors), summed branch entropies, ``-(policy - c_v * value + beta * entropy)``;
torch ``clip_grad_norm_`` clipping (scale ``max_norm / (norm + 1e-6)``, at
most 1); AdamW (betas 0.9/0.999, eps 1e-8, decoupled weight decay 0.01) with
the learning rate set each update. Gradient-norm telemetry reads the clipped
gradients.

The learning rate, clip range and entropy coefficient of an update are
``PPOUpdate.schedule``, three float32 values on the device, as the JAX
package's fused loop holds them (``set_schedule`` fills it; ``run`` reads
it), so that one update is a body that a CUDA graph can replay with other
values (``training/fused.py``). On CUDA the optimizer is AdamW with
``capturable=True``, which takes the learning rate as that device tensor;
its bias correction is computed on the device and differs from the
non-capturable one's in the last bits. The CPU keeps the non-capturable
AdamW (PyTorch refuses a capturable one for CPU parameters), with the
float32 learning rate as a number.

The memory windows come from (pre-rollout snapshot, tape) by index math, in
one of two ways, as ``use_pallas_attention`` says:

* ``loss_gathered`` (JAX's ``_loss_fast``, ``use_pallas_attention: false``):
  the per-worker sources ``[snapshot | tape | zero PE region]`` are projected
  once per minibatch and each sample's K/V window is gathered from them
  (``compute_window_sources``); the attention is plain PyTorch, as the JAX
  package's is plain XLA there.
* ``loss_timeline`` (JAX's ``_loss_pallas``): each worker's memory timeline
  is projected once per minibatch, and each block's attention reads its
  windows straight from it (``ops/window_attention.py``, the CUDA forward
  kernel on the card). With ``pallas_backward`` the attention backward is
  the CUDA backward kernel too; without it, the plain PyTorch VJP. With
  ``grouped`` (the JAX package's ``GROUPED_MODE``) the pair is the grouped
  one: the minibatch sorted by worker, and a backward free of atomics.

``loss_window`` (JAX's ``_loss``) runs the model on the raw gathered windows;
tests hold the other two against it.

With ``compute_dtype: bfloat16`` the window-attention op stays float32, as
the kernels are: ``loss_timeline`` casts q, the block's timeline K/V and its
PE K/V to float32 at the op's boundary and the op's output back to the
compute dtype (JAX's ``_loss_pallas``); autograd casts the gradients the
other way. With ``obs_uint8`` the batch holds the observations quantized to
uint8, and ``minibatch`` turns them back into ``obs / 255`` floats after the
gather, for every loss path.

Data parallelism (a ``mesh``, ``parallel/mesh.py``): the batch is this
rank's workers' rows. Every rank draws the same global permutation from its
replicated generator; of each global minibatch of M samples it takes those
whose worker is its own, in permutation order, with rank-local indices
(``rank_minibatches``), so each rank projects only its own workers'
timeline or sources and the kernels see a rank-local timeline. The loss is
the rank's part of the global minibatch's: its advantages are normalised
with the whole minibatch's mean and unbiased std (from the advantages of
all workers, gathered once per update: one device's values in one device's
order), and every mean is the rank's sum over the global count
(``loss_from_outputs``). After the backward one ``all_reduce`` of one flat
buffer sums every gradient and the six stats over the ranks
(``mesh.all_reduce_flat``); every rank then clips and steps alike. A rank
with no sample of a minibatch launches nothing and adds zeros.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from ..config import TrainConfig
from ..models.actor_critic import ActorCriticModel
from ..ops import distributions
from ..ops.memory_index import (build_memory_indices, build_memory_mask,
                                build_timeline, build_timeline_slots,
                                compute_timeline_sources,
                                compute_window_sources)
from ..ops.window_attention import (window_attention, window_attention_bwd,
                                    window_attention_bwd_grouped,
                                    window_attention_fwd,
                                    window_attention_fwd_grouped)
from ..parallel.mesh import DataMesh, all_reduce_flat
from .rollout import RolloutBatch

STAT_NAMES = ("policy_loss", "value_loss", "loss", "entropy", "kl",
              "clip_fraction")


def make_optimizer(model: torch.nn.Module) -> torch.optim.Optimizer:
    """AdamW over all parameters, capturable on CUDA; the learning rate is
    set each update."""
    cuda = next(model.parameters()).device.type == "cuda"
    return torch.optim.AdamW(model.parameters(), lr=0.0, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=0.01, capturable=cuda)


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


def loss_from_outputs(logits, value, mb, clip_range, beta,
                      value_loss_coefficient: float
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """PPO loss and its stats vector (``STAT_NAMES``) for the samples of
    ``mb``, a part of a global minibatch of ``mb["n_global"]`` samples (all
    of it on one device): the advantages are normalised with the global
    minibatch's ``mb["adv_mean"]`` and ``mb["adv_std"]``, and every mean is
    the part's sum over the global count, so the parts' losses and stats add
    up to the global minibatch's. ``clip_range`` and ``beta`` are numbers or
    0-d float32 tensors on the device (``PPOUpdate.schedule``)."""
    log_probs, entropies = distributions.log_probs_and_entropies(
        logits, mb["actions"])
    adv = mb["advantages"]
    n = mb["n_global"]

    def mean(x):
        return x.sum() / (n * (x.numel() // x.shape[0]))
    norm_adv = ((adv - mb["adv_mean"]) / (mb["adv_std"] + 1e-8))[:, None]
    log_ratio = log_probs - mb["log_probs"]
    ratio = torch.exp(log_ratio)
    surr1 = ratio * norm_adv
    surr2 = torch.clamp(ratio, 1.0 - clip_range, 1.0 + clip_range) * norm_adv
    policy_loss = mean(torch.minimum(surr1, surr2))

    sampled_return = mb["values"] + adv
    clipped_value = mb["values"] + torch.clamp(value - mb["values"],
                                               -clip_range, clip_range)
    vf_loss = mean(torch.maximum((value - sampled_return) ** 2,
                                 (clipped_value - sampled_return) ** 2))
    entropy_bonus = mean(entropies)
    loss = -(policy_loss - value_loss_coefficient * vf_loss
             + beta * entropy_bonus)

    approx_kl = mean((ratio - 1.0) - log_ratio)
    clip_fraction = mean(((ratio - 1.0).abs() > clip_range).float())
    stats = torch.stack([policy_loss, vf_loss, loss, entropy_bonus,
                         approx_kl, clip_fraction]).detach()
    return loss, stats


def gather_windows(src: torch.Tensor, w_idx: torch.Tensor,
                   flat_index: torch.Tensor) -> torch.Tensor:
    """``src[w_idx[:, None], flat_index]``: (B, L, ...) rows of the
    per-worker sources (W, S, ...). Taken with ``index_select`` over the
    flattened sources, whose backward is an ``index_add_``, far cheaper on
    the CPU than the ``index_put_`` behind advanced indexing."""
    W, S = src.shape[:2]
    rows = (w_idx.long()[:, None] * S + flat_index.long()).reshape(-1)
    flat = src.reshape((W * S,) + tuple(src.shape[2:]))
    return flat.index_select(0, rows).reshape(
        tuple(flat_index.shape) + tuple(src.shape[2:]))


class PPOUpdate:
    """One PPO update of ``model`` from a rollout batch. The per-epoch
    permutations come from ``generator`` unless the caller passes them.
    ``grouped`` selects the grouped window-attention kernels (sorted by
    worker) in place of the per-sample ones. With a ``mesh`` the batch is
    this rank's workers' rows and the update is the global one (see the
    module's docstring)."""

    def __init__(self, config: TrainConfig, model: ActorCriticModel,
                 max_episode_steps: int, generator: torch.Generator,
                 grouped: bool = False, mesh: Optional[DataMesh] = None):
        self.config = config
        self.model = model
        self.max_ep = max_episode_steps
        self.generator = generator
        self.mesh = mesh
        # This rank's samples in each minibatch of the last update.
        self.rank_samples: List[int] = []
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
        # (learning rate, clip range, beta) of the update: set_schedule fills
        # it, run reads it.
        self.schedule = torch.zeros(3, device=device)

    # --- losses: (mb, per-worker memory, its slots, clip, beta) -----------

    def loss_timeline(self, mb, timeline, timeline_slots, clip_range,
                      beta) -> Tuple[torch.Tensor, torch.Tensor]:
        """Projects the timeline once, then each block's attention reads its
        windows from it through the window-attention op."""
        trx = self.config.transformer
        kv = self.model.project_memory_blocks(timeline, timeline_slots)
        pe = self.model.pe_kv_blocks()

        def make_op(i):
            # The kernels are float32: cast at their boundary (the identity
            # under float32).
            tk, tv = (t.float().contiguous() for t in kv[i])
            pk, pv = (t.float().contiguous() for t in pe[i])
            return lambda q: window_attention(
                q.float(), tk, tv, pk, pv, mb["w_idx"], mb["tl_start"],
                mb["tl_n_valid"], mb["tl_s_lo"], mb["memory_mask"],
                trx.num_heads, self.kernel, self.backward_kernel).to(q.dtype)

        logits, value, _ = self.model.forward_with_ops(
            mb["obs"], [make_op(i) for i in range(trx.num_blocks)])
        return loss_from_outputs(logits, value, mb, clip_range, beta,
                                 self.config.value_loss_coefficient)

    def loss_gathered(self, mb, src, src_slots, clip_range,
                      beta) -> Tuple[torch.Tensor, torch.Tensor]:
        """Projects the sources once, then gathers each sample's projected
        K/V window from them."""
        k_src, v_src = self.model.project_memory(src, src_slots)
        w_idx, rows = mb["w_idx"], mb["flat_index"]
        logits, value, _ = self.model.forward_with_kv(
            mb["obs"], gather_windows(k_src, w_idx, rows),
            gather_windows(v_src, w_idx, rows), mb["memory_mask"])
        return loss_from_outputs(logits, value, mb, clip_range, beta,
                                 self.config.value_loss_coefficient)

    def loss_window(self, mb, src, src_slots, clip_range,
                    beta) -> Tuple[torch.Tensor, torch.Tensor]:
        """The model on each sample's raw memory window, gathered from the
        sources (projections inside the model)."""
        del src_slots  # the window's slots are mb["slot"]
        window = gather_windows(src, mb["w_idx"], mb["flat_index"])
        logits, value, _ = self.model(mb["obs"], window, mb["memory_mask"],
                                      mb["slot"])
        return loss_from_outputs(logits, value, mb, clip_range, beta,
                                 self.config.value_loss_coefficient)

    def loss(self, mb, memory, memory_slots, clip_range, beta
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The config's loss: ``loss_timeline`` with
        ``use_pallas_attention``, else ``loss_gathered``."""
        fn = (self.loss_timeline if self.config.use_pallas_attention
              else self.loss_gathered)
        return fn(mb, memory, memory_slots, clip_range, beta)

    # --- batch preparation: (memory, memory_slots, per-sample fields) -----

    def _fields(self, batch: RolloutBatch, **extra):
        L = self.config.transformer.memory_length
        fields = dict(
            obs=batch.obs, actions=batch.actions, log_probs=batch.log_probs,
            values=batch.values, advantages=batch.advantages,
            memory_mask=self.mask_table[batch.episode_steps.clamp(0, L - 1)],
            **extra)
        return {k: v.reshape((-1,) + tuple(v.shape[2:]))
                for k, v in fields.items()}

    def prepare_timeline(self, batch: RolloutBatch):
        """The timeline, its slots and the flattened per-sample fields with
        the window-attention addressing (``tl_*``)."""
        L = self.config.transformer.memory_length
        timeline = build_timeline(batch.snapshot, batch.tape,
                                  batch.episode_steps[:, 0], pad=L)
        timeline_slots = build_timeline_slots(batch.episode_steps,
                                              self.max_ep, pad=L)
        tl = compute_timeline_sources(batch.episode_steps, batch.dones,
                                      self.index_table, L)
        return timeline, timeline_slots, self._fields(
            batch, tl_start=tl.start, tl_n_valid=tl.n_valid, tl_s_lo=tl.s_lo)

    def prepare_gathered(self, batch: RolloutBatch):
        """The sources ``[snapshot | tape | zero PE region]``, their absolute
        episode slots (snapshot and PE rows at their slot, tape rows at the
        episode step they were written) and the flattened per-sample fields
        with the gather indices."""
        W = batch.episode_steps.shape[0]
        sources = compute_window_sources(batch.episode_steps, batch.dones,
                                         self.index_table, self.max_ep)
        src = torch.cat([batch.snapshot, batch.tape,
                         torch.zeros_like(batch.snapshot)], dim=1)
        slot_range = torch.arange(
            self.max_ep, dtype=torch.int32,
            device=src.device)[None].expand(W, -1)
        src_slots = torch.cat([slot_range, batch.episode_steps.int(),
                               slot_range], dim=1)
        return src, src_slots, self._fields(
            batch, flat_index=sources.flat_index, valid=sources.valid,
            slot=sources.slot)

    def prepare(self, batch: RolloutBatch):
        """The config's preparation, for ``loss``."""
        return (self.prepare_timeline(batch)
                if self.config.use_pallas_attention
                else self.prepare_gathered(batch))

    def rank_minibatches(self, mb_indices: torch.Tensor
                         ) -> List[torch.Tensor]:
        """This rank's part of each global minibatch (a row of
        ``mb_indices``, global sample indices ``w * T + t``): the samples of
        its own workers, in the row's order, as rank-local indices; possibly
        none. One host sync for the whole update."""
        T = self.config.worker_steps
        rows = self.mesh.worker_rows(self.config.n_workers)
        lo, hi = rows.start * T, rows.stop * T
        mine = (mb_indices >= lo) & (mb_indices < hi)
        counts = mine.sum(dim=1).tolist()
        first = torch.argsort((~mine).to(torch.int32), dim=1, stable=True)
        local = torch.gather(mb_indices, 1, first) - lo
        return [local[j, :c] for j, c in enumerate(counts)]

    def minibatch(self, fields, idx: torch.Tensor,
                  global_adv: Optional[torch.Tensor] = None):
        """The samples ``idx`` (rank-local indices) of a global minibatch
        whose advantages are ``global_adv`` (by default these samples': the
        whole minibatch on one device), with that minibatch's advantage
        statistics and size for ``loss_from_outputs``."""
        mb = {k: v[idx] for k, v in fields.items()}
        if mb["obs"].dtype == torch.uint8:          # obs_uint8
            mb["obs"] = mb["obs"].float() / 255.0
        mb["w_idx"] = (idx // self.config.worker_steps).to(torch.int32)
        adv = mb["advantages"] if global_adv is None else global_adv
        mb.update(adv_mean=adv.mean(), adv_std=adv.std(), n_global=adv.numel())
        return mb

    def set_schedule(self, learning_rate, clip_range, beta) -> None:
        """Fills ``schedule`` (each value a number or a 0-d tensor on the
        device, rounded to float32) on the device's stream: no host sync."""
        for slot, value in zip(self.schedule, (learning_rate, clip_range,
                                               beta)):
            slot.fill_(value)

    def load_optimizer_state(self, state: Dict) -> None:
        """Loads an optimizer ``state_dict`` written on either device: the
        groups keep this optimizer's ``capturable``, which places the step
        counts (on the parameters' device when capturable)."""
        state = dict(state, param_groups=[
            dict(saved, capturable=group["capturable"]) for saved, group in
            zip(state["param_groups"], self.optimizer.param_groups)])
        self.optimizer.load_state_dict(state)

    def __call__(self, batch: RolloutBatch, learning_rate, clip_range, beta,
                 perms: Optional[torch.Tensor] = None):
        """``set_schedule``, then ``run``."""
        self.set_schedule(learning_rate, clip_range, beta)
        return self.run(batch, perms)

    def run(self, batch: RolloutBatch, perms: Optional[torch.Tensor] = None):
        """Runs epochs x minibatches with the values of ``schedule``.
        ``perms`` (epochs, B) overrides the generator's permutations.
        Returns (mean stats (6,), mean grad-norm groups), as tensors on the
        device. On one device nothing here waits for the device."""
        cfg = self.config
        B = cfg.batch_size
        memory, memory_slots, fields = self.prepare(batch)
        device = memory.device
        if perms is None:
            perms = torch.stack([
                torch.randperm(B, generator=self.generator, device=device)
                for _ in range(cfg.epochs)])
        mb_indices = perms.to(device).reshape(
            cfg.epochs * cfg.n_mini_batch, cfg.mini_batch_size)
        learning_rate, clip_range, beta = self.schedule.unbind()
        for group in self.optimizer.param_groups:
            # A capturable AdamW reads the device tensor in its step.
            group["lr"] = (learning_rate if group["capturable"]
                           else float(learning_rate))

        # The advantages of all workers, in the global sample order, and this
        # rank's part of each minibatch (on one device, all of it).
        if self.mesh is None:
            advantages = batch.advantages.reshape(-1)
            local_indices = list(mb_indices)
        else:
            advantages = self.mesh.gather_workers(
                batch.advantages, "advantages").reshape(-1)
            local_indices = self.rank_minibatches(mb_indices)
        self.rank_samples = [len(i) for i in local_indices]

        stats_sum = torch.zeros(len(STAT_NAMES), device=device)
        groups_sum: Dict[str, torch.Tensor] = {}
        for idx, local_idx in zip(mb_indices, local_indices):
            stats = self._backward(fields, local_idx, advantages[idx], memory,
                                   memory_slots, clip_range, beta)
            clip_grads_torch(self.model, cfg.max_grad_norm)
            for k, v in grad_norm_groups(self.model).items():
                groups_sum[k] = groups_sum.get(k, 0.0) + v
            self.optimizer.step()
            stats_sum += stats
        n = len(mb_indices)
        return stats_sum / n, {k: v / n for k, v in groups_sum.items()}

    def _backward(self, fields, local_idx, global_adv, memory, memory_slots,
                  clip_range, beta) -> torch.Tensor:
        """This rank's part of one global minibatch (``local_idx``, possibly
        empty under a mesh; ``global_adv`` all its advantages): the backward
        of its part of the loss, then, under a mesh, one all-reduce of the
        gradients and the stats. Leaves the (summed) gradients in ``.grad``;
        returns the (summed) stats."""
        self.optimizer.zero_grad(set_to_none=True)
        if local_idx.numel() > 0:
            mb = self.minibatch(fields, local_idx, global_adv)
            loss, stats = self.loss(mb, memory, memory_slots, clip_range,
                                    beta)
            loss.backward()
        else:
            stats = torch.zeros(len(STAT_NAMES), device=memory.device)
        if self.mesh is None:
            return stats
        params = list(self.model.parameters())
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        *summed, stats = all_reduce_flat(grads + [stats], self.mesh,
                                         "gradients")
        for p, g in zip(params, summed):
            p.grad = g
        return stats
