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
  ``grouped_attention`` (the JAX package's ``GROUPED_MODE``) the pair is the
  grouped one: the minibatch sorted by worker, and a backward free of
  atomics. ``pallas_backward`` without ``use_pallas_attention`` warns and
  takes ``loss_gathered``, as in the JAX package. ``PPOUpdate.kernels``
  lists the kernels the update launches.

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
whose worker is its own, in permutation order, with rank-local indices, so
each rank projects only its own workers' timeline or sources and the
kernels see a rank-local timeline. The part has a fixed size
C = min(M, W/N * T), which no global minibatch can exceed, so no sample is
dropped and no shape depends on the data (``rank_parts``): pad rows repeat
the part's real samples in turn (the rank's sample 0 where it has none)
and carry a mask of 0. The loss is the rank's part of the global
minibatch's: its advantages are normalised with the whole minibatch's mean
and unbiased std (from the advantages of all workers, which the caller
gathers once per update with the episode rows: one device's values in one
device's order), every per-sample term is multiplied by the mask before
each sum, and every mean is the rank's sum over the global count
(``loss_from_outputs``). A pad row's upstream gradient is then exactly 0,
and a part with no real sample adds exact zeros. After the backward one
``all_reduce`` of one flat buffer at a fixed address (``mesh.flat_views``:
the gradients are views of it, the six stats follow) sums every gradient
and the stats over the ranks; every rank then clips and steps alike. The
update runs as the segments ``prepare``, then ``part`` and ``step`` with the
all-reduce between them once a minibatch, then ``result``, through a
``Segments`` runner: this module's runs each at once, ``training/fused.py``'s
captures each into a CUDA graph and replays it, with the collectives between
the replays. One device keeps its own body: no mask, no padding.
"""
from __future__ import annotations

import warnings
from typing import (Callable, Dict, List, NamedTuple, Optional, Sequence,
                    Tuple)

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
from ..parallel.mesh import DataMesh, flat_views
from ..utils.profiling import PhaseClock
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
    up to the global minibatch's. With ``mb["mask"]`` (a padded rank part)
    every per-sample term is multiplied by it before the sum. ``clip_range``
    and ``beta`` are numbers or 0-d float32 tensors on the device
    (``PPOUpdate.schedule``)."""
    log_probs, entropies = distributions.log_probs_and_entropies(
        logits, mb["actions"])
    adv = mb["advantages"]
    n = mb["n_global"]
    mask = mb.get("mask")

    def mean(x):
        if mask is not None:
            x = x * mask.reshape((-1,) + (1,) * (x.dim() - 1))
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


class RankParts(NamedTuple):
    """This rank's part of each global minibatch of an update, at the fixed
    size C (``PPOUpdate.rank_parts``)."""
    local: torch.Tensor     # (n, C) int64 rank-local sample indices
    mask: torch.Tensor      # (n, C) float32: 1 a real sample, 0 a pad
    counts: torch.Tensor    # (n,) int64 real samples


class Segments:
    """How an update under a mesh runs: ``segment(name, fn, generators)``
    a part that stays on the device (drawing from ``generators``),
    ``collective(fn)`` one that talks to the other ranks. This runner runs
    both at once; ``training/fused.py``'s graph route captures each segment
    once into a CUDA graph and replays it, with the collectives run between
    the replays."""

    def segment(self, name: str, fn: Callable[[], None],
                generators: Sequence[torch.Generator] = ()) -> None:
        fn()

    def collective(self, fn: Callable[[], None]) -> None:
        fn()


class PPOUpdate:
    """One PPO update of ``model`` from a rollout batch. The per-epoch
    permutations come from ``generator`` unless the caller passes them.
    The config chooses the loss and the window-attention kernels. With a
    ``mesh`` the batch is this rank's workers' rows and the update is the
    global one (see the module's docstring). ``clock`` stamps the phases
    ``ppo_update.prepare`` and every minibatch's ``ppo_update.loss`` and
    ``ppo_update.step`` (``utils/profiling.PhaseClock``)."""

    def __init__(self, config: TrainConfig, model: ActorCriticModel,
                 max_episode_steps: int, generator: torch.Generator,
                 mesh: Optional[DataMesh] = None,
                 clock: Optional[PhaseClock] = None):
        if config.pallas_backward and not config.use_pallas_attention:
            warnings.warn(
                "pallas_backward=True has no effect without "
                "use_pallas_attention=True; the gathered-window loss (plain "
                "PyTorch attention) is used.")
        self.config = config
        self.clock = clock or PhaseClock()
        self.model = model
        self.max_ep = max_episode_steps
        self.generator = generator
        self.mesh = mesh
        # Under a mesh: this rank's real samples in each minibatch of the
        # last update (``rank_samples``), the gradients' flat buffer and
        # its views, the sums of the stats and gradient-norm groups, the
        # prepared update, its result.
        self._counts: Optional[torch.Tensor] = None
        self._flat: Optional[torch.Tensor] = None
        self._grads: List[torch.Tensor] = []
        self._sums: Optional[torch.Tensor] = None
        self._group_keys: List[str] = []
        self._prepared: Dict[str, torch.Tensor] = {}
        self._result = None
        # The window-attention kernels for CUDA tensors (CPU tensors take
        # their plain versions inside the op); no backward kernel means the
        # plain VJP.
        self.kernel, backward_kernel = (
            (window_attention_fwd_grouped, window_attention_bwd_grouped)
            if config.grouped_attention
            else (window_attention_fwd, window_attention_bwd))
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

    @property
    def kernels(self) -> Tuple:
        """The CUDA kernels this update launches: ``kernel`` and
        ``backward_kernel`` as they are now, none where the gathered loss
        runs."""
        if not self.config.use_pallas_attention:
            return ()
        return tuple(k for k in (self.kernel, self.backward_kernel)
                     if k is not None)

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

    @property
    def rank_samples(self) -> List[int]:
        """This rank's real samples in each minibatch of the last update: all
        of them on one device; under a mesh read from the device (a host
        sync)."""
        cfg = self.config
        if self.mesh is None:
            return [cfg.mini_batch_size] * (cfg.epochs * cfg.n_mini_batch)
        return [] if self._counts is None else self._counts.tolist()

    def _rank_span(self) -> Tuple[int, int]:
        """This rank's global sample indices: [lo, hi)."""
        T = self.config.worker_steps
        rows = self.mesh.worker_rows(self.config.n_workers)
        return rows.start * T, rows.stop * T

    def rank_parts(self, mb_indices: torch.Tensor) -> RankParts:
        """This rank's part of each global minibatch (a row of
        ``mb_indices``, global sample indices ``w * T + t``), at the fixed
        size C = min(M, W/N * T), as rank-local indices, on the device, with
        no host read: the samples of its own workers first, in the row's
        order, then pads that repeat them in turn (the rank's sample 0
        where it has none), masked."""
        lo, hi = self._rank_span()
        C = min(mb_indices.shape[1], hi - lo)
        mine = (mb_indices >= lo) & (mb_indices < hi)
        counts = mine.sum(dim=1)
        first = torch.argsort((~mine).to(torch.int32), dim=1,
                              stable=True)[:, :C]
        local = torch.gather(mb_indices, 1, first) - lo
        col = torch.arange(C, device=mb_indices.device)
        real = col[None] < counts[:, None]
        source = torch.where(real, col[None],
                             col[None] % counts.clamp(min=1)[:, None])
        local = torch.where(counts[:, None] > 0,
                            torch.gather(local, 1, source), 0)
        return RankParts(local, real.float(), counts)

    def minibatch(self, fields, idx: torch.Tensor,
                  global_adv: Optional[torch.Tensor] = None,
                  mask: Optional[torch.Tensor] = None):
        """The samples ``idx`` (rank-local indices) of a global minibatch
        whose advantages are ``global_adv`` (by default these samples': the
        whole minibatch on one device), with that minibatch's advantage
        statistics and size for ``loss_from_outputs``, and ``mask`` where
        the part is padded."""
        mb = {k: v[idx] for k, v in fields.items()}
        if mb["obs"].dtype == torch.uint8:          # obs_uint8
            mb["obs"] = mb["obs"].float() / 255.0
        mb["w_idx"] = (idx // self.config.worker_steps).to(torch.int32)
        adv = mb["advantages"] if global_adv is None else global_adv
        mb.update(adv_mean=adv.mean(), adv_std=adv.std(), n_global=adv.numel())
        if mask is not None:
            mb["mask"] = mask
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

    def permutations(self, device) -> torch.Tensor:
        """The update's per-epoch permutations (epochs, B), drawn from
        ``generator``."""
        return torch.stack([
            torch.randperm(self.config.batch_size, generator=self.generator,
                           device=device)
            for _ in range(self.config.epochs)])

    def run(self, batch: RolloutBatch, perms: Optional[torch.Tensor] = None,
            advantages: Optional[torch.Tensor] = None,
            segments: Optional[Segments] = None):
        """Runs epochs x minibatches with the values of ``schedule``.
        ``perms`` (epochs, B) overrides the generator's permutations. Under
        a mesh, ``advantages`` (W, T) are all workers' and the update runs
        through ``segments`` (by default each at once). Returns (mean stats
        (6,), mean grad-norm groups), as tensors on the device. On one
        device nothing here waits for the device."""
        cfg = self.config
        learning_rate, clip_range, beta = self.schedule.unbind()
        for group in self.optimizer.param_groups:
            # A capturable AdamW reads the device tensor in its step.
            group["lr"] = (learning_rate if group["capturable"]
                           else float(learning_rate))
        if self.mesh is not None:
            if advantages is None:
                raise ValueError("under a mesh the update needs the "
                                 "advantages of all workers")
            return self._run_mesh(batch, perms, advantages,
                                  segments or Segments())
        clock = self.clock
        with clock.phase("ppo_update.prepare"):
            memory, memory_slots, fields = self.prepare(batch)
            device = memory.device
            if perms is None:
                perms = self.permutations(device)
            mb_indices = perms.to(device).reshape(
                cfg.epochs * cfg.n_mini_batch, cfg.mini_batch_size)
            advantages = batch.advantages.reshape(-1)
            stats_sum = torch.zeros(len(STAT_NAMES), device=device)
        groups_sum: Dict[str, torch.Tensor] = {}
        for idx in mb_indices:
            with clock.phase("ppo_update.loss"):
                stats = self._backward(fields, idx, advantages[idx], memory,
                                       memory_slots, clip_range, beta)
            with clock.phase("ppo_update.step"):
                clip_grads_torch(self.model, cfg.max_grad_norm)
                for k, v in grad_norm_groups(self.model).items():
                    groups_sum[k] = groups_sum.get(k, 0.0) + v
                self.optimizer.step()
                stats_sum += stats
        n = len(mb_indices)
        return stats_sum / n, {k: v / n for k, v in groups_sum.items()}

    def _backward(self, fields, idx, global_adv, memory, memory_slots,
                  clip_range, beta) -> torch.Tensor:
        """One device: the backward of one minibatch's loss. Leaves the
        gradients in ``.grad``; returns the stats."""
        self.optimizer.zero_grad(set_to_none=True)
        mb = self.minibatch(fields, idx, global_adv)
        loss, stats = self.loss(mb, memory, memory_slots, clip_range, beta)
        loss.backward()
        return stats

    # --- under a mesh: the update in segments --------------------------------

    def _run_mesh(self, batch: RolloutBatch, perms, advantages,
                  segments: Segments):
        cfg = self.config
        segments.segment(
            "prepare", lambda: self._prepare_mesh(batch, perms, advantages),
            (self.generator,))
        for _ in range(cfg.epochs * cfg.n_mini_batch):
            segments.segment("part", self._part_backward)
            segments.collective(
                lambda: self.mesh.all_reduce_(self._flat, "gradients"))
            segments.segment("step", self._part_step)
        segments.segment("result", self._mesh_result)
        return self._result

    def _prepare_mesh(self, batch: RolloutBatch, perms, advantages) -> None:
        """Segment ``prepare``: the loss's inputs, this update's
        permutations and rank parts, the sums zeroed, the minibatch counter
        at 0."""
        cfg = self.config
        with self.clock.phase("ppo_update.prepare"):
            memory, memory_slots, fields = self.prepare(batch)
            device = memory.device
            if perms is None:
                perms = self.permutations(device)
            mb_indices = perms.to(device).reshape(
                cfg.epochs * cfg.n_mini_batch, cfg.mini_batch_size)
            parts = self.rank_parts(mb_indices)
            self._counts = parts.counts
            if self._sums is not None:
                self._sums.zero_()
            self._prepared = dict(
                memory=memory, memory_slots=memory_slots, fields=fields,
                mb_indices=mb_indices, local=parts.local, mask=parts.mask,
                advantages=advantages.reshape(-1),
                j=torch.zeros(1, dtype=torch.int64, device=device))

    def _part_backward(self) -> None:
        """Segment ``part``: this rank's padded part of minibatch j (the
        device counter) into the flat buffer: the gradients of its part of
        the loss, then its stats."""
        with self.clock.phase("ppo_update.loss"):
            p = self._prepared
            if self._flat is None:
                self._flat, self._grads = flat_views(
                    list(self.model.parameters()), len(STAT_NAMES))
            for param, grad in zip(self.model.parameters(), self._grads):
                param.grad = grad       # views of the buffer, accumulated into
            self._flat.zero_()
            j = p["j"]
            idx = p["local"].index_select(0, j)[0]
            global_adv = p["advantages"][p["mb_indices"].index_select(0, j)[0]]
            mb = self.minibatch(p["fields"], idx, global_adv,
                                p["mask"].index_select(0, j)[0])
            _, clip_range, beta = self.schedule.unbind()
            loss, stats = self.loss(mb, p["memory"], p["memory_slots"],
                                    clip_range, beta)
            loss.backward()
            self._flat[-len(STAT_NAMES):].copy_(stats)

    def _part_step(self) -> None:
        """Segment ``step``, on the summed buffer: clip, the gradient-norm
        groups, the AdamW step, the sums; the counter to the next
        minibatch."""
        with self.clock.phase("ppo_update.step"):
            clip_grads_torch(self.model, self.config.max_grad_norm)
            groups = grad_norm_groups(self.model)
            self.optimizer.step()
            sums = torch.cat([self._flat[-len(STAT_NAMES):],
                              torch.stack([groups[k]
                                           for k in sorted(groups)])])
            if self._sums is None:
                self._sums = torch.zeros_like(sums)
                self._group_keys = sorted(groups)
            self._sums += sums
            self._prepared["j"] += 1

    def _mesh_result(self) -> None:
        """Segment ``result``: the means over the minibatches."""
        n = self.config.epochs * self.config.n_mini_batch
        means = self._sums / n
        k = len(STAT_NAMES)
        self._result = (means[:k], {key: means[k + i] for i, key in
                                    enumerate(self._group_keys)})
