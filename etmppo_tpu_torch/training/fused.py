"""Fused multi-update launches
(counterpart of ``etmppo_tpu/training/fused.py``).

The JAX package compiles a chunk of K whole updates (rollout scan, GAE,
epochs x minibatches, AdamW) into one device program; the host only supplies
each update's schedule values and drains two packed arrays a chunk
(``ChunkOutputs``). Here one update is a body written against persistent
state: the parameters and the optimizer state, updated in place; the rollout
state (``RolloutState``) in fixed buffers, which the body writes back with
``copy_`` at its end; the learning rate, clip range and entropy coefficient
as ``PPOUpdate.schedule``, three float32 values on the device; the outputs
in fixed buffers. A chunk runs that body K times, in one of two routes:

* ``graph`` (CUDA): the loop's first update runs eagerly on the capture
  stream as the warm-up (cuDNN and cuBLAS handles, the kernels'
  shared-memory attributes, AdamW's lazily created state); right after it,
  in the same launch, the update is captured, so the first launch carries
  the warm-up and the capture as the JAX package's carries the
  compilation. Every later update copies its row of the chunk's (K, 3)
  schedule into ``PPOUpdate.schedule``, replays and copies the output
  buffers into row k of the chunk's outputs on the device. Nothing inside a
  chunk waits for the device. The generators that a capture draws from are
  registered with its graph, so a replay draws what an eager update would
  and advances them as far (``get_state`` shows it, and checkpoints save
  it). A capture or a replay that fails raises. Nothing in the body may
  copy host data to the device or wait for it.

  On one device the capture is one CUDA graph of the whole update. Under a
  mesh a capture cannot hold a collective (gloo's least of all, which
  copies through the host), so ``mesh_update`` runs the update as segments
  that share one memory pool, with the collectives run eagerly between
  their replays, on the replays' stream (NCCL's stream and gloo's copies
  wait for it): ``rollout`` (the rollout and GAE, and the rows of this
  rank's dones, values, advantages and episode infos packed), the one
  gather of those rows of all workers, ``prepare`` (``PPOUpdate``: the
  loss's inputs, the permutations, this rank's padded parts), then per
  minibatch ``part`` (its forward and backward into the flat gradient
  buffer), the all-reduce of that buffer and ``step`` (clip, gradient-norm
  groups, AdamW), then ``result`` and ``outputs`` (the chunk's rows, the
  parameters' replica digest, the rollout state written back). ``part``
  and ``step`` are captured once and replayed epochs x minibatches times; a
  device counter picks the minibatch. Tensors that pass from one segment to
  the next stay where the capture put them. The info keys are fixed at the
  warm-up (a device env's are static; a change raises).
* ``eager``: the same body run K times, taken on the CPU (no CUDA graphs)
  and under ``--debug-nans`` (its checks run on the host). ``choose_route``
  says which and why.

Either way a chunk is K calls of ``PPOTrainer.train_one_update``: the same
draws, the same arithmetic, the same logged values. Under a mesh every
update writes its parameters' ``replica_digest`` into row k of a (K, 2)
buffer, and the chunk's end gathers them once and raises naming the first
update whose digests differ between the ranks (``check_replicated``).

The window-attention wrappers and an env's kernels (Mystery Path Grid's
and Mortar Mayhem Grid's resets) count their launches in Python, which a replay does not run. The loop
takes each kernel's launches during a capture, takes them back afterwards (a
capture runs nothing), and adds them at every replay, so the counts stay the
number of kernels that ran; ``capture`` keeps the env's reset kernel's
(``reset_launches``) and each window-attention kernel's by its symbol
(``attention_launches``) in a captured update. The
collectives run between the replays, so the mesh's traffic counts are true.
"""
from __future__ import annotations

import ctypes
import types
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..ops.window_attention import (window_attention_bwd,
                                    window_attention_bwd_grouped,
                                    window_attention_fwd,
                                    window_attention_fwd_grouped)
from ..parallel.mesh import DataMesh, check_replicated, replica_digest
from ..utils.profiling import PhaseClock
from ..utils.runtime import debug_nans_enabled, nan_errors
from .ppo import PPOUpdate, Segments
from .rollout import RolloutBatch, RolloutFn, RolloutState

# The window-attention kernels' symbols, which ``capture["attention_launches"]``
# counts: the per-sample pair and the grouped pair.
ATTENTION_SYMBOLS = tuple(k.symbol for k in (
    window_attention_fwd, window_attention_bwd, window_attention_fwd_grouped,
    window_attention_bwd_grouped))


class ChunkOutputs(NamedTuple):
    """Per-update outputs of a chunk, packed into two device arrays so that
    a chunk costs two device-to-host copies.

    scalars[k] = [stats (6) | grad norms (sorted keys) | value_mean |
    advantage_mean]; per_step[k] = [dones | episode info values (sorted
    keys)] as (1 + I, W, T)."""
    scalars: torch.Tensor   # (K, 6 + G + 2)
    per_step: torch.Tensor  # (K, 1 + I, W, T)
    grad_keys: Tuple[str, ...]
    info_keys: Tuple[str, ...]


def choose_route(device: torch.device, mesh: Optional[DataMesh]
                 ) -> Tuple[str, str]:
    """The route of a trainer's fused launches on ``device``, and why."""
    if device.type != "cuda":
        return "eager", "the CPU has no CUDA graphs"
    if debug_nans_enabled():
        return "eager", "--debug-nans checks the values on the host"
    if mesh is not None:
        return "graph", ("CUDA graphs of an update's segments, replayed, "
                         "with the collectives between them")
    return "graph", "one CUDA graph of a whole update, replayed"


def episode_rows(batch: RolloutBatch, keys: Tuple[str, ...]) -> torch.Tensor:
    """(workers, 3 + I, T): the batch's dones, values, advantages and the
    episode infos of ``keys`` (zeros for a key the batch lacks)."""
    zeros = torch.zeros_like(batch.values)
    return torch.stack([batch.dones.float(), batch.values,
                        batch.advantages] + [
        batch.episode_infos.get(k, zeros).float() for k in keys], dim=1)


def state_tensors(state: RolloutState) -> List[torch.Tensor]:
    """A rollout state's tensors: the env state's fields, the obs, the
    episode step and the memory."""
    return [*state.env_state, state.obs, state.episode_step, state.memory]


def run_update(rollout_fn: RolloutFn, update_fn: PPOUpdate,
               mesh: Optional[DataMesh], state):
    """One update from ``state`` with the values of ``update_fn.schedule``,
    run at once: the rollout and the PPO update, the phases ``rollout`` and
    ``ppo_update`` of ``update_fn.clock`` (which opens ``update`` first and
    ``outputs`` last; the caller closes both after its write-back); under a
    mesh ``mesh_update``. Returns the rollout state after it, its scalars
    (6 + G + 2,) and its per-step rows (1 + I, W, T), packed as
    ``ChunkOutputs``' rows, their grad and info keys, and under a mesh the
    parameters' replica digest (None on one device)."""
    if mesh is not None:
        return mesh_update(rollout_fn, update_fn, mesh, state, Segments(),
                           mesh_slots())
    clock = update_fn.clock
    clock.stamp(opens=("update",))
    with clock.phase("rollout"):
        final, batch = rollout_fn(state)
    with clock.phase("ppo_update"), nan_errors():
        stats, grad_info = update_fn.run(batch)
    clock.stamp(opens=("outputs",))
    grad_keys = tuple(sorted(grad_info))
    info_keys = tuple(sorted(batch.episode_infos))
    scalars = torch.cat([
        stats, torch.stack([grad_info[k] for k in grad_keys]),
        batch.values.mean()[None], batch.advantages.mean()[None]])
    per_step = torch.stack([batch.dones.float()]
                           + [batch.episode_infos[k].float()
                              for k in info_keys])
    return final, scalars, per_step, grad_keys, info_keys, None


def mesh_slots() -> types.SimpleNamespace:
    """Where ``mesh_update`` keeps the tensors that pass from one segment
    to the next, and the info keys once fixed."""
    return types.SimpleNamespace(info_keys=None, global_rows=None)


def mesh_update(rollout_fn, update_fn: PPOUpdate, mesh: DataMesh, state,
                segments: Segments, slots: types.SimpleNamespace,
                write_back: bool = False):
    """One update of this rank under a mesh, as segments and collectives
    (the module's docstring), run through ``segments``; ``slots`` keeps
    what passes between them. Without fixed info keys, the keys are the
    union of the ranks' (a host env's infos may carry keys only some ranks
    saw), gathered on the host, and become fixed. With ``write_back`` the
    rollout state after the update is copied into ``state``'s tensors and
    ``state`` is returned. The clock's phases ``rollout``, ``ppo_update`` and
    ``outputs`` and the update's open and close are stamped between the
    segments, on their stream. Returns what ``run_update`` returns."""
    clock = update_fn.clock

    def rollout():
        slots.final, slots.batch = rollout_fn(state)
        if slots.info_keys is not None:
            keys = tuple(sorted(slots.batch.episode_infos))
            if keys != slots.info_keys:
                raise RuntimeError(f"the episode info keys changed from "
                                   f"{slots.info_keys} to {keys}")
            slots.rows = episode_rows(slots.batch, slots.info_keys)
    clock.stamp(opens=("update",))
    with clock.phase("rollout"):
        segments.segment("rollout", rollout, (rollout_fn.generator,))
    if slots.info_keys is None:
        slots.info_keys = tuple(sorted(set().union(*mesh.all_gather_object(
            sorted(slots.batch.episode_infos)))))
        slots.rows = episode_rows(slots.batch, slots.info_keys)

    def gather():
        # The rows of all workers, in one device's order: the advantages
        # for the update's statistics, the rest for the log.
        slots.global_rows = mesh.gather_workers(slots.rows, "advantages",
                                                out=slots.global_rows)
    segments.collective(gather)
    with clock.phase("ppo_update"), nan_errors():
        stats, grad_info = update_fn.run(
            slots.batch, advantages=slots.global_rows[:, 2],
            segments=segments)
    grad_keys = tuple(sorted(grad_info))

    def outputs():
        rows = slots.global_rows
        slots.scalars = torch.cat([
            stats, torch.stack([grad_info[k] for k in grad_keys]),
            rows[:, 1].mean()[None], rows[:, 2].mean()[None]])
        slots.per_step = torch.stack(
            [rows[:, 0]] + [rows[:, 3 + i]
                            for i in range(len(slots.info_keys))])
        slots.digest = replica_digest(list(update_fn.model.parameters()))
        if write_back:
            for buffer, value in zip(state_tensors(state),
                                     state_tensors(slots.final)):
                buffer.copy_(value)
    with clock.phase("outputs"):
        segments.segment("outputs", outputs)
    clock.stamp(closes=("update",))
    return (state if write_back else slots.final, slots.scalars,
            slots.per_step, grad_keys, slots.info_keys, slots.digest)


def graph_nodes(graph: torch.cuda.CUDAGraph) -> int:
    """The nodes of a captured graph (``keep_graph=True``), from
    ``cuGraphGetNodes`` in libcuda."""
    count = ctypes.c_size_t(0)
    err = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes(
        ctypes.c_void_p(graph.raw_cuda_graph()), None, ctypes.byref(count))
    if err != 0:
        raise RuntimeError(f"cuGraphGetNodes failed: CUDA error {err}")
    return count.value


class FusedTrainLoop(Segments):
    """Runs chunks of whole updates of ``rollout_fn`` and ``update_fn`` on
    ``route`` (``choose_route``); with a ``mesh``, this rank's part of
    them, and the loop is the ``Segments`` runner of ``mesh_update``. After
    a capture, ``capture`` holds its seconds and the instantiation's (the
    clock's spans ``launch.capture`` and ``launch.instantiate``), the
    graph's nodes, the bytes its memory pool reserved, the env's reset
    kernel launches it holds (``reset_launches``) and each window-attention
    kernel's launches by symbol (``attention_launches``); under a mesh
    their sums over the segments, and each segment's in ``segments``. The
    loop runs the clock's spans ``launch.warm_up`` and ``launch.replays``
    and, after each update, ``clock.store``; ``clock`` is the update's
    (``update_fn.clock``)."""

    def __init__(self, rollout_fn: RolloutFn, update_fn: PPOUpdate,
                 route: str = "eager", mesh: Optional[DataMesh] = None):
        if route not in ("graph", "eager"):
            raise ValueError(
                f"route must be 'graph' or 'eager', got {route!r}")
        self.rollout_fn = rollout_fn
        self.update_fn = update_fn
        self.clock: PhaseClock = (update_fn.clock if update_fn is not None
                                  else PhaseClock())
        self.route = route
        self.mesh = mesh
        self.grad_keys: Tuple[str, ...] = ()
        self.info_keys: Tuple[str, ...] = ()
        self.capture: Dict = {}
        self.reset()

    def reset(self) -> None:
        """Forgets the graphs and their buffers: the next update warms up
        and captures anew. Needed after the optimizer's state is replaced
        (``load_state_dict`` makes new tensors)."""
        self._graph = None
        self._stream = None
        self._state: Optional[RolloutState] = None
        self._outputs: Optional[Tuple[torch.Tensor, ...]] = None
        self._replay_launches: Dict = {}
        # Under a mesh: the segments' graphs, their pool, the launches of
        # each, what passes between them, and how ``segment`` runs one.
        self._graphs: Dict[str, torch.cuda.CUDAGraph] = {}
        self._pool = None
        self._segment_launches: Dict[str, Dict] = {}
        self._slots = mesh_slots()
        self._mode = "eager"

    def body(self, state: RolloutState):
        """One update from ``state``: (the rollout state after it, its
        scalars, its per-step rows[, its replica digest under a mesh])."""
        if self.mesh is not None:
            return self._mesh_body(state)
        final, scalars, per_step, self.grad_keys, self.info_keys, _ = (
            run_update(self.rollout_fn, self.update_fn, None, state))
        return final, scalars, per_step

    def _mesh_body(self, state: RolloutState, write_back: bool = False):
        final, scalars, per_step, self.grad_keys, self.info_keys, digest = (
            mesh_update(self.rollout_fn, self.update_fn, self.mesh, state,
                        self, self._slots, write_back))
        return final, scalars, per_step, digest

    def __call__(self, state: RolloutState, schedule: np.ndarray
                 ) -> Tuple[RolloutState, ChunkOutputs]:
        """Runs ``len(schedule)`` updates from ``state``; row k of
        ``schedule`` is update k's (learning rate, clip range, beta).
        Returns the rollout state after them (on the graph route, the
        loop's buffers) and the chunk's outputs on the device. Under a mesh
        the chunk ends with the replica check."""
        schedule = torch.as_tensor(np.asarray(schedule, np.float32)).to(
            self.update_fn.schedule.device)            # one copy a chunk
        K = len(schedule)
        chunk: List[torch.Tensor] = []
        for k, values in enumerate(schedule):
            self.update_fn.schedule.copy_(values)
            if self.route == "eager":
                state, *outputs = self.body(state)
                self._store(chunk, k, K, *outputs)
                self._close_update()
            elif self._graph is None and not self._graphs:
                with self.clock.span("launch.warm_up"):
                    state = self._warm_up(state, chunk, k, K)
                    torch.cuda.synchronize(self.update_fn.schedule.device)
                self._capture()
            else:
                with self.clock.span("launch.replays"):
                    state = self._adopt(state)
                    self._store(chunk, k, K, *self._replay())
            self.clock.store(k, K)
        if self.mesh is not None:
            check_replicated(chunk[2], self.mesh)
        return state, ChunkOutputs(chunk[0], chunk[1], self.grad_keys,
                                   self.info_keys)

    @staticmethod
    def _store(chunk: list, k: int, K: int, *outputs) -> None:
        """Copies update k's outputs into row k of the chunk's arrays."""
        if not chunk:
            chunk += [x.new_empty((K,) + tuple(x.shape)) for x in outputs]
        for rows, x in zip(chunk, outputs):
            rows[k].copy_(x)

    def _close_update(self) -> None:
        """On one device, the clock's ``outputs`` and ``update`` close after
        the write-back (``mesh_update`` closes its own)."""
        if self.mesh is None:
            self.clock.stamp(closes=("outputs", "update"))

    # --- the graph route --------------------------------------------------

    def _warm_up(self, state: RolloutState, chunk: list, k: int, K: int
                 ) -> RolloutState:
        """The first update, eager on the capture stream; its result
        becomes the rollout state's buffers."""
        device = self.update_fn.schedule.device
        self._stream = torch.cuda.Stream(device)
        self._stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(self._stream):
            final, *outputs = self.body(state)
            self._state = type(final)(*(
                type(final.env_state)(*(t.clone(memory_format=torch
                                                .contiguous_format)
                                        for t in final.env_state)),
                *(t.clone(memory_format=torch.contiguous_format)
                  for t in final[1:])))
            if self.mesh is None:
                self._outputs = tuple(torch.empty_like(x) for x in outputs)
            self._store(chunk, k, K, *outputs)
            self._close_update()
        torch.cuda.current_stream(device).wait_stream(self._stream)
        return self._state

    def _graph_body(self) -> None:
        final, scalars, per_step = self.body(self._state)
        for buffer, value in zip(state_tensors(self._state),
                                 state_tensors(final)):
            buffer.copy_(value)
        self._outputs[0].copy_(scalars)
        self._outputs[1].copy_(per_step)
        self._close_update()

    def _kernels(self) -> list:
        """The CUDA kernels whose launches a capture moves to the replays:
        the update's window-attention pair and the env's (its reset)."""
        upd = self.update_fn
        return ([k for k in {upd.kernel, upd.backward_kernel}
                 if k is not None] + list(self.rollout_fn.env.kernels))

    def _reset_launches(self, launches: Dict) -> int:
        """Of a capture's kernel ``launches``, the env's reset kernel's."""
        return launches.get(self.rollout_fn.env.reset_kernel, 0)

    def _attention_launches(self, launches: Dict) -> Dict[str, int]:
        """Of a capture's kernel ``launches``, each window-attention
        kernel's by symbol (0 for a kernel the update does not take)."""
        counts = dict.fromkeys(ATTENTION_SYMBOLS, 0)
        upd = self.update_fn
        for kernel in (upd.kernel, upd.backward_kernel):
            if kernel is not None:
                counts[kernel.symbol] = launches.get(kernel, 0)
        return counts

    def _capture(self) -> None:
        if self.mesh is not None:
            self._capture_segments()
            return
        device = self.update_fn.schedule.device
        upd = self.update_fn
        kernels = self._kernels()
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        for generator in (self.rollout_fn.generator, upd.generator):
            graph.register_generator_state(generator)
        before = {kernel: kernel.launches for kernel in kernels}
        # The gradients the graph's backward makes come from its pool.
        upd.optimizer.zero_grad(set_to_none=True)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(device)
        with self.clock.span("launch.capture", always=True) as captured:
            with torch.cuda.graph(graph, stream=self._stream):
                self._graph_body()
        with self.clock.span("launch.instantiate", always=True) as built:
            graph.instantiate()
            torch.cuda.synchronize(device)
        # A capture launches nothing: its counts move to every replay.
        self._replay_launches = {kernel: kernel.launches - n
                                 for kernel, n in before.items()}
        self.capture = dict(
            capture_s=captured.seconds, instantiate_s=built.seconds,
            nodes=graph_nodes(graph),
            pool_bytes=torch.cuda.memory_reserved(device) - reserved,
            reset_launches=self._reset_launches(self._replay_launches),
            attention_launches=self._attention_launches(
                self._replay_launches))
        for kernel, n in before.items():
            kernel.launches = n
        self._graph = graph

    def _capture_segments(self) -> None:
        """Under a mesh: each segment of ``mesh_update`` captured once, into
        graphs that share one pool, the collectives skipped (a capture runs
        nothing)."""
        self.capture = {"segments": {}}
        self._mode = "capture"
        try:
            self._mesh_body(self._state, write_back=True)
        finally:
            self._mode = "eager"
        segments = self.capture["segments"].values()
        for key in ("capture_s", "instantiate_s", "nodes", "pool_bytes",
                    "reset_launches"):
            self.capture[key] = sum(c[key] for c in segments)
        self.capture["attention_launches"] = {
            symbol: sum(c["attention_launches"][symbol] for c in segments)
            for symbol in ATTENTION_SYMBOLS}

    def segment(self, name: str, fn, generators=()) -> None:
        """Runs segment ``name`` of ``mesh_update``: at once (eager, the
        warm-up), captured (the first time it comes in a capture), or
        replayed."""
        if self._mode == "eager":
            fn()
        elif self._mode == "capture":
            if name not in self._graphs:
                self._capture_segment(name, fn, generators)
        else:
            self._graphs[name].replay()
            for kernel, n in self._segment_launches[name].items():
                kernel.launches += n

    def collective(self, fn) -> None:
        if self._mode != "capture":
            fn()

    def _capture_segment(self, name: str, fn, generators) -> None:
        device = self.update_fn.schedule.device
        kernels = self._kernels()
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        for generator in generators:
            graph.register_generator_state(generator)
        before = {kernel: kernel.launches for kernel in kernels}
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(device)
        with self.clock.span("launch.capture", always=True) as captured:
            # thread_local: the process group's own threads (NCCL's
            # watchdog) may query the device while this thread captures.
            with torch.cuda.graph(graph, pool=self._pool,
                                  stream=self._stream,
                                  capture_error_mode="thread_local"):
                fn()
        with self.clock.span("launch.instantiate", always=True) as built:
            graph.instantiate()
            torch.cuda.synchronize(device)
        self._segment_launches[name] = {kernel: kernel.launches - n
                                        for kernel, n in before.items()}
        self.capture["segments"][name] = dict(
            capture_s=captured.seconds, instantiate_s=built.seconds,
            nodes=graph_nodes(graph),
            pool_bytes=torch.cuda.memory_reserved(device) - reserved,
            reset_launches=self._reset_launches(
                self._segment_launches[name]),
            attention_launches=self._attention_launches(
                self._segment_launches[name]))
        for kernel, n in before.items():
            kernel.launches = n
        if self._pool is None:
            self._pool = graph.pool()
        self._graphs[name] = graph

    def _adopt(self, state: RolloutState) -> RolloutState:
        """The buffers, holding ``state`` (copied in unless it is them, as
        after a ``train_one_update``)."""
        if state is not self._state:
            for buffer, value in zip(state_tensors(self._state),
                                     state_tensors(state)):
                buffer.copy_(value)
        return self._state

    def _replay(self) -> Tuple[torch.Tensor, ...]:
        """Replays the update; returns its outputs (under a mesh the
        ``outputs`` segment's, where the capture put them)."""
        if self.mesh is not None:
            self._mode = "replay"
            try:
                _, *outputs = self._mesh_body(self._state, write_back=True)
            finally:
                self._mode = "eager"
            return tuple(outputs)
        self._graph.replay()
        for kernel, n in self._replay_launches.items():
            kernel.launches += n
        return self._outputs
