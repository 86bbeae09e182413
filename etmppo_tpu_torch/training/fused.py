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

* ``graph`` (one CUDA device): the loop's first update runs eagerly on the
  capture stream as the warm-up (cuDNN and cuBLAS handles, the kernels'
  shared-memory attributes, AdamW's lazily created state); right after it,
  in the same launch, ``torch.cuda.graph`` captures the body once, so the
  first launch carries the warm-up and the capture as the JAX package's
  carries the compilation. Every later update copies its row of the
  chunk's (K, 3) schedule into ``PPOUpdate.schedule``, replays the graph
  and copies the output buffers into row k of the chunk's outputs on the
  device. Nothing inside a chunk waits for the device. The rollout's and
  the update's generators are registered with the graph, so a replay draws
  what an eager update would and advances them as far (``get_state`` shows
  it, and checkpoints save it). A capture or a replay that fails raises.
  Nothing in the body may copy host data to the device or wait for it.
* ``eager``: the same body run K times, taken on the CPU (no CUDA graphs),
  under a mesh (``PPOUpdate.rank_minibatches`` sizes each rank's part on the
  host, and gloo is not capturable) and under ``--debug-nans`` (its checks
  run on the host). ``choose_route`` says which and why.

Either way a chunk is K calls of ``PPOTrainer.train_one_update``: the same
draws, the same arithmetic, the same logged values.

The window-attention wrappers count their launches in Python, which a
replay does not run. The loop takes each kernel's launches during the
capture, takes them back afterwards (a capture runs nothing), and adds them
at every replay, so the counts stay the number of kernels that ran.
"""
from __future__ import annotations

import ctypes
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..parallel.mesh import DataMesh, check_replicated
from ..utils.profiling import annotate
from ..utils.runtime import debug_nans_enabled, nan_errors
from .ppo import PPOUpdate
from .rollout import RolloutBatch, RolloutFn, RolloutState


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
    if mesh is not None:
        return "eager", ("under a mesh: each rank's part of a minibatch is "
                         "sized on the host, and gloo is not capturable")
    if debug_nans_enabled():
        return "eager", "--debug-nans checks the values on the host"
    return "graph", "one CUDA graph of a whole update, replayed"


def global_rows(batch: RolloutBatch, mesh: Optional[DataMesh]):
    """The dones, episode infos, values and advantages of all workers: the
    batch's own on one device; under a mesh, every rank's rows gathered in
    one call (the infos' keys are the union of the ranks' keys: a host env's
    infos may carry keys only some ranks saw)."""
    if mesh is None:
        return (batch.dones, batch.episode_infos, batch.values,
                batch.advantages)
    keys = sorted(set().union(*mesh.all_gather_object(
        sorted(batch.episode_infos))))
    zeros = torch.zeros_like(batch.values)
    rows = torch.stack([batch.dones.float(), batch.values,
                        batch.advantages] + [
        batch.episode_infos.get(k, zeros).float() for k in keys], dim=1)
    rows = mesh.gather_workers(rows, "episode rows")
    return (rows[:, 0].bool(), {k: rows[:, 3 + i] for i, k in enumerate(keys)},
            rows[:, 1], rows[:, 2])


def state_tensors(state: RolloutState) -> List[torch.Tensor]:
    """A rollout state's tensors: the env state's fields, the obs, the
    episode step and the memory."""
    return [*state.env_state, state.obs, state.episode_step, state.memory]


def run_update(rollout_fn: RolloutFn, update_fn: PPOUpdate,
               mesh: Optional[DataMesh], state):
    """One update from ``state`` with the values of ``update_fn.schedule``:
    the rollout (the spans ``rollout`` and ``ppo_update`` of a profiler
    trace), the PPO update and, under a mesh, the replica check. Returns
    the rollout state after it, its scalars (6 + G + 2,) and its per-step
    rows (1 + I, W, T), packed as ``ChunkOutputs``' rows, and their grad and
    info keys."""
    with annotate("rollout"):
        final, batch = rollout_fn(state)
    with annotate("ppo_update"), nan_errors():
        stats, grad_info = update_fn.run(batch)
    if mesh is not None:
        check_replicated(list(update_fn.model.parameters()), mesh,
                         "after an update")
    dones, infos, values, advantages = global_rows(batch, mesh)
    grad_keys, info_keys = tuple(sorted(grad_info)), tuple(sorted(infos))
    scalars = torch.cat([
        stats, torch.stack([grad_info[k] for k in grad_keys]),
        values.mean()[None], advantages.mean()[None]])
    per_step = torch.stack([dones.float()]
                           + [infos[k].float() for k in info_keys])
    return final, scalars, per_step, grad_keys, info_keys


def graph_nodes(graph: torch.cuda.CUDAGraph) -> int:
    """The nodes of a captured graph (``keep_graph=True``), from
    ``cuGraphGetNodes`` in libcuda."""
    count = ctypes.c_size_t(0)
    err = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes(
        ctypes.c_void_p(graph.raw_cuda_graph()), None, ctypes.byref(count))
    if err != 0:
        raise RuntimeError(f"cuGraphGetNodes failed: CUDA error {err}")
    return count.value


class FusedTrainLoop:
    """Runs chunks of whole updates of ``rollout_fn`` and ``update_fn`` on
    ``route`` (``choose_route``); with a ``mesh``, this rank's part of
    them. After a capture, ``capture`` holds its seconds, the instantiation's
    seconds, the graph's nodes and the bytes its memory pool reserved."""

    def __init__(self, rollout_fn: RolloutFn, update_fn: PPOUpdate,
                 route: str = "eager", mesh: Optional[DataMesh] = None):
        if route not in ("graph", "eager"):
            raise ValueError(
                f"route must be 'graph' or 'eager', got {route!r}")
        if route == "graph" and mesh is not None:
            raise ValueError("the graph route runs on one device")
        self.rollout_fn = rollout_fn
        self.update_fn = update_fn
        self.route = route
        self.mesh = mesh
        self.grad_keys: Tuple[str, ...] = ()
        self.info_keys: Tuple[str, ...] = ()
        self.capture: Dict[str, float] = {}
        self.reset()

    def reset(self) -> None:
        """Forgets the graph and its buffers: the next update warms up and
        captures anew. Needed after the optimizer's state is replaced
        (``load_state_dict`` makes new tensors)."""
        self._graph = None
        self._stream = None
        self._state: Optional[RolloutState] = None
        self._outputs: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        self._replay_launches: Dict = {}

    def body(self, state: RolloutState):
        """One update from ``state`` (``run_update``): (the rollout state
        after it, its scalars, its per-step rows)."""
        final, scalars, per_step, self.grad_keys, self.info_keys = run_update(
            self.rollout_fn, self.update_fn, self.mesh, state)
        return final, scalars, per_step

    def __call__(self, state: RolloutState, schedule: np.ndarray
                 ) -> Tuple[RolloutState, ChunkOutputs]:
        """Runs ``len(schedule)`` updates from ``state``; row k of
        ``schedule`` is update k's (learning rate, clip range, beta).
        Returns the rollout state after them (on the graph route, the
        loop's buffers) and the chunk's outputs on the device."""
        schedule = torch.as_tensor(np.asarray(schedule, np.float32)).to(
            self.update_fn.schedule.device)            # one copy a chunk
        chunk: List[torch.Tensor] = []
        for k, values in enumerate(schedule):
            self.update_fn.schedule.copy_(values)
            if self.route == "eager":
                state, scalars, per_step = self.body(state)
                self._store(chunk, k, len(schedule), scalars, per_step)
            elif self._graph is None:
                state = self._warm_up(state, chunk, k, len(schedule))
                self._capture()
            else:
                state = self._adopt(state)
                self._replay()
                self._store(chunk, k, len(schedule), *self._outputs)
        return state, ChunkOutputs(chunk[0], chunk[1], self.grad_keys,
                                   self.info_keys)

    @staticmethod
    def _store(chunk: list, k: int, K: int, scalars, per_step) -> None:
        """Copies update k's outputs into row k of the chunk's arrays."""
        if not chunk:
            chunk += [scalars.new_empty((K,) + tuple(scalars.shape)),
                      per_step.new_empty((K,) + tuple(per_step.shape))]
        chunk[0][k].copy_(scalars)
        chunk[1][k].copy_(per_step)

    # --- the graph route --------------------------------------------------

    def _warm_up(self, state: RolloutState, chunk: list, k: int, K: int
                 ) -> RolloutState:
        """The first update, eager on the capture stream; its result
        becomes the rollout state's buffers."""
        device = self.update_fn.schedule.device
        self._stream = torch.cuda.Stream(device)
        self._stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(self._stream):
            final, scalars, per_step = self.body(state)
            self._state = type(final)(*(
                type(final.env_state)(*(t.clone(memory_format=torch
                                                .contiguous_format)
                                        for t in final.env_state)),
                *(t.clone(memory_format=torch.contiguous_format)
                  for t in final[1:])))
            self._outputs = (torch.empty_like(scalars),
                             torch.empty_like(per_step))
            self._store(chunk, k, K, scalars, per_step)
        torch.cuda.current_stream(device).wait_stream(self._stream)
        return self._state

    def _graph_body(self) -> None:
        final, scalars, per_step = self.body(self._state)
        for buffer, value in zip(state_tensors(self._state),
                                 state_tensors(final)):
            buffer.copy_(value)
        self._outputs[0].copy_(scalars)
        self._outputs[1].copy_(per_step)

    def _capture(self) -> None:
        device = self.update_fn.schedule.device
        upd = self.update_fn
        kernels = [k for k in {upd.kernel, upd.backward_kernel}
                   if k is not None]
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        for generator in (self.rollout_fn.generator, upd.generator):
            graph.register_generator_state(generator)
        before = {kernel: kernel.launches for kernel in kernels}
        # The gradients the graph's backward makes come from its pool.
        upd.optimizer.zero_grad(set_to_none=True)
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(device)
        t = time.perf_counter()
        with torch.cuda.graph(graph, stream=self._stream):
            self._graph_body()
        captured = time.perf_counter()
        graph.instantiate()
        torch.cuda.synchronize(device)
        self.capture = dict(
            capture_s=captured - t,
            instantiate_s=time.perf_counter() - captured,
            nodes=graph_nodes(graph),
            pool_bytes=torch.cuda.memory_reserved(device) - reserved)
        # A capture launches nothing: its counts move to every replay.
        self._replay_launches = {kernel: kernel.launches - n
                                 for kernel, n in before.items()}
        for kernel, n in before.items():
            kernel.launches = n
        self._graph = graph

    def _adopt(self, state: RolloutState) -> RolloutState:
        """The buffers, holding ``state`` (copied in unless it is them, as
        after a ``train_one_update``)."""
        if state is not self._state:
            for buffer, value in zip(state_tensors(self._state),
                                     state_tensors(state)):
                buffer.copy_(value)
        return self._state

    def _replay(self) -> None:
        self._graph.replay()
        for kernel, n in self._replay_launches.items():
            kernel.launches += n
