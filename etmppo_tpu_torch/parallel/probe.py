"""Rank functions that train through ``PPOTrainer`` and return what a check
of a data-parallel run needs, on the CPU: the stats, the parameters and
their digests after each update or fused launch, rows of the first
update's batch, the actions its rollout drew and their Gumbel-max margins,
each kernel's launches, the seconds of each rollout and PPO update (or of
each launch), and the collectives' traffic.

``tests/test_torch_data_parallel.py``, ``tests/test_torch_fused_mesh.py``
and chip_smoke.py's data-parallel phases start ``train`` and
``fused_against_eager`` with ``mesh.spawn`` (a spawned rank imports them
from the package) and call ``train`` with no mesh for the one-device run
they compare with. ``Replay`` hands a run actions and draws made elsewhere
(the JAX package's, or the one-device run's), through the rollout's and the
update's seams. ``fused_against_eager`` holds a rank's fused launches to
its eager ones to the bit; on the CPU ``StandInGraphs`` runs the graph
route there. ``check_global_moments`` is one process of a multi-process
check of ``multihost``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import tempfile
import time
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..config import TrainConfig
from ..ops import distributions
from ..ops import window_attention as wa
from ..training import fused as fused_lib
from ..training.fused import FusedTrainLoop, state_tensors
from ..training.trainer import PPOTrainer
from .mesh import DataMesh, make_mesh, replica_digest, shard_worker_tree
from .multihost import (global_worker_array, initialize_multihost,
                        is_primary_host, local_worker_range,
                        process_index)

KERNELS = ("window_attention_fwd", "window_attention_bwd",
           "window_attention_fwd_grouped", "window_attention_bwd_grouped")


class Replay(NamedTuple):
    """Draws for all W workers, made elsewhere: the reset draws in the order
    the rollout consumes them (``init_state``'s first; None: the run's own),
    the actions of the first steps (W, steps, n_branches; the run's own
    after them), and each update's permutations (epochs, W * T; None: the
    run's own). A run keeps its rows of each."""
    reset: Optional[Sequence[Any]]
    actions: torch.Tensor
    perms: Optional[Sequence[torch.Tensor]]


class StubEnv:
    """A deterministic env of the reference's Python protocol (numpy only,
    the counterpart of the JAX package's sharding test's mock env): 3-float
    observations of the step count, 2 actions that change nothing, episodes
    of 9 steps. ``train(..., stub_pool=n)`` runs a process pool of them."""

    class _Space:
        def __init__(self, shape=None, n=None):
            self.shape = shape
            self.n = n

    observation_space = _Space(shape=(3,))
    action_space = _Space(n=2)
    max_episode_steps = 10

    def _obs(self):
        t = float(self.t)
        return np.asarray([np.sin(t), np.cos(t), t / 10.0], np.float32)

    def reset(self):
        self.t = 0
        return self._obs()

    def step(self, action):
        self.t += 1
        done = self.t >= 9
        info = ({"reward": 0.1 * self.t, "length": float(self.t)}
                if done else None)
        return self._obs(), np.float32(0.1 * self.t), done, info

    def close(self):
        pass


class _Timed:
    """Stands in for a trainer's rollout or update function: keeps the
    outputs of the next ``keep`` calls and passes each call's keyword
    arguments from ``extra`` (one dict a call) on; with ``seconds``,
    synchronises the device around each call and keeps its seconds."""

    def __init__(self, fn, seconds: Optional[List[float]], device,
                 extra: Optional[Sequence[dict]] = None):
        self._fn, self._seconds, self._device = fn, seconds, device
        self._extra = list(extra or [])
        self.keep = 0
        self.outputs: List[Any] = []

    def __getattr__(self, name):
        return getattr(self._fn, name)

    def __call__(self, *args, **kwargs):
        if self._extra:
            kwargs.update(self._extra.pop(0))
        if self._seconds is None:
            out = self._fn(*args, **kwargs)
        else:
            _sync(self._device)
            start = time.perf_counter()
            out = self._fn(*args, **kwargs)
            _sync(self._device)
            self._seconds.append(time.perf_counter() - start)
        if self.keep > 0:
            self.keep -= 1
            self.outputs.append(out)
        return out


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _sample_actions(fn, replay: Optional[Replay], sampled: list,
                    margins: list) -> None:
    """Makes rollout ``fn`` keep, per step, the actions it draws and each
    worker's smallest Gumbel-max margin over its branches
    (``distributions.sample``), and take ``replay``'s actions (its rows)
    where there are any: its own are drawn all the same, so its generator
    runs as an unreplayed run's does."""
    taken = [0]

    def sample_actions(logits, step):
        found: list = []
        actions, log_probs = distributions.sample_multi(
            logits, fn.generator, *fn._draw_rows, margins=found)
        sampled.append(actions)
        margins.append(torch.stack(found).min(dim=0).values)
        if replay is not None and taken[0] < replay.actions.shape[1]:
            actions = replay.actions[fn.rows, taken[0]].to(actions.device)
            log_probs = torch.stack([distributions.log_prob(lg, actions[:, i])
                                     for i, lg in enumerate(logits)], dim=-1)
        taken[0] += 1
        return actions, log_probs
    fn.sample_actions = sample_actions
    if replay is not None and replay.reset is not None:
        resets = iter(replay.reset)
        fn.reset_draws = lambda: shard_worker_tree(
            next(resets), fn.mesh, fn.config.n_workers)


def train(mesh: Optional[DataMesh], config: TrainConfig, run_id: str = "probe",
          updates: int = 1, grouped: bool = False, resume: bool = False,
          replay: Optional[Replay] = None,
          state_dict: Optional[Dict[str, torch.Tensor]] = None,
          batch_fields: Sequence[str] = (), keep_params: bool = True,
          threads: Optional[int] = None, timed_collectives: bool = False,
          device="cpu", checkpoint_after: int = 0, save_model: bool = False,
          stub_pool: int = 0, chunk: int = 0,
          trace: bool = False, phase_clock: bool = False) -> Dict[str, Any]:
    """Trains ``updates`` updates of ``config`` on this rank (one device
    without a mesh) and returns, on the CPU: ``results`` (each update's
    result dict), ``digests`` and, with ``keep_params``, ``params`` (the
    parameters after each update) and ``first_grads`` (the clipped
    gradients the first optimizer step takes), ``batch`` (the first update's
    ``batch_fields``, this rank's rows, with the actions the rollout drew
    itself, ``sampled``, which a ``replay`` may have replaced, and their
    ``margins``), ``launches`` (each kernel's launches in each update,
    counted from 0),
    ``seconds`` (each rollout and PPO update, the device synchronised around
    each) and ``traffic`` (the mesh's collectives). ``state_dict`` replaces
    the initial parameters; ``resume`` restores the run's checkpoint;
    ``checkpoint_after`` > 0 saves one after that many updates (the config
    needs a ``checkpoint_interval``), and ``save_model`` the ``.nn`` at the
    end; ``stub_pool`` > 0 trains on a process pool of that many
    processes over ``StubEnv`` in place of the config's env.

    With ``chunk`` > 0 the updates run as fused launches of ``chunk``
    (``train_chunk``, on the trainer's route, nothing timed inside them):
    ``digests``, ``params``, ``launches`` and ``rank_samples`` are then
    each launch's, ``first_params`` the parameters after update 1 (read
    before any capture), ``seconds`` holds each launch's (``launch``, the
    device synchronised around it) and ``capture`` the fused loop's. With
    ``trace`` the ranks then run one more launch of one update, a replay,
    which rank 0 (or the one device) traces: ``busy`` is
    ``utils/profiling.device_busy`` of its spans ``rollout`` and
    ``ppo_update`` (this process's kernels only). ``phases`` is the
    trainer's clock's record (``phase_clock`` turns it on)."""
    if threads:
        torch.set_num_threads(threads)
    if mesh is not None:
        mesh.traffic.clear()    # this run's collectives, from its first
    env = None
    if stub_pool:
        from ..envs.host import HostEnvBatch
        env = HostEnvBatch(make_env=StubEnv, n_procs=stub_pool)
    trainer = PPOTrainer(config, run_id=run_id, device=device,
                         enable_metrics=False, grouped=grouped, mesh=mesh,
                         env=env, phase_clock=phase_clock)
    try:
        if state_dict is not None:
            trainer.model.load_state_dict(state_dict)
        rollout_fn = trainer.rollout_fn
        sampled: List[torch.Tensor] = []
        margins: List[torch.Tensor] = []
        if not trainer.is_host_env:
            _sample_actions(rollout_fn, replay, sampled, margins)
            if replay is not None and replay.reset is not None:
                trainer.rollout_state = rollout_fn.init_state()
        if resume and not trainer.resume_from_checkpoint():
            raise RuntimeError(f"{run_id}: no checkpoint to resume from")
        if mesh is not None:
            mesh.timed = timed_collectives
        seconds: Dict[str, List[float]] = (
            dict(launch=[]) if chunk else dict(rollout=[], ppo_update=[]))
        timed = seconds.get("rollout"), seconds.get("ppo_update")
        trainer.rollout_fn = _Timed(rollout_fn, timed[0], trainer.device)
        trainer.rollout_fn.keep = 1
        if chunk:
            trainer.fused_loop.rollout_fn = trainer.rollout_fn
        # The trainer runs each PPO update through PPOUpdate.run.
        trainer.update_fn.run = _Timed(
            trainer.update_fn.run, timed[1], trainer.device,
            [dict(perms=p) for p in replay.perms]
            if replay is not None and replay.perms is not None else None)
        first_grads: List[Dict[str, torch.Tensor]] = []
        first_params: List[Dict[str, torch.Tensor]] = []

        def named_cpu():
            return {n: p.detach().cpu().clone()
                    for n, p in trainer.model.named_parameters()}

        def keep_first_grads(optimizer, args, kwargs):
            first_grads.append({n: p.grad.detach().cpu().clone() for n, p
                                in trainer.model.named_parameters()})
            pre.remove()

        steps = [config.epochs * config.n_mini_batch]

        def keep_first_params(optimizer, args, kwargs):
            steps[0] -= 1
            if steps[0] == 0:      # update 1's last step, eager
                first_params.append(named_cpu())
                post.remove()
        optimizer = trainer.update_fn.optimizer
        pre = optimizer.register_step_pre_hook(keep_first_grads)
        post = optimizer.register_step_post_hook(keep_first_params)
        if not keep_params:
            pre.remove()
        if not (keep_params and chunk):
            post.remove()
        kernels = {name: getattr(wa, name) for name in KERNELS}
        for k in kernels.values():
            k.launches = 0
        out: Dict[str, Any] = dict(results=[], digests=[], params=[],
                                   launches=[], rank_samples=[])
        for u in range(updates // chunk if chunk else updates):
            before = {n: k.launches for n, k in kernels.items()}
            if chunk:
                _sync(trainer.device)
                start = time.perf_counter()
                out["results"] += trainer.train_chunk(chunk)
                _sync(trainer.device)
                seconds["launch"].append(time.perf_counter() - start)
            else:
                out["results"].append(trainer.train_one_update())
            out["launches"].append({n: k.launches - before[n]
                                    for n, k in kernels.items()})
            out["rank_samples"].append(list(trainer.update_fn.rank_samples))
            if u + 1 == checkpoint_after:
                trainer._save_checkpoint()
            params = list(trainer.model.parameters())
            out["digests"].append(replica_digest(params).cpu())
            if keep_params:
                out["params"].append(named_cpu())
            if u == 0:
                batch = trainer.rollout_fn.outputs.pop()[1]
                out["batch"] = {f: getattr(batch, f).cpu()
                                for f in batch_fields}
                if margins:
                    T = config.worker_steps
                    out["batch"]["sampled"] = torch.stack(
                        sampled[:T], dim=1).cpu()
                    out["batch"]["margins"] = torch.stack(
                        margins[:T], dim=1).cpu()
                del batch
        if trace and chunk:
            out["busy"] = _traced_launch(trainer, mesh)
        trainer.rollout_fn = rollout_fn
        if save_model:
            trainer._save_model()
        out["first_grads"] = first_grads[0] if first_grads else {}
        out["first_params"] = first_params[0] if first_params else {}
        out["seconds"] = seconds
        out["capture"] = dict(trainer.fused_loop.capture) if chunk else {}
        out["traffic"] = dict(mesh.traffic) if mesh is not None else {}
        out["rank"] = 0 if mesh is None else mesh.rank
        out["phases"] = trainer.clock.record()
        return out
    finally:
        trainer.close()


def _traced_launch(trainer, mesh: Optional[DataMesh]) -> Dict[str, Any]:
    """One more launch of one update of ``trainer``, traced on rank 0 (or
    the one device): ``device_busy`` of its rollout and PPO update."""
    from ..utils.profiling import TRACE_FILE, device_busy
    from ..utils.profiling import trace as profiled
    primary = mesh is None or mesh.is_primary
    with tempfile.TemporaryDirectory(prefix="etmppo_trace_") as log_dir:
        with profiled(log_dir) if primary else contextlib.nullcontext():
            trainer.train_chunk(1)
            _sync(trainer.device)
        if not primary:
            return {}
        return device_busy(os.path.join(log_dir, TRACE_FILE),
                           ("rollout", "ppo_update"))


def train_runs(mesh: Optional[DataMesh], runs: Sequence[tuple]
               ) -> List[Dict[str, Any]]:
    """Each (function, config, keyword arguments) of ``runs`` in turn, on
    the same ranks: ``function(mesh, config, **kwargs)``, a function of this
    module (``train``, ``fused_against_eager``)."""
    return [fn(mesh, config, **kwargs) for fn, config, kwargs in runs]


# --- fused launches under a mesh against eager ones -------------------------


class ActionRecorder:
    """A trainer's rollout that also keeps each rollout's actions: row n of
    ``actions`` (rows, W, T, branches) on the device, n a counter there, so
    that a captured rollout records on every replay too. It draws nothing
    and changes no value of the rollout's."""

    def __init__(self, rollout_fn, rows: int):
        self.fn = rollout_fn
        self.rows = rows
        self.actions = None
        self.count = torch.zeros((), dtype=torch.int64,
                                 device=rollout_fn.device)
        self._row = torch.arange(rows, device=rollout_fn.device).reshape(
            -1, 1, 1, 1)

    def __getattr__(self, name):
        return getattr(self.fn, name)

    def __call__(self, state):
        final, batch = self.fn(state)
        if self.actions is None:
            self.actions = torch.zeros(
                (self.rows,) + tuple(batch.actions.shape),
                dtype=batch.actions.dtype, device=batch.actions.device)
        self.actions.copy_(torch.where(self._row == self.count,
                                       batch.actions[None], self.actions))
        self.count += 1
        return final, batch


def record_actions(trainer, rows: int) -> ActionRecorder:
    recorder = ActionRecorder(trainer.rollout_fn, rows)
    trainer.rollout_fn = recorder
    trainer.fused_loop.rollout_fn = recorder
    return recorder


@contextlib.contextmanager
def deterministic_algorithms():
    """PyTorch's deterministic algorithms (warn only) and cuDNN's
    deterministic mode, without their NaN fill of every new tensor: the
    fill adds some 40% of a graph's nodes and of an eager update's seconds,
    and changes no value compared here (a read of memory never written
    would differ between a graph's pool and an eager allocation, and fail
    the comparison)."""
    import torch.utils.deterministic as det
    flags = (torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled(),
             torch.backends.cudnn.deterministic, det.fill_uninitialized_memory)
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = True
    det.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(flags[0], warn_only=flags[1])
        torch.backends.cudnn.deterministic = flags[2]
        det.fill_uninitialized_memory = flags[3]


def cpu_tree(tree):
    """A copy on the host of nested dicts, lists and tensors."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().clone()
    if isinstance(tree, dict):
        return {k: cpu_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(cpu_tree(v) for v in tree)
    return tree


def differences(a, b, where: str = "") -> List[str]:
    """Where two nested dicts/lists of tensors and values differ, to the
    bit."""
    if isinstance(a, torch.Tensor):
        same = (isinstance(b, torch.Tensor) and a.dtype == b.dtype
                and torch.equal(a.cpu(), b.cpu()))
        return [] if same else [f"{where} differs"]
    if isinstance(a, dict):
        if set(a) != set(b):
            return [f"{where}: the keys differ"]
        return [d for k in a for d in differences(a[k], b[k], f"{where}/{k}")]
    if isinstance(a, (list, tuple)):
        if len(a) != len(b):
            return [f"{where}: the lengths differ"]
        return [d for i, (x, y) in enumerate(zip(a, b))
                for d in differences(x, y, f"{where}/{i}")]
    return [] if a == b else [f"{where} differs ({a} vs {b})"]


class CountingKernel:
    """A window-attention kernel whose plain version (what CPU tensors
    take) counts its calls in ``launches``, as the card's wrappers count
    their launches."""

    def __init__(self, kernel):
        self.launches = 0
        self._plain = kernel.plain

    def plain(self, *args, **kwargs):
        self.launches += 1
        return self._plain(*args, **kwargs)


class StandInGraphs:
    """``torch.cuda``'s graph API on the CPU for one trainer's fused loop
    under a mesh, so that its graph route runs there: a capture runs the
    segment and then puts back every value it changed (a capture computes
    nothing); a replay runs the segment again and puts back the kernels'
    counts (a replay runs no Python: the loop adds the captured launches).
    Each graph counts its captures and replays."""

    class Graph:
        def __init__(self, owner, keep_graph: bool = False):
            self.owner = owner
            self.captures = self.replays = 0

        def register_generator_state(self, generator) -> None:
            if generator not in self.owner.generators():
                raise ValueError("not one of the trainer's generators")

        def instantiate(self) -> None:
            pass

        def pool(self) -> str:
            return "stand-in pool"

        def replay(self) -> None:
            self.replays += 1
            kernels = self.owner.trainer.fused_loop._kernels()
            counts = [k.launches for k in kernels]
            self.owner.pending()
            for k, n in zip(kernels, counts):
                k.launches = n

    class Stream:
        def wait_stream(self, other) -> None:
            pass

    def __init__(self, trainer, extra: Sequence[torch.Tensor] = ()):
        self.trainer = trainer
        self.extra = list(extra)
        self.pending: Callable[[], None] = lambda: None
        self._saved: List[tuple] = []

    def generators(self) -> list:
        t = self.trainer
        return [t.rollout_fn.generator, t.update_fn.generator]

    def _tensors(self) -> List[torch.Tensor]:
        """Every tensor a segment may change in place."""
        t = self.trainer
        upd, loop = t.update_fn, t.fused_loop
        optimizer = [v for state in upd.optimizer.state.values()
                     for v in state.values() if isinstance(v, torch.Tensor)]
        rows = loop._slots.global_rows
        return (list(t.model.parameters()) + optimizer
                + ([] if loop._state is None else state_tensors(loop._state))
                + [x for x in (upd._flat, upd._sums, rows) if x is not None]
                + self.extra)

    @contextlib.contextmanager
    def _capture(self, graph, pool=None, stream=None,
                 capture_error_mode: str = "global"):
        graph.captures += 1
        values = [x.detach().clone() for x in self._tensors()]
        states = [g.get_state() for g in self.generators()]
        yield
        for x, v in zip(self._tensors(), values):
            x.data.copy_(v)
        for g, state in zip(self.generators(), states):
            g.set_state(state)

    def __enter__(self):
        loop = self.trainer.fused_loop
        segment = loop.segment

        def recording_segment(name, fn, generators=()):
            self.pending = fn       # what the replay of ``name`` runs
            segment(name, fn, generators)
        patches = [
            (torch.cuda, "CUDAGraph",
             lambda keep_graph=False: self.Graph(self, keep_graph)),
            (torch.cuda, "graph", self._capture),
            (torch.cuda, "Stream", lambda device=None: self.Stream()),
            (torch.cuda, "stream", lambda s: contextlib.nullcontext()),
            (torch.cuda, "current_stream",
             lambda device=None: self.Stream()),
            (torch.cuda, "synchronize", lambda device=None: None),
            (torch.cuda, "empty_cache", lambda: None),
            (torch.cuda, "memory_reserved", lambda device=None: 0),
            (fused_lib, "graph_nodes", lambda graph: 0),
            (loop, "segment", recording_segment)]
        self._saved = [(obj, name, getattr(obj, name))
                       for obj, name, _ in patches]
        for obj, name, value in patches:
            setattr(obj, name, value)
        return self

    def __exit__(self, *exc) -> bool:
        for obj, name, value in reversed(self._saved):
            if obj is self.trainer.fused_loop:
                delattr(obj, name)
            else:
                setattr(obj, name, value)
        return False


def _perturb_after(trainer, mesh: DataMesh, rank: int, after: int) -> None:
    """Makes rank ``rank`` flip the lowest bit of one parameter of its own
    after update ``after`` of each of the trainer's fused launches, between
    two updates of the launch."""
    loop = trainer.fused_loop
    store = loop._store

    def store_then_perturb(chunk, k, K, *outputs):
        store(chunk, k, K, *outputs)
        if k + 1 == after and mesh.rank == rank:
            with torch.no_grad():
                bits = next(trainer.model.parameters()).data.view(-1).view(
                    torch.int32)
                bits[0] ^= 1
    loop._store = store_then_perturb


def fused_against_eager(mesh: DataMesh, config: TrainConfig, chunk: int,
                        chunks: int = 1, grouped: bool = False,
                        device="cpu", deterministic: bool = False,
                        stand_in: bool = False, resume: bool = False,
                        perturb: Optional[tuple] = None,
                        threads: Optional[int] = None) -> Dict[str, Any]:
    """This rank's twin trainers of ``config`` (one seed) under ``mesh``:
    ``eager`` runs ``chunks`` fused launches of ``chunk`` updates on the
    eager route, ``fused`` the same on the graph route (on the CPU with
    ``stand_in``: on ``StandInGraphs``), under ``deterministic_algorithms``
    where asked. Returns, on the CPU: ``mismatches``, what differs to the
    bit (each update's logged values and actions, the episode infos; after
    each launch the parameters, the optimizer state, the rollout state and
    both generators), empty when nothing does; ``route``; ``results`` and
    ``digests`` (after each launch) of the fused trainer; ``launches``
    (each trainer's forward and backward kernel launches in each launch);
    ``traffic`` (each trainer's collectives); ``graphs`` (the captured
    segments; on the stand-in each one's captures and replays);
    ``capture`` (the fused loop's); ``seconds`` (each launch of each
    trainer, the device synchronised around it). With ``resume`` the fused
    trainer then saves a checkpoint and resumes from it, ``forgot`` says
    whether its graphs went, and one more launch of each trainer is held
    as above. With ``perturb`` = (rank, k) the fused trainer then runs one
    more launch in which rank ``rank`` flips a bit of a parameter after
    update k; ``raised`` is the launch's error, or None."""
    if threads:
        torch.set_num_threads(threads)
    context = (deterministic_algorithms() if deterministic
               else contextlib.nullcontext())
    config = dataclasses.replace(config, updates_per_launch=chunk,
                                 checkpoint_interval=chunk)
    trainers: Dict[str, PPOTrainer] = {}
    try:
        with context:
            for name in ("eager", "fused"):
                trainers[name] = PPOTrainer(config, run_id=name,
                                            device=device,
                                            enable_metrics=False,
                                            grouped=grouped, mesh=mesh)
            eager, fused = trainers["eager"], trainers["fused"]
            eager.fused_loop = FusedTrainLoop(eager.rollout_fn,
                                              eager.update_fn, "eager", mesh)
            eager.fused_route = "eager"
            if stand_in:
                fused.fused_loop.route = fused.fused_route = "graph"
            if fused.fused_route != "graph":
                raise RuntimeError(f"the fused trainer's route is "
                                   f"{fused.fused_route!r}, not 'graph'")
            rows = (chunks + int(resume) + int(perturb is not None)) * chunk
            recorders = {}
            for name, t in trainers.items():
                recorders[name] = record_actions(t, rows)
                if stand_in:
                    upd = t.update_fn
                    upd.kernel = CountingKernel(upd.kernel)
                    if upd.backward_kernel is not None:
                        upd.backward_kernel = CountingKernel(
                            upd.backward_kernel)
            graphs = (StandInGraphs(fused, [recorders["fused"].count])
                      if stand_in else contextlib.nullcontext())
            with graphs:
                out = _launches_against_eager(trainers, mesh, chunk, chunks,
                                              recorders)
                if resume:
                    fused._save_checkpoint()
                    mesh.all_gather_object(None)    # rank 0 has written it
                    if not fused.resume_from_checkpoint():
                        raise RuntimeError("no checkpoint to resume from")
                    out["forgot"] = not fused.fused_loop._graphs
                    again = _launches_against_eager(trainers, mesh, chunk, 1,
                                                    recorders, chunks)
                    out["mismatches"] += again["mismatches"]
                    out["after_resume"] = again
                if perturb is not None:
                    _perturb_after(fused, mesh, *perturb)
                    out["raised"] = None
                    try:
                        fused.train_chunk(chunk)
                    except RuntimeError as error:    # the check's own raise
                        out["raised"] = str(error)
        out["route"] = fused.fused_route
        out["rank"] = mesh.rank
        return out
    finally:
        for t in trainers.values():
            t.close()


def _launches_against_eager(trainers: Dict[str, PPOTrainer], mesh: DataMesh,
                            chunk: int, chunks: int, recorders: dict,
                            first: int = 0) -> Dict[str, Any]:
    """``chunks`` launches of ``chunk`` of each trainer (``eager`` first,
    then ``fused``), compared as ``fused_against_eager`` says; ``first``
    launches ran before."""
    out: Dict[str, Any] = dict(mismatches=[], launches={}, traffic={},
                               seconds={}, results={}, states={},
                               digests={})
    for name, t in trainers.items():
        upd = t.update_fn
        kernels = [k for k in (upd.kernel, upd.backward_kernel)
                   if k is not None]
        traffic = {label: dict(rec) for label, rec in mesh.traffic.items()}
        launches, seconds, results, states, digests = [], [], [], [], []
        for _ in range(chunks):
            before = [k.launches for k in kernels]
            _sync(t.device)
            start = time.perf_counter()
            results += t.train_chunk(chunk)
            _sync(t.device)
            seconds.append(time.perf_counter() - start)
            launches.append([k.launches - n for k, n in zip(kernels, before)])
            states.append(cpu_tree(t._training_state()))
            digests.append(replica_digest(list(t.model.parameters())).cpu())
        out["digests"][name] = digests
        out["launches"][name] = launches
        out["seconds"][name] = seconds
        out["results"][name] = results
        out["states"][name] = states
        out["traffic"][name] = {
            label: {key: rec[key] - traffic.get(label, {}).get(key, 0)
                    for key in ("calls", "bytes")}
            for label, rec in mesh.traffic.items()}
    e, f = out["states"].pop("eager"), out["states"].pop("fused")
    del out["states"]
    rows = slice(first * chunk, (first + chunks) * chunk)
    out["mismatches"] += differences(out["results"]["eager"],
                                     out["results"]["fused"], "results")
    out["mismatches"] += differences(e, f, "state after launch")
    out["mismatches"] += differences(
        recorders["eager"].actions[rows].cpu(),
        recorders["fused"].actions[rows].cpu(), "actions")
    out["mismatches"] += differences(
        list(trainers["eager"].episode_infos),
        list(trainers["fused"].episode_infos), "episode infos")
    out["results"] = out["results"]["fused"]
    out["digests"] = out["digests"]["fused"]
    loop = trainers["fused"].fused_loop
    out["graphs"] = {name: (getattr(g, "captures", None),
                            getattr(g, "replays", None))
                     for name, g in loop._graphs.items()}
    out["capture"] = dict(loop.capture)
    return out


def check_global_moments(process_id: int, num_processes: int,
                         coordinator_address: str, n_workers: int = 8,
                         backend: str = "gloo") -> dict:
    """One process of a multi-process check of ``multihost`` (the
    counterpart of the JAX package's two-process test): initialises the group at
    ``coordinator_address``, fills each of its workers' rows (of
    ``n_workers``, 4 values each) with the global worker index, assembles
    the global array and returns its sum and mean of squares, which every
    process must agree on, with its primacy and worker range."""
    initialize_multihost(coordinator_address, num_processes, process_id,
                         backend=backend)
    try:
        mesh = make_mesh(num_processes, "cpu", backend)
        rows = local_worker_range(n_workers)
        local = np.repeat(np.asarray(rows, np.float32)[:, None], 4, axis=1)
        x = global_worker_array(local, mesh)
        return dict(process=process_index(), primary=is_primary_host(),
                    rows=list(rows), shape=tuple(x.shape),
                    total=float(x.sum()), mean_sq=float((x * x).mean()))
    finally:
        torch.distributed.destroy_process_group()
