"""Data parallelism over ``torch.distributed`` (counterpart of
``etmppo_tpu/parallel/mesh.py``).

A ``num_devices: N`` run is the single-device program split by worker, as
the JAX package's GSPMD run over its 1-D ``("data",)`` mesh is:

* Rank ``r`` of ``N`` owns workers ``[r W/N, (r + 1) W/N)``
  (``DataMesh.worker_rows``): their env state, observations, episode steps,
  episodic memory and K/V caches (``shard_worker_tree``). The parameters
  and the optimizer state are replicated: initialised from one seed on
  every rank, then broadcast from rank 0 (``replicate_tree``). The rollout
  and update generators are replicated too.
* Every random draw is made for all ``W`` workers and each rank keeps its
  rows, so a rank's workers see what they see on one device.
* The update moves gradients, not samples (``training/ppo.py``): every rank
  draws the same global permutation, takes the samples of each global
  minibatch whose worker is its own, padded to a fixed size, and computes
  its part of the global minibatch's loss. One ``all_reduce`` a minibatch
  over one flat buffer at a fixed address (``flat_views``: every gradient
  is a view of it, the six stats follow) sums the gradients and the stats;
  every rank then clips and steps alike.

The ranks' parameters stay bit-identical because every rank applies the
same clipping and AdamW step to the same summed gradients, and the sum is
the same on every rank: gloo's and NCCL's ring and tree reductions reduce
each element once and hand the result to every rank (with two ranks
``a + b == b + a`` whatever the algorithm). Every update writes a digest of
the parameters (``replica_digest``); the trainer gathers a launch's digests
at its end (``check_replicated``) and raises, naming the first update whose
digests differ, if it ever fails.

A group runs ``nccl`` on CUDA devices, one card a rank, and ``gloo`` on the
CPU, unless the caller names the backend. ``gloo`` also takes CUDA tensors
(two ranks sharing one card, as chip_smoke.py runs them; gloo copies them
through the host itself): its ``all_reduce``, ``broadcast`` and
``all_gather`` take them on the card machine's PyTorch. ``nccl`` with fewer
visible cards than ranks raises; it never shares a card or switches
backend.

``spawn`` starts N ranks on this host (``torch.multiprocessing`` with the
spawn start method, never fork: CUDA may be up in the parent); torchrun's
ranks come in through ``multihost.initialize_multihost``.
"""
from __future__ import annotations

import contextlib
import datetime
import multiprocessing.connection
import os
import pickle
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"      # the JAX package's mesh axis: a mesh here is 1-D


def default_backend(device) -> str:
    """``nccl`` for a CUDA device, ``gloo`` otherwise."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


class DataMesh:
    """This rank's view of the ranks of one run: its rank, their number, its
    device, the backend of the (default) process group, and the collectives
    the trainer uses. ``traffic`` counts each collective's calls, bytes
    (what one rank sends in, or for a gather receives) and wall seconds by
    label; with ``timed`` the device is synchronised around each call, so
    the seconds are the collective's own."""

    def __init__(self, rank: int, size: int, device, backend: str):
        self.rank = rank
        self.size = size
        self.device = torch.device(device)
        self.backend = backend
        self.timed = False
        self.traffic: Dict[str, Dict[str, float]] = {}

    @property
    def is_primary(self) -> bool:
        return self.rank == 0

    def worker_rows(self, n_workers: int) -> slice:
        """This rank's workers of ``n_workers``."""
        if n_workers % self.size != 0:
            raise ValueError(f"n_workers ({n_workers}) must be divisible by "
                             f"num_devices ({self.size})")
        per = n_workers // self.size
        return slice(self.rank * per, (self.rank + 1) * per)

    @contextlib.contextmanager
    def _count(self, label: str, nbytes: int):
        sync = self.timed and self.device.type == "cuda"
        if sync and torch.cuda.is_current_stream_capturing():
            raise RuntimeError("a timed collective synchronises the device, "
                               "which a CUDA graph capture refuses")
        if sync:
            torch.cuda.synchronize(self.device)
        start = time.perf_counter()
        yield
        if sync:
            torch.cuda.synchronize(self.device)
        rec = self.traffic.setdefault(label, dict(calls=0, bytes=0,
                                                  seconds=0.0))
        rec["calls"] += 1
        rec["bytes"] += nbytes
        rec["seconds"] += time.perf_counter() - start

    def all_reduce_(self, t: torch.Tensor, label: str = "all_reduce"
                    ) -> torch.Tensor:
        """Sums ``t`` over the ranks, in place."""
        with self._count(label, t.numel() * t.element_size()):
            dist.all_reduce(t)
        return t

    def broadcast_(self, t: torch.Tensor, src: int = 0,
                   label: str = "broadcast") -> torch.Tensor:
        """Overwrites ``t`` with rank ``src``'s, in place."""
        with self._count(label, t.numel() * t.element_size()):
            dist.broadcast(t, src)
        return t

    def gather_workers(self, t: torch.Tensor, label: str = "gather",
                       out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Every rank's ``t`` (its block of a worker-leading tensor, the same
        shape on every rank) concatenated in rank order: the global
        tensor, on every rank; written into ``out`` where given (a buffer
        at a fixed address, as a replayed CUDA graph reads it)."""
        if t.dtype == torch.bool:
            return self.gather_workers(t.to(torch.uint8), label).bool()
        t = t.contiguous()
        if out is None:
            out = torch.empty((t.shape[0] * self.size,) + tuple(t.shape[1:]),
                              dtype=t.dtype, device=t.device)
        with self._count(label, out.numel() * out.element_size()):
            dist.all_gather(list(out.chunk(self.size)), t)
        return out

    def all_gather_object(self, obj: Any) -> List[Any]:
        out: List[Any] = [None] * self.size
        dist.all_gather_object(out, obj)
        return out


def make_mesh(num_devices: int, device, backend: Optional[str] = None
              ) -> DataMesh:
    """The mesh of the initialised default process group, which must hold
    ``num_devices`` ranks and run ``backend`` (by default ``nccl`` for a
    CUDA device, ``gloo`` otherwise). A CUDA ``device`` without an index
    becomes ``cuda:<LOCAL_RANK>`` under ``nccl`` (one card a rank) and
    ``cuda:0`` under ``gloo``."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "no process group is initialised: start the ranks with "
            "etmppo_tpu_torch.parallel.mesh.spawn, or under torchrun call "
            "parallel.multihost.initialize_multihost first")
    size = dist.get_world_size()
    if size != num_devices:
        raise ValueError(f"the process group holds {size} ranks, the run "
                         f"asks for num_devices={num_devices}")
    device = torch.device(device)
    backend = backend or default_backend(device)
    if dist.get_backend() != backend:
        raise ValueError(f"the process group runs {dist.get_backend()}, "
                         f"not {backend}")
    if device.type == "cuda":
        if device.index is None:
            index = (int(os.environ.get("LOCAL_RANK", dist.get_rank()))
                     if backend == "nccl" else 0)
            device = torch.device("cuda", index)
        if device.index >= torch.cuda.device_count():
            raise RuntimeError(
                f"rank {dist.get_rank()} needs {device}, but "
                f"{torch.cuda.device_count()} CUDA devices are visible")
        torch.cuda.set_device(device)
    return DataMesh(dist.get_rank(), size, device, backend)


def _map(tree: Any, leaf: Callable[[Any], Any]) -> Any:
    """``leaf`` applied to every tensor and array of a tree of dicts, lists,
    tuples and NamedTuples."""
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return leaf(tree)
    if isinstance(tree, dict):
        return type(tree)((k, _map(v, leaf)) for k, v in tree.items())
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(v, leaf) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, leaf) for v in tree)
    return tree


def shard_worker_tree(tree: Any, mesh: Optional[DataMesh], n_workers: int
                      ) -> Any:
    """This rank's rows of every tensor or array of ``tree`` whose leading
    axis has ``n_workers`` entries; everything else (generator states,
    counters, scalars) is left as it is, replicated. Without a mesh the
    tree is returned unchanged."""
    if mesh is None:
        return tree
    rows = mesh.worker_rows(n_workers)

    def place(x):
        return x[rows] if x.ndim >= 1 and x.shape[0] == n_workers else x
    return _map(tree, place)


def gather_worker_tree(tree: Any, mesh: Optional[DataMesh]) -> Any:
    """Every tensor or array of ``tree`` (each a rank's block of
    worker-leading rows) gathered into the global worker order, on every
    rank; arrays come back as arrays. Without a mesh the tree is returned
    unchanged."""
    if mesh is None:
        return tree

    def gather(x):
        if isinstance(x, np.ndarray):
            return mesh.gather_workers(torch.from_numpy(x)).numpy()
        return mesh.gather_workers(x)
    return _map(tree, gather)


def replicate_tree(tree: Any, mesh: Optional[DataMesh]) -> Any:
    """Overwrites every tensor of ``tree`` with rank 0's, in place (a
    parameter of a module is overwritten in the module); returns the
    tree."""
    if mesh is not None:
        def bcast(x):
            if isinstance(x, torch.Tensor):
                with torch.no_grad():
                    mesh.broadcast_(x)
            return x
        _map(tree, bcast)
    return tree


def flat_views(tensors: Sequence[torch.Tensor], extra: int = 0):
    """One zeroed flat float32 buffer of the tensors' elements and ``extra``
    more, on the first tensor's device, and views of it in the tensors'
    shapes: tensors that live in the views are summed over the ranks by ONE
    ``all_reduce`` of the buffer, which stays at its address, as a replayed
    CUDA graph needs. Returns (buffer, views)."""
    flat = torch.zeros(sum(t.numel() for t in tensors) + extra,
                       device=tensors[0].device)
    views, offset = [], 0
    for t in tensors:
        views.append(flat[offset:offset + t.numel()].view(t.shape))
        offset += t.numel()
    return flat, views


def replica_digest(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """Two int64 sums of the tensors' float32 bits, one weighted by
    position: any bit that differs between two ranks changes them."""
    bits = torch.cat([t.detach().float().reshape(-1) for t in tensors]
                     ).view(torch.int32).to(torch.int64)
    weight = torch.arange(bits.numel(), device=bits.device) % 8191 + 1
    return torch.stack([bits.sum(), (bits * weight).sum()])


def check_replicated(digests: torch.Tensor, mesh: DataMesh) -> None:
    """Raises unless every rank wrote the same ``digests`` (K, 2), one
    ``replica_digest`` of the parameters after each update of a launch,
    naming the first update whose digests differ. One gather and one host
    read."""
    K = digests.shape[0]
    every = mesh.gather_workers(digests, "replica check").cpu().reshape(
        mesh.size, K, 2)
    differ = (every != every[0]).any(dim=2).any(dim=0)
    if bool(differ.any()):
        k = int(differ.nonzero()[0])
        raise RuntimeError(
            f"the ranks' parameters differ after update {k + 1} of {K} in "
            f"this launch: digests by rank {every[:, k].tolist()}")


# --- starting the ranks -------------------------------------------------------


def _rank_main(fn, args, kwargs, rank: int, size: int, init_method: str,
               backend: str, device: str, timeout_s: float, conn) -> None:
    """A spawned rank: joins the group, runs ``fn(mesh, *args, **kwargs)``
    and sends its pickled result (or its traceback) to the parent; without
    an ``init_method``, runs ``fn(rank, *args, **kwargs)`` in no group."""
    try:
        os.environ["LOCAL_RANK"] = str(rank)   # spawn's ranks share a host
        if torch.device(device).type == "cpu":
            # The ranks share the host's cores, as torchrun's would.
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // size))
        if init_method is None:
            result = fn(rank, *args, **kwargs)
        else:
            dist.init_process_group(
                backend, init_method=init_method, rank=rank, world_size=size,
                timeout=datetime.timedelta(seconds=timeout_s))
            result = fn(make_mesh(size, device, backend), *args, **kwargs)
        conn.send(("ok", pickle.dumps(result)))
    except BaseException:
        conn.send(("error", traceback.format_exc()))
        raise
    finally:
        conn.close()
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn: Callable, num_devices: int, args: tuple = (),
          kwargs: Optional[dict] = None, device="cuda",
          backend: Optional[str] = None, timeout: Optional[float] = None,
          collective_timeout: float = 600.0, join_group: bool = True
          ) -> List[Any]:
    """Runs ``fn(mesh, *args, **kwargs)`` on ``num_devices`` ranks of this
    host and returns their results in rank order (``fn`` must be importable
    from the package, and its result picklable; send tensors back on the
    CPU).

    Under ``nccl`` (the default for a CUDA ``device``) rank ``r`` runs on
    ``cuda:<r>`` and there must be a card a rank; ``gloo`` (the CPU's
    default) runs every rank on ``device``, so two ranks share a card only
    where the caller names ``gloo``. The ranks meet through a ``file://``
    rendezvous in a temporary directory; ``collective_timeout`` bounds the
    rendezvous, every collective and each rank's exit after it reported;
    ``timeout``, where given, the whole run (None: no deadline, as a
    training run of hours needs; a hung rank still fails the others'
    collectives). A rank that raises or dies fails the run: the survivors
    are killed and that rank's traceback is raised here. With ``join_group=False`` the ranks join no
    group and run ``fn(rank, *args, **kwargs)`` (a function that initialises
    its own, as ``multihost.initialize_multihost`` does)."""
    device = torch.device(device)
    backend = backend or default_backend(device)
    if device.type == "cuda" and backend == "nccl":
        visible = torch.cuda.device_count()
        if visible < num_devices:
            raise RuntimeError(
                f"nccl runs one card a rank: {num_devices} ranks, but "
                f"{visible} CUDA devices are visible (name backend='gloo' "
                "to run the ranks on one card)")
    # Under nccl each rank takes its own card (make_mesh: cuda:<LOCAL_RANK>).
    rank_device = "cuda" if backend == "nccl" else str(device)
    ctx = torch.multiprocessing.get_context("spawn")
    procs: List[Any] = []
    pending: Dict[Any, int] = {}
    results: List[Any] = [None] * num_devices
    with tempfile.TemporaryDirectory(prefix="etmppo_mesh_") as tmp:
        init_method = ("file://" + os.path.join(tmp, "rendezvous")
                       if join_group else None)
        try:
            for rank in range(num_devices):
                recv, send = ctx.Pipe(duplex=False)
                proc = ctx.Process(
                    target=_rank_main, name=f"rank{rank}",
                    args=(fn, args, kwargs or {}, rank, num_devices,
                          init_method, backend, rank_device,
                          collective_timeout, send))
                proc.start()
                send.close()
                procs.append(proc)
                pending[recv] = rank
            deadline = (None if timeout is None
                        else time.monotonic() + timeout)
            while pending:
                left = (None if deadline is None
                        else max(deadline - time.monotonic(), 0.0))
                ready = multiprocessing.connection.wait(list(pending), left)
                if not ready:
                    raise TimeoutError(
                        f"ranks {sorted(pending.values())} of {num_devices} "
                        f"did not finish within {timeout} s")
                for conn in ready:
                    rank = pending.pop(conn)
                    try:
                        status, payload = conn.recv()
                    except EOFError:
                        procs[rank].join(10)
                        status, payload = "error", (
                            f"exited with code {procs[rank].exitcode} "
                            "before it reported")
                    conn.close()
                    if status != "ok":
                        raise RuntimeError(
                            f"rank {rank} of {num_devices} failed:\n{payload}")
                    results[rank] = pickle.loads(payload)
            for proc in procs:
                proc.join(collective_timeout)
                if proc.exitcode != 0:
                    raise RuntimeError(f"{proc.name} exited with code "
                                       f"{proc.exitcode}")
        finally:
            for proc in procs:
                if proc.is_alive():
                    proc.kill()
                proc.join(10)
            for conn in pending:
                conn.close()
    return results
