"""Multi-host process-group initialisation (counterpart of
``etmppo_tpu/parallel/multihost.py``).

A multi-host run is the same program as a single-host one: call
``initialize_multihost()`` before building the trainer, set ``num_devices``
to the world size, and keep ``n_workers`` divisible by it. Each process is
one rank with one device and feeds the worker block ``local_worker_range``
gives it; gradients and global statistics ride the process group's
collectives (``mesh.DataMesh``).

Where the JAX package's ``jax.distributed.initialize`` auto-detects a Cloud
TPU slice, this reads torchrun's environment (``MASTER_ADDR``,
``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``):

    torchrun --nproc_per_node=N -m etmppo_tpu_torch.cli --config=x.json
"""
from __future__ import annotations

import datetime
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from .mesh import DataMesh, default_backend


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         backend: Optional[str] = None,
                         timeout: float = 600.0) -> None:
    """Wraps ``torch.distributed.init_process_group``. Given a
    ``coordinator_address`` (``host:port``), ``num_processes`` and
    ``process_id``, the processes meet at ``tcp://host:port``; without them
    the group is read from torchrun's environment. ``backend`` defaults to
    ``nccl`` where CUDA is available, else ``gloo``; ``timeout`` (seconds)
    bounds the rendezvous and every collective."""
    backend = backend or default_backend(
        "cuda" if torch.cuda.is_available() else "cpu")
    kwargs = dict(timeout=datetime.timedelta(seconds=timeout))
    given = (coordinator_address, num_processes, process_id)
    if any(v is not None for v in given):
        if any(v is None for v in given):
            raise ValueError("pass coordinator_address, num_processes and "
                             "process_id together, or none of them")
        kwargs.update(init_method=f"tcp://{coordinator_address}",
                      world_size=num_processes, rank=process_id)
    else:
        missing = [k for k in ("MASTER_ADDR", "MASTER_PORT", "RANK",
                               "WORLD_SIZE") if k not in os.environ]
        if missing:
            raise RuntimeError(f"no coordinator given and {missing} are not "
                               "set: run under torchrun or pass "
                               "coordinator_address, num_processes and "
                               "process_id")
        kwargs.update(init_method="env://")
    dist.init_process_group(backend, **kwargs)


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_primary_host() -> bool:
    return process_index() == 0


def global_worker_array(local_data, mesh: DataMesh) -> torch.Tensor:
    """The GLOBAL worker-leading tensor assembled from each process's block
    ``local_data`` (a tensor or array on this process; the same shape on
    every process), in process order, on every process: an all-gather
    (``DataMesh.gather_workers``)."""
    local = (torch.from_numpy(np.ascontiguousarray(local_data))
             if isinstance(local_data, np.ndarray)
             else torch.as_tensor(local_data))
    return mesh.gather_workers(local.to(mesh.device), "global_worker_array")


def local_worker_range(n_workers_global: int) -> range:
    """The contiguous block of global worker indices this process feeds."""
    n_proc = process_count()
    assert n_workers_global % n_proc == 0, (
        f"n_workers={n_workers_global} must be divisible by the number of "
        f"hosts ({n_proc}); otherwise the trailing "
        f"{n_workers_global % n_proc} workers would never be fed and the "
        f"assembled global array would be smaller than n_workers.")
    per = n_workers_global // n_proc
    lo = process_index() * per
    return range(lo, lo + per)

