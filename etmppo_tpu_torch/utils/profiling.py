"""Profiling hooks (counterpart of ``etmppo_tpu/utils/profiling.py``).

* ``trace(log_dir)``: a ``torch.profiler`` trace of host and CUDA activity
  (the CUDA activity where this PyTorch build has it) around the block,
  written into ``log_dir`` as a Chrome trace JSON (``trace.json``), which
  chrome://tracing and Perfetto open. Yields the profiler; with
  ``record_shapes`` its ``key_averages(group_by_input_shape=True)`` tells
  an operator's calls apart by their input shapes.
* ``annotate(name)``: a named span in that trace (``record_function``).
* ``device_busy(path, spans)``: from such a trace, the wall time of
  consecutive host spans and the share of it in which the device ran a
  kernel, a copy or a memset.
* ``PhaseClock``: the trainer's clock of its set-up, its launches and the
  phases of each update, which runs inside a replayed CUDA graph at the
  untraced pace (below).

Under data parallelism ``cli.py --profile`` traces rank 0 alone.

The phase clock
---------------
A ``PhaseClock`` belongs to a ``PPOTrainer`` (``trainer.clock``), which hands
it to its rollout, its update and its fused loop. It is off unless the
trainer is built with ``phase_clock=True``, as ``cli.py --profile DIR`` builds
it (a keyword, not a key of the config); the CLI then writes the clock's
record as ``DIR/<run-id>/phases.json`` beside ``trace.json``. Its spans,
each inside its parent:

* device, one set per update (``PHASES``): ``update``, from the first stamp
  to the last; in it ``rollout`` (``rollout.policy``: the K/V-cache step,
  the cache writes and the sampling; ``rollout.env_step``: the step draws
  and ``env.step``; ``rollout.env_reset``: the reset draws,
  ``env.reset_done`` (by default ``env.reset`` of all workers,
  ``select_state`` and the obs ``where``; at Mystery Path Grid and Mortar
  Mayhem Grid on CUDA one kernel) and the memory and K/V cache resets;
  ``rollout.gae``: the bootstrap value and GAE),
  ``ppo_update`` (``ppo_update.prepare``; ``ppo_update.loss``: every
  minibatch's forward and backward; ``ppo_update.step``: clipping, the norm
  groups and AdamW) and ``outputs`` (the packing and the state write-back).
  A phase that repeats at every step or minibatch is the sum of its
  occurrences.
* host, one set per launch (``train_chunk``): ``launch``, and in it
  ``launch.warm_up`` (to the synchronize before the capture),
  ``launch.capture``, ``launch.instantiate``, ``launch.replays``,
  ``launch.drain`` (the device-to-host copies of the launch's outputs) and
  ``launch.log`` (the episode infos and the writer).
* host, once: ``setup.trainer`` (``PPOTrainer.__init__``), and in it
  ``setup.env``, ``setup.model``, ``setup.optimizer`` and ``setup.kernels``
  (the nvcc builds and the ctypes loads of the CUDA kernels).

Every span is also a ``record_function`` of its name, clock on or off, so a
profiler trace shows the clock's names; a device phase is a host span only
where the host runs it (an eager update, a capture). On CUDA each phase
boundary is a one-thread kernel (``csrc/phase_stamp.cu``) that reads the
card's global timer into a fixed int64 buffer of the clock, and a capture
takes those kernels into the update's graph like any other, so every replay
stamps itself; a phase that repeats adds into its sum on the device. The
kernel of a boundary that closes phase C and opens phase O is
``phase_stamp_kernel<C, O>`` (indices into ``PHASES``, -1 for none), so a
device trace finds the stamps by name. On the CPU the same stamps read
``time.perf_counter_ns()``. After each update the loop copies the buffer
into row k of the launch's (K, 3 x phases) rows on the device
(``store``); the trainer drains them with its other copies, once a launch.

The record, kept in memory and keyed by the update index: ``updates[u]``
the phase seconds of update u (``seconds``) and the interval of each
phase's last occurrence in seconds from the update's start (``last``);
``launches[u]`` the host seconds of the spans of the launch that started
with update u (``updates`` its count); ``setup`` the set-up spans.

Off, the clock has no buffer and builds no library, a stamp adds no kernel
(an update's graph has the nodes it has without the clock) and a launch
runs only a flag test more, and its record keeps the set-up spans alone.
``launch.capture`` and ``launch.instantiate`` are timed either way: the
fused loop's ``capture`` reads them.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import os
import time
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import torch

from .build import CSRC, CudaKernel

TRACE_FILE = "trace.json"
PHASES_FILE = "phases.json"
# Chrome-trace categories of device activity.
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
# The device phases of an update, in the order of the clock's buffer (and of
# csrc/phase_stamp.cu's kPhases); a phase's parent is the name before its
# last dot, and ``update`` is the parent of the others without one.
PHASES = ("update", "rollout", "rollout.policy", "rollout.env_step",
          "rollout.env_reset", "rollout.gae", "ppo_update",
          "ppo_update.prepare", "ppo_update.loss", "ppo_update.step",
          "outputs")
SLOT = {name: i for i, name in enumerate(PHASES)}
STAMP_SOURCE = CSRC / "phase_stamp.cu"


@contextlib.contextmanager
def trace(log_dir: str, record_shapes: bool = False
          ) -> Iterator[torch.profiler.profile]:
    from torch.profiler import ProfilerActivity, profile, supported_activities
    activities = [a for a in (ProfilerActivity.CPU, ProfilerActivity.CUDA)
                  if a in supported_activities()]
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities, record_shapes=record_shapes) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def annotate(name: str):
    return torch.profiler.record_function(name)


def _covered(intervals: List[Tuple[float, float]], lo: float, hi: float
             ) -> float:
    """Length of the union of ``intervals`` (sorted by start) within
    [lo, hi]."""
    total, reach = 0.0, lo
    for start, end in intervals:
        start, end = max(start, reach), min(end, hi)
        if end > start:
            total += end - start
            reach = end
    return total


def device_busy(path: str, spans: Sequence[str]) -> Dict[str, Dict[str, float]]:
    """Reads a Chrome trace written by ``trace``. ``spans`` name host spans
    (``annotate``) that run one after another; the first of each name is
    used. Span i's window runs from its start to the next span's start, the
    last one's to the later of its end and the last device activity, so a
    kernel still running when the host enters the next span counts for the
    next. Returns, per span and for ``"total"`` (all windows), the window's
    wall seconds (``wall_s``), the seconds in which the device was busy
    (``busy_s``, the union of its kernel, copy and memset intervals) and
    their ratio (``busy_share``)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    starts, end = {}, 0.0
    device = []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        if ev.get("cat") in DEVICE_CATEGORIES:
            device.append((float(ev["ts"]), float(ev["ts"]) + float(ev["dur"])))
        elif (ev.get("cat") == "user_annotation" and ev.get("name") in spans
              and ev["name"] not in starts):
            starts[ev["name"]] = float(ev["ts"])
            end = max(end, float(ev["ts"]) + float(ev["dur"]))
    missing = [name for name in spans if name not in starts]
    if missing:
        raise ValueError(f"{path}: no span named {missing}")
    device.sort()
    if device:
        end = max(end, max(e for _, e in device))
    bounds = [starts[name] for name in spans] + [end]
    windows = dict(zip(spans, zip(bounds[:-1], bounds[1:])))
    windows["total"] = (bounds[0], end)
    out = {}
    for name, (lo, hi) in windows.items():
        busy = _covered(device, lo, hi)
        out[name] = dict(wall_s=(hi - lo) * 1e-6, busy_s=busy * 1e-6,
                         busy_share=busy / max(hi - lo, 1e-9))
    return out


def parent(name: str) -> Optional[str]:
    """The span a span of the clock sits in (None for the outermost)."""
    if name in ("update", "launch", "setup.trainer"):
        return None
    if name.startswith("setup."):
        return "setup.trainer"
    return name.rsplit(".", 1)[0] if "." in name else "update"


class PhaseStamp(CudaKernel):
    """The stamp kernel (``csrc/phase_stamp.cu``): ``stamp(buffer, close,
    open, phases)`` on the current stream. ``PhaseClock._host_stamp`` is its
    arithmetic on the host."""

    default_source = STAMP_SOURCE
    symbol = "phase_stamp"
    n_pointers = 1
    n_ints = 3

    def __call__(self, buffer: torch.Tensor, close: int, open_: int,
                 phases: int) -> None:
        if (buffer.device.type != "cuda" or buffer.dtype != torch.int64
                or buffer.numel() != 3 * phases):
            raise ValueError("the stamps need an int64 CUDA buffer of 3 x "
                             f"{phases} words")
        self._launch([buffer.data_ptr()], (close, open_, phases),
                     buffer.device)


class Took:
    """The seconds a timed span took (None while it runs or untimed)."""
    seconds: Optional[float] = None


class PhaseClock:
    """The trainer's clock (the module's docstring): on or off for its
    life; on CUDA ``device``'s stamps are kernels."""

    def __init__(self, on: bool = False, device="cpu"):
        self.on = on
        self.setup: Dict[str, float] = {}
        self.launches: Dict[int, Dict[str, float]] = {}
        self.updates: Dict[int, Dict[str, Dict]] = {}
        self._launch: Optional[Dict[str, float]] = None
        self._buffer: Optional[torch.Tensor] = None
        self._rows: Optional[torch.Tensor] = None
        self._kernel = None
        if on:
            device = torch.device(device)
            self._buffer = torch.zeros(3 * len(PHASES), dtype=torch.int64,
                                       device=device)
            if device.type == "cuda":
                self._kernel = PhaseStamp()

    @property
    def kernels(self) -> Tuple[PhaseStamp, ...]:
        """The stamp kernel (on CUDA, with the clock on), or none."""
        return () if self._kernel is None else (self._kernel,)

    # --- device phases -----------------------------------------------------

    def stamp(self, closes: Sequence[str] = (), opens: Sequence[str] = ()
              ) -> None:
        """One phase boundary: closes the phases ``closes`` and opens
        ``opens``, a kernel (or a host stamp) for each pair of them."""
        if self._buffer is None:
            return
        for c, o in itertools.zip_longest([SLOT[p] for p in closes],
                                          [SLOT[p] for p in opens],
                                          fillvalue=-1):
            if self._kernel is not None:
                self._kernel(self._buffer, c, o, len(PHASES))
            else:
                self._host_stamp(c, o)

    def _host_stamp(self, close: int, open_: int) -> None:
        """The stamp kernel's arithmetic on the host's clock."""
        now, buf, P = time.perf_counter_ns(), self._buffer, len(PHASES)
        if close >= 0:
            buf[close] += now - buf[P + close]
            buf[2 * P + close] = now
        if open_ == 0:
            buf[:P] = 0
        if open_ >= 0:
            buf[P + open_] = now

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        """Device phase ``name`` around the block, and its host span."""
        with torch.profiler.record_function(name):
            self.stamp(opens=(name,))
            yield
            self.stamp(closes=(name,))

    def store(self, k: int, K: int) -> None:
        """Copies the stamps of the update just run into row k of the
        launch's K rows, on the device."""
        if self._buffer is None:
            return
        if k == 0:
            self._rows = self._buffer.new_empty((K, self._buffer.numel()))
        self._rows[k].copy_(self._buffer)

    def drain(self, first_update: int) -> None:
        """Copies the launch's rows to the host, as the record of updates
        ``first_update`` on."""
        if self._rows is None:
            return
        rows, self._rows = self._rows.cpu().tolist(), None
        P = len(PHASES)
        for u, row in enumerate(rows, first_update):
            t0 = row[P]                 # the update's open
            last = {name: [(row[P + i] - t0) * 1e-9,
                           (row[2 * P + i] - t0) * 1e-9]
                    for i, name in enumerate(PHASES)
                    if row[2 * P + i] >= row[P + i] >= t0}
            self.updates[u] = dict(
                seconds={name: row[i] * 1e-9 for i, name in enumerate(PHASES)},
                last=last)

    # --- host spans ----------------------------------------------------------

    @contextlib.contextmanager
    def launch(self, first_update: int, updates: int) -> Iterator[None]:
        """Host span ``launch`` of the launch of ``updates`` updates from
        ``first_update``; its spans go into ``launches[first_update]``."""
        with torch.profiler.record_function("launch"):
            if not self.on:
                yield
                return
            record = self.launches[first_update] = dict(updates=updates)
            self._launch = record
            start = time.perf_counter()
            try:
                yield
            finally:
                record["launch"] = time.perf_counter() - start
                self._launch = None

    @contextlib.contextmanager
    def span(self, name: str, always: bool = False) -> Iterator[Took]:
        """Host span ``name`` in the running launch, timed with the clock on
        or ``always``; a name that repeats adds up."""
        took = Took()
        with torch.profiler.record_function(name):
            if not (self.on or always):
                yield took
                return
            start = time.perf_counter()
            yield took
            took.seconds = time.perf_counter() - start
        if self._launch is not None:
            self._launch[name] = self._launch.get(name, 0.0) + took.seconds

    @contextlib.contextmanager
    def setup_span(self, name: str) -> Iterator[None]:
        """Host span ``name`` of the trainer's set-up, timed whether the
        clock is on or off."""
        with torch.profiler.record_function(name):
            start = time.perf_counter()
            yield
            self.setup[name] = (self.setup.get(name, 0.0)
                                + time.perf_counter() - start)

    def record(self) -> dict:
        """The record as plain values: ``setup``, ``launches``,
        ``updates``."""
        return dict(phases=list(PHASES), setup=dict(self.setup),
                    launches={u: dict(r) for u, r in self.launches.items()},
                    updates={u: r for u, r in self.updates.items()})

    def write(self, path: str, **extra) -> None:
        """The record and ``extra`` entries as JSON (``phases.json``)."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(dict(self.record(), **extra), f, indent=1)
