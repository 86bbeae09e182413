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
* ``Timer``: per-phase wall-clock totals.

Under data parallelism ``cli.py --profile`` traces rank 0 alone.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, List, Sequence, Tuple

import torch

TRACE_FILE = "trace.json"
# Chrome-trace categories of device activity.
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


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


class Timer:
    """Accumulates wall-clock seconds per named phase. Device work counts
    only if the caller synchronises inside the span."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def span(self, name: str) -> Iterator[None]:
        start = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - start
            self.counts[name] += 1

    def summary(self) -> Dict[str, float]:
        """Mean seconds per span, by name."""
        return {name: self.totals[name] / max(self.counts[name], 1)
                for name in self.totals}
