"""The device trace of a short steady window, and its reduction.

``Profile`` runs ``torch.profiler`` (host and CUDA activity) around the
traced work; ``window()`` marks the window as a host span. ``summary()``
reads the profiler's events in memory, with no trace file: the window runs
from the span's start to the later of its end and the last device activity
(a kernel still running when the host leaves the span is the window's); the
device is busy where a kernel, a copy or a memset runs, the union of their
intervals (the arithmetic of the program's ``utils/profiling.device_busy``,
copied); per kernel name its device seconds; and the longest idle gaps of
the device, each named by the innermost host event around its middle. The
idle gaps under the tracer's own buffer handling (``TRACER``) are its cost,
not the program's: ``tracer_s`` sums them, and the per-layer metrics take
them out of the window.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Tuple

import numpy as np
import torch

SPAN = "portbench.window"
TOP = 10
GAPS_NAMED = 500
# Host events of the profiler itself, under which the device waits.
TRACER = ("Buffer Flush", "Activity Buffer Request")


class Profile:
    """A profiler whose events are read in memory: nothing is written."""

    def __init__(self):
        self._prof = None

    def __enter__(self):
        from torch.profiler import (ProfilerActivity, profile,
                                    supported_activities)
        acts = [a for a in (ProfilerActivity.CPU, ProfilerActivity.CUDA)
                if a in supported_activities()]
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        return self._prof.__exit__(*exc)

    def window(self):
        return torch.profiler.record_function(SPAN)

    def summary(self) -> dict:
        events = self._prof.profiler.kineto_results.events()
        device: List[Tuple[int, int, str]] = []
        host: List[Tuple[int, int, str]] = []
        span = None
        for ev in events:
            start, dur = ev.start_ns(), ev.duration_ns()
            if ev.device_type() == torch.autograd.DeviceType.CUDA:
                if dur > 0 and not ev.is_user_annotation():
                    device.append((start, start + dur, ev.name()))
            elif ev.name() == SPAN:
                span = (start, start + dur)
            elif dur > 0:
                host.append((start, start + dur, ev.name()))
        if span is None:
            raise RuntimeError(f"the trace has no span {SPAN!r}")
        return reduce(device, host, span)


def _merged(intervals, lo, hi) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for start, end in intervals:
        start, end = max(start, lo), min(end, hi)
        if end <= start:
            continue
        if out and start <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], end))
        else:
            out.append((start, end))
    return out


def reduce(device, host, span) -> dict:
    """Busy and window seconds, device seconds per kernel name, the top
    device operations and the longest idle gaps by host activity."""
    lo = span[0]
    hi = max([span[1]] + [e for s, e, _ in device if s >= lo])
    device = sorted(d for d in device if d[1] > lo and d[0] < hi)
    busy = _merged([(s, e) for s, e, _ in device], lo, hi)
    by_name: Dict[str, float] = defaultdict(float)
    for s, e, name in device:
        by_name[name] += (min(e, hi) - max(s, lo)) * 1e-9
    gaps = []
    reach = lo
    for s, e in busy + [(hi, hi)]:
        if s > reach:
            gaps.append((s - reach, reach, s))
        reach = max(reach, e)
    gaps.sort(reverse=True)
    h_start = np.array([h[0] for h in host], np.int64)
    h_end = np.array([h[1] for h in host], np.int64)
    idle: Dict[str, float] = defaultdict(float)
    for length, g0, g1 in gaps[:GAPS_NAMED]:
        mid = (g0 + g1) // 2
        around = np.flatnonzero((h_start <= mid) & (h_end >= mid))
        name = (host[around[np.argmin(h_end[around] - h_start[around])]][2]
                if around.size else "none")
        idle[name] += length * 1e-9
    top = lambda d: [[k, v] for k, v in sorted(d.items(),
                                               key=lambda kv: -kv[1])[:TOP]]
    return dict(window_s=(hi - lo) * 1e-9,
                busy_s=sum(e - s for s, e in busy) * 1e-9,
                tracer_s=sum(idle.get(name, 0.0) for name in TRACER),
                kernel_s=dict(by_name),
                device_ops=top(by_name), idle_gaps=top(idle),
                device_events=len(device))


def program_window_s(summary: dict) -> float:
    """The traced window's seconds without the tracer's own stalls."""
    return summary["window_s"] - summary["tracer_s"]


def kernel_seconds(summary: dict, names) -> float:
    """Device seconds of the kernels whose name contains one of ``names``."""
    return sum(s for k, s in summary["kernel_s"].items()
               if any(n in k for n in names))
