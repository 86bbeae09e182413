"""Episodic window attention over per-worker K/V timelines.

Counterpart of ``etmppo_tpu/ops/pallas_window_attention.py``. For sample b the
window is ``timeline[w_idx[b], start[b] : start[b] + n_valid[b]]`` followed by
``pe[s_lo[b] + n_valid[b] : s_lo[b] + L]``; per head the output is
``softmax(where(mask, q . K^T, -1e20) / sqrt(D)) . V``.

* ``window_attention_plain`` is the plain PyTorch formulation (the semantics of
  ``xla_window_attention``) and ``window_attention_bwd_plain`` its VJP.
  ``window_attention_grouped_plain`` and ``window_attention_grouped_bwd_plain``
  are the grouped pair's: the minibatch stably sorted by worker
  (``_sorted_by_worker``), the results scattered back, and the backward's
  timeline and PE gradients accumulated in the sorted order.
* Four wrappers of hand-written CUDA kernels, each with its plain version as
  ``plain``: ``WindowAttentionForward`` and ``WindowAttentionBackward``
  (``csrc/window_attention_fwd.cu``, ``csrc/window_attention_bwd.cu``: a CTA
  per sample with all its heads, the window staged through a ring of row
  tiles that TMA bulk copies fill (``csrc/window_ring.cuh``), the backward
  adding into the tables with float4 atomics; ``forward_plan`` and
  ``backward_plan`` choose their launch)
  and the grouped pair
  ``WindowAttentionForwardGrouped`` and ``WindowAttentionBackwardGrouped``
  (``csrc/window_attention_fwd_grouped.cu``,
  ``csrc/window_attention_bwd_grouped.cu``: the minibatch sorted by (worker,
  start) on the card, a CTA per run of sorted samples of one worker staging
  the union of their windows once through the same ring in range mode
  (``csrc/window_runs.cuh``); the backward free of atomics and bit-for-bit
  repeatable; ``grouped_forward_plan`` and ``grouped_backward_plan`` choose
  their launch, and ``grouped_order``, ``grouped_runs``, ``run_tiles`` and
  ``reduce_candidates`` state their walk in Python for the CPU tests). nvcc
  builds each at first use into a shared library with a plain C interface,
  loaded with ctypes; each keeps a count of its launches.
* ``window_attention`` is the autograd op. The caller picks the forward
  (``kernel``) and the backward (``backward_kernel``) per call, which mirrors
  the JAX package's ``GROUPED_MODE`` and ``BACKWARD_MODE`` switches: the
  per-sample or the grouped forward; the matching backward kernel
  (``BACKWARD_MODE = "pallas"``), or None for the plain VJP (``"xla"``). CUDA
  tensors launch the kernels; CPU tensors take each kernel's plain version. A
  kernel of None is the plain version on either device.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import math
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import NamedTuple, Optional, Sequence

import torch

MASK_FILL = -1e20

_PACKAGE_DIR = Path(__file__).resolve().parent.parent
FWD_SOURCE = _PACKAGE_DIR / "csrc" / "window_attention_fwd.cu"
BWD_SOURCE = _PACKAGE_DIR / "csrc" / "window_attention_bwd.cu"
FWD_GROUPED_SOURCE = _PACKAGE_DIR / "csrc" / "window_attention_fwd_grouped.cu"
BWD_GROUPED_SOURCE = _PACKAGE_DIR / "csrc" / "window_attention_bwd_grouped.cu"
BUILD_DIR = _PACKAGE_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# Launch limits of the per-sample kernels: shared memory a CTA may have on
# sm_90 (227 KB), the most that lets two CTAs share an SM's 228 KB (each
# holds 1 KB back), and the kernels' __launch_bounds__.
SMEM_LIMIT = 232448
SMEM_TWO_PER_SM = (233472 - 2 * 1024) // 2
MAX_THREADS = 512


def window_attention_plain(q, timeline_k, timeline_v, pe_k, pe_v, w_idx, start,
                           n_valid, s_lo, mask, num_heads: int):
    """q: (B, D); timeline_k/v: (W, S, D); pe_k/v: (P, D); w_idx, start,
    n_valid, s_lo: (B,) int; mask: (B, L) bool. Returns (B, D)."""
    B, D = q.shape
    L = mask.shape[1]
    head = D // num_heads
    offs = torch.arange(L, device=q.device)
    rows = start.long()[:, None] + offs[None, :]
    w = w_idx.long()[:, None]
    pe_rows = s_lo.long()[:, None] + offs[None, :]
    valid = (offs[None, :] < n_valid.long()[:, None])[:, :, None]
    k = torch.where(valid, timeline_k[w, rows], pe_k[pe_rows])
    v = torch.where(valid, timeline_v[w, rows], pe_v[pe_rows])
    energy = torch.einsum("bhd,blhd->bhl", q.reshape(B, num_heads, head),
                          k.reshape(B, L, num_heads, head))
    energy = energy.masked_fill(~mask.bool()[:, None, :], MASK_FILL)
    attention = torch.softmax(energy / math.sqrt(D), dim=-1)
    out = torch.einsum("bhl,blhd->bhd", attention,
                       v.reshape(B, L, num_heads, head))
    return out.reshape(B, D)


def window_attention_bwd_plain(q, timeline_k, timeline_v, pe_k, pe_v, w_idx,
                              start, n_valid, s_lo, mask, g, num_heads: int,
                              needs_grad: Sequence[bool] = (True,) * 5):
    """VJP of ``window_attention_plain`` for the output gradient g (B, D).
    Returns (dq, dtk, dtv, dpk, dpv), shaped like (q, timeline_k, timeline_v,
    pe_k, pe_v); an entry whose ``needs_grad`` is False is None."""
    diff = [t.detach().requires_grad_(bool(need)) for t, need in
            zip((q, timeline_k, timeline_v, pe_k, pe_v), needs_grad)]
    wanted = [t for t in diff if t.requires_grad]
    grads = iter(())
    if wanted:
        with torch.enable_grad():
            out = window_attention_plain(*diff, w_idx, start, n_valid, s_lo,
                                         mask, num_heads)
            grads = iter(torch.autograd.grad(out, wanted, g))
    return tuple(next(grads) if t.requires_grad else None for t in diff)


def _sorted_by_worker(w_idx, *tensors):
    """A stable sort of the minibatch by worker (counterpart of
    ``_sorted_by_worker``): the order, and each tensor taken in it."""
    order = torch.sort(w_idx, stable=True).indices
    return order, [t[order] for t in tensors]


def _scatter_back(order, rows_sorted):
    out = torch.empty_like(rows_sorted)
    out[order] = rows_sorted
    return out


def window_attention_grouped_plain(q, timeline_k, timeline_v, pe_k, pe_v,
                                   w_idx, start, n_valid, s_lo, mask,
                                   num_heads: int):
    """The grouped forward's plain version: ``window_attention_plain`` on the
    minibatch sorted by worker, scattered back to the original order."""
    order, (w_s, start_s, n_s, slo_s, q_s, mask_s) = _sorted_by_worker(
        w_idx, w_idx, start, n_valid, s_lo, q, mask)
    out_s = window_attention_plain(q_s, timeline_k, timeline_v, pe_k, pe_v,
                                   w_s, start_s, n_s, slo_s, mask_s, num_heads)
    return _scatter_back(order, out_s)


def window_attention_grouped_bwd_plain(q, timeline_k, timeline_v, pe_k, pe_v,
                                       w_idx, start, n_valid, s_lo, mask, g,
                                       num_heads: int,
                                       needs_grad: Sequence[bool] = (True,) * 5):
    """The grouped backward's plain version, written out: p and ds per sample
    of the minibatch sorted by worker, then dK = ds q and dV = p g added into
    the timeline and PE tables with ``index_add_`` in that order (sequential,
    so deterministic, on the CPU). Returns (dq, dtk, dtv, dpk, dpv) like
    ``window_attention_bwd_plain``."""
    B, D = q.shape
    W, S, _ = timeline_k.shape
    P = pe_k.shape[0]
    L = mask.shape[1]
    H, hd = num_heads, D // num_heads
    order, (w_s, start_s, n_s, slo_s, q_s, mask_s, g_s) = _sorted_by_worker(
        w_idx, w_idx, start, n_valid, s_lo, q, mask, g)
    offs = torch.arange(L, device=q.device)
    rows = (w_s.long() * S + start_s.long())[:, None] + offs     # (B, L)
    pe_rows = slo_s.long()[:, None] + offs
    valid = offs < n_s.long()[:, None]
    flat_k = timeline_k.reshape(W * S, D)
    flat_v = timeline_v.reshape(W * S, D)
    k = torch.where(valid[..., None], flat_k[rows], pe_k[pe_rows])
    v = torch.where(valid[..., None], flat_v[rows], pe_v[pe_rows])
    qh, gh = q_s.reshape(B, H, hd), g_s.reshape(B, H, hd)
    kh, vh = k.reshape(B, L, H, hd), v.reshape(B, L, H, hd)
    masked = ~mask_s.bool()[:, None, :]
    energy = torch.einsum("bhd,blhd->bhl", qh, kh).masked_fill(masked,
                                                               MASK_FILL)
    p = torch.softmax(energy / math.sqrt(D), dim=-1)
    dp = torch.einsum("bhd,blhd->bhl", gh, vh)
    ds = (p * (dp - (p * dp).sum(-1, keepdim=True))
          / math.sqrt(D)).masked_fill(masked, 0.0)
    dq = _scatter_back(order, torch.einsum("bhl,blhd->bhd", ds, kh).reshape(
        B, D))
    dk = torch.einsum("bhl,bhd->blhd", ds, qh).reshape(B, L, D)
    dv = torch.einsum("bhl,bhd->blhd", p, gh).reshape(B, L, D)

    def accumulate(n_rows, idx, values):
        return torch.zeros(n_rows, D, dtype=q.dtype,
                           device=q.device).index_add_(0, idx, values)

    dtk = accumulate(W * S, rows[valid], dk[valid]).reshape(W, S, D)
    dtv = accumulate(W * S, rows[valid], dv[valid]).reshape(W, S, D)
    dpk = accumulate(P, pe_rows[~valid], dk[~valid])
    dpv = accumulate(P, pe_rows[~valid], dv[~valid])
    return tuple(t if need else None for t, need in
                 zip((dq, dtk, dtv, dpk, dpv), needs_grad))


# Tiles in the kernels' ring (kStages in csrc/window_ring.cuh) and the floats
# before it that hold the ring's barriers (kBarFloats).
RING_STAGES = 2
RING_BAR_FLOATS = 8


class ForwardPlan(NamedTuple):
    """How ``csrc/window_attention_fwd.cu`` is launched: a CTA per sample with
    a warp per head (``threads``), walking the window in tiles of
    ``rows_per_tile`` rows in ``smem_bytes`` of dynamic shared memory. Passed
    to the kernel as ints in this order; the kernel refuses a plan it cannot
    run."""
    rows_per_tile: int
    threads: int
    smem_bytes: int


class BackwardPlan(NamedTuple):
    """How ``csrc/window_attention_bwd.cu`` is launched: a CTA per sample with
    ``warps_per_head`` warps for each head, walking the window in tiles of
    ``rows_per_tile`` rows (each warp takes ``rows_per_tile //
    warps_per_head`` of them) in ``smem_bytes`` of dynamic shared memory.
    Passed to the kernel as ints in this order."""
    rows_per_tile: int
    warps_per_head: int
    threads: int
    smem_bytes: int


def _ring_floats(D: int, rows: int) -> int:
    """Floats of the ring's barriers and its K and V row tiles (rows padded
    to a multiple of 4 floats, plus 4)."""
    return RING_BAR_FLOATS + RING_STAGES * 2 * rows * ((D + 3) // 4 * 4 + 4)


def forward_smem_bytes(D: int, rows: int) -> int:
    """Dynamic shared memory of one forward CTA, as the kernel's
    ``smem_floats`` counts it: the ring, q and the output sums."""
    return 4 * (_ring_floats(D, rows) + (D + 3) // 4 * 4 + D)


def backward_smem_bytes(L: int, D: int, H: int, rows: int, wph: int) -> int:
    """Dynamic shared memory of one backward CTA: the ring, q and g, each
    warp's sums A1 and A2, the scores and dp of every (head, row), and each
    warp's running statistics."""
    d4 = (D + 3) // 4 * 4
    return 4 * (_ring_floats(D, rows) + 2 * d4 + 2 * wph * D + 2 * H * L
                + 3 * H * wph)


def _first_fit(rows_choices, smem_of, L: int, D: int, H: int):
    """The first choice of tile (rows per tile, or for the grouped kernels
    (rows, ring depth)) whose shared memory lets two CTAs share an SM, else
    the first that fits one CTA: (choice, bytes). Raises where none fits."""
    for limit in (SMEM_TWO_PER_SM, SMEM_LIMIT):
        for rows in rows_choices:
            smem = smem_of(rows)
            if smem <= limit:
                return rows, smem
    raise ValueError(f"no launch plan fits L={L}, D={D}, H={H} into "
                     f"{SMEM_LIMIT} bytes of shared memory")


def _check_threads(threads: int, H: int) -> None:
    if threads > MAX_THREADS:
        raise ValueError(f"{H} heads need {threads} threads a CTA, over "
                         f"{MAX_THREADS}")


def forward_plan(L: int, D: int, H: int) -> ForwardPlan:
    """The launch plan of ``csrc/window_attention_fwd.cu`` for a window of L
    rows of width D over H heads: a warp per head and tiles of at most 8
    rows, so that several small CTAs share an SM."""
    threads = H * 32
    _check_threads(threads, H)
    rows, smem = _first_fit((8, 4, 2, 1), lambda r: forward_smem_bytes(D, r),
                            L, D, H)
    return ForwardPlan(rows, threads, smem)


def backward_plan(L: int, D: int, H: int) -> BackwardPlan:
    """The launch plan of ``csrc/window_attention_bwd.cu``. It does twice the
    forward's work per row: about 8 warps a CTA (a power of 2 per head) and
    tiles of at most 32 rows."""
    wph = 1
    while H * wph * 2 <= 8:
        wph *= 2
    threads = H * wph * 32
    _check_threads(threads, H)
    choices = [wph * r for r in (32, 16, 8, 4, 2, 1) if wph * r <= 32]
    rows, smem = _first_fit(
        choices, lambda r: backward_smem_bytes(L, D, H, r, wph), L, D, H)
    return BackwardPlan(rows, wph, threads, smem)


# The grouped kernels' runs (csrc/window_runs.cuh): ints of a run's head and
# fields per sample in shared memory, and the table rows per CTA of the
# backward's pass 2 (kRows in csrc/window_attention_bwd_grouped.cu).
RUN_HEAD = 8
RUN_FIELDS = 5
REDUCE_ROWS = 8


class GroupedPlan(NamedTuple):
    """How a grouped kernel (``csrc/window_attention_fwd_grouped.cu``, pass 1
    of ``csrc/window_attention_bwd_grouped.cu``) is launched: a CTA per run
    of up to ``samples_per_run`` sorted samples of one worker, a warp per
    head and four samples (``threads`` = 8 * H * samples_per_run), the
    union of the run's windows staged in tiles of ``rows_per_tile`` table
    rows through a ring of ``ring_depth`` tiles in ``smem_bytes`` of dynamic
    shared memory. Passed to the kernel as ints in this order; the kernel
    refuses a plan it cannot run."""
    samples_per_run: int
    rows_per_tile: int
    ring_depth: int
    threads: int
    smem_bytes: int


def _run_ints(R: int, L: int, rows: int) -> int:
    """Ints of a run's setup: the head, R samples' fields, and the tile list
    (a window of L rows meets at most ceil(L / rows) + 1 tiles of a table)."""
    return RUN_HEAD + RUN_FIELDS * R + 2 * R * (-(-L // rows) + 1)


def grouped_forward_smem_bytes(L: int, D: int, R: int, rows: int,
                               depth: int) -> int:
    """Dynamic shared memory of one grouped forward CTA, as the kernel's
    ``fwd_grouped_smem`` counts it: the ring's barriers and its ``depth``
    tiles of K and V rows (D floats apart, as in their tables), the run's
    ints and its mask rows (padded to 16 bytes)."""
    ring = RING_BAR_FLOATS + depth * 2 * rows * D
    return 4 * ring + 4 * _run_ints(R, L, rows) + (R * L + 15) // 16 * 16


def grouped_backward_smem_bytes(L: int, D: int, H: int, R: int, rows: int,
                                depth: int) -> int:
    """Dynamic shared memory of one CTA of the grouped backward's first
    pass (``bwd_grouped_smem``): the forward's, q and g of the run's samples
    (rows padded as the ring's), the scores and dp' of every (sample, head,
    row), and (m, Z, C/Z) of every (sample, head)."""
    return (grouped_forward_smem_bytes(L, D, R, rows, depth)
            + 4 * (2 * R * ((D + 3) // 4 * 4 + 4) + R * H * (2 * L + 3)))


# (rows per tile, ring depth) in the order the grouped plans try them: tiles
# of whole chunks of 8 rows (the kernels walk 8 rows at a time); 16-row
# tiles two deep where two CTAs still share an SM (half the block-wide
# barriers of 8-row tiles: 3-8% faster on the card), else 8-row tiles four
# or two deep (the kernels take depths 2 and 4).
GROUPED_TILES = ((16, 2), (8, 4), (8, 2))
# The widest head the grouped kernels take (kMaxHeadWidth in
# csrc/window_runs.cuh; every shipped configuration's is 64 to 128).
GROUPED_MAX_HEAD_WIDTH = 128


def _grouped_plan(L: int, D: int, H: int, smem_of) -> GroupedPlan:
    """smem_of(R, rows, depth) is the kernel's shared memory in bytes. Runs
    of 8 samples where a CTA of a warp per (head, four samples)
    stays within the thread limit, else of 4; the first (rows, depth) of
    GROUPED_TILES that lets two CTAs share an SM, else the first that fits
    one. A run of 8 samples of one worker, about 8 rows apart in a random
    eighth of a rollout, spans about 7 * 8 + L rows, so each staged row
    serves about 8 windows; B / 8 runs still give about one CTA per SM at
    the smallest shipped minibatch (1024)."""
    if D // H > GROUPED_MAX_HEAD_WIDTH:
        raise ValueError(f"the grouped kernels take head widths up to "
                         f"{GROUPED_MAX_HEAD_WIDTH}, got {D // H}")
    for R in (8, 4):
        threads = 8 * H * R
        if threads <= MAX_THREADS:
            break
    _check_threads(threads, H)
    (rows, depth), smem = _first_fit(
        GROUPED_TILES, lambda rd: smem_of(R, *rd), L, D, H)
    return GroupedPlan(R, rows, depth, threads, smem)


@functools.lru_cache(maxsize=None)
def grouped_forward_plan(L: int, D: int, H: int) -> GroupedPlan:
    """The launch plan of ``csrc/window_attention_fwd_grouped.cu``."""
    return _grouped_plan(L, D, H, lambda R, rows, depth:
                         grouped_forward_smem_bytes(L, D, R, rows, depth))


@functools.lru_cache(maxsize=None)
def grouped_backward_plan(L: int, D: int, H: int) -> GroupedPlan:
    """The launch plan of the first pass of
    ``csrc/window_attention_bwd_grouped.cu``."""
    return _grouped_plan(L, D, H, lambda R, rows, depth:
                         grouped_backward_smem_bytes(L, D, H, R, rows, depth))


# The grouped kernels' walk, in Python (the CPU tests hold it to its
# contract; the card runs csrc/window_runs.cuh).

def grouped_order(w_idx, start, W: int):
    """The grouped kernels' sort: the minibatch stably sorted by (worker
    clamped to [0, W), start). Returns (order, seg): the sorted rows, and the
    first sorted position of each worker 0..W."""
    w = w_idx.long().clamp(0, W - 1)
    key = w * 2 ** 32 + (start.long() + 2 ** 31)
    order = torch.sort(key, stable=True).indices
    seg = torch.searchsorted(w[order], torch.arange(W + 1, device=w.device))
    return order, seg


def grouped_runs(seg, R: int) -> list:
    """The run of each CTA x of the grouped kernels, (w, j0, j1) for sorted
    samples [j0, j1) of worker w, or None where x has none: worker w's
    segment is cut into runs of R, and run c goes to CTA seg[w] // R + w + c,
    of ceil(B / R) + W CTAs."""
    seg = [int(v) for v in seg]
    W, B = len(seg) - 1, seg[-1]
    runs = []
    for x in range(-(-B // R) + W):
        w = max(v for v in range(W) if seg[v] // R + v <= x)
        j0 = seg[w] + (x - (seg[w] // R + w)) * R
        runs.append((w, j0, min(j0 + R, seg[w + 1])) if j0 < seg[w + 1]
                    else None)
    return runs


def _span(base: int, la: int, lb: int, n: int):
    """Window rows [la, lb) of one table: (rows(l), first_at(x))."""
    row = lambda l: min(max(base + l, 0), n - 1)

    def first_at(x):
        if x <= 0:
            return la
        if x > n - 1:
            return lb
        return min(max(x - base, la), lb)
    return row, first_at


def run_tiles(samples, S: int, P: int, L: int, rows: int):
    """A run's walk: samples is a list of (start, n_valid, s_lo). Returns the
    tiles (table, first row, rows; table 0 the worker's timeline, 1 the PE
    table) of the union of the windows in the order the ring stages them,
    skipping tiles that no window meets, and for each tile the window rows l
    each sample takes from it, with the tile row each reads."""
    spans = []
    for st, nv, slo in samples:
        nv = min(max(nv, 0), L)
        spans.append(((st, 0, nv, S), (slo, nv, L, P)))
    tiles, taken = [], []
    for table in (0, 1):
        own = [sp[table] for sp in spans if sp[table][1] < sp[table][2]]
        rows_of = [(_span(*sp)[0](sp[1]), _span(*sp)[0](sp[2] - 1) + 1)
                   for sp in own]
        if not rows_of:
            continue
        lo = min(a for a, _ in rows_of)
        hi = max(b for _, b in rows_of)
        for r0 in range(lo, hi, rows):
            r1 = min(r0 + rows, hi)
            if not any(a < r1 and b > r0 for a, b in rows_of):
                continue
            tiles.append((table, r0, r1 - r0))
            per_sample = []
            for sp in spans:
                row, first_at = _span(*sp[table])
                per_sample.append([(l, row(l) - r0) for l in
                                   range(first_at(r0), first_at(r1))])
            taken.append(per_sample)
    return tiles, taken


def reduce_candidates(sorted_start, seg, w: int, t0: int, L: int,
                      rows: int = REDUCE_ROWS):
    """The sorted samples [j_lo, j_hi) that pass 2 of the grouped backward
    visits for rows [t0, t0 + rows) of worker w's timeline: those of the
    worker's segment with start in [t0 - L + 1, t0 + rows)."""
    s0, s1 = int(seg[w]), int(seg[w + 1])
    starts = [int(v) for v in sorted_start[s0:s1]]
    return (s0 + sum(st < t0 - L + 1 for st in starts),
            s0 + sum(st < t0 + rows for st in starts))


class _CudaKernel:
    """A CUDA source built by nvcc on first use into a shared library with a
    plain C interface, loaded with ctypes. Subclasses launch it on the current
    stream and count each launch in ``launches``."""

    symbol = ""
    n_pointers = 0
    n_ints = 7

    def __init__(self, source: Path, build_dir: Path = BUILD_DIR):
        self.source = Path(source)
        self.build_dir = Path(build_dir)
        self.launches = 0
        self._lib = None

    def library_path(self) -> Path:
        """The library's path, keyed by the source, the headers it includes
        from its own directory and nvcc's flags."""
        text = self.source.read_bytes()
        headers = re.findall(rb'#include "([^"]+)"', text)
        digest = hashlib.sha256(
            text + b"".join((self.source.parent / h.decode()).read_bytes()
                            for h in headers)
            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        return self.build_dir / f"{self.source.stem}_{digest}.so"

    def build(self) -> Path:
        """Compiles the source with nvcc unless a library built from the same
        source and flags is already there, keeping nvcc's report (``-Xptxas
        -v``) beside it. Returns the library's path."""
        out = self.library_path()
        if out.exists():
            return out
        nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
        if not os.path.exists(nvcc):
            raise RuntimeError(f"nvcc not found: {self.source.name} cannot "
                               "be built")
        self.build_dir.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=self.build_dir)
        os.close(fd)
        try:
            proc = subprocess.run(
                [nvcc, *NVCC_FLAGS, "-o", tmp, str(self.source)],
                capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed on {self.source.name} ({proc.returncode}):"
                    f"\n{proc.stdout}{proc.stderr}")
            self._report_path(out).write_text(proc.stdout + proc.stderr)
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        return out

    @staticmethod
    def _report_path(library: Path) -> Path:
        return library.with_suffix(".ptxas.txt")

    def resources(self) -> list:
        """Registers, spills and static shared memory of each kernel function
        in the built library, from nvcc's report: a list of dicts."""
        text = self._report_path(self.build()).read_text()
        found = []
        for chunk in text.split("Compiling entry function")[1:]:
            name = chunk.split("'")[1]
            nums = lambda pattern: [int(x) for x in re.findall(pattern, chunk)]
            regs = nums(r"Used (\d+) registers")
            spills = nums(r"(\d+) bytes spill (?:stores|loads)")
            smem = nums(r"(\d+) bytes smem")
            found.append(dict(function=name, registers=regs[0] if regs else 0,
                              spill_bytes=sum(spills),
                              static_smem=smem[0] if smem else 0))
        return found

    def load(self) -> None:
        """Builds the library if needed and loads it (the trainer does so
        while it is set up, before its first launch)."""
        self._function()

    def _function(self):
        if self._lib is None:
            lib = ctypes.CDLL(str(self.build()))
            fn = getattr(lib, self.symbol)
            fn.argtypes = [ctypes.c_void_p] * self.n_pointers + [
                ctypes.c_int] * self.n_ints + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            self._lib = lib
        return getattr(self._lib, self.symbol)

    def _launch(self, pointers, ints, device) -> None:
        stream = torch.cuda.current_stream(device).cuda_stream
        err = self._function()(*pointers, *ints, stream)
        if err != 0:
            raise RuntimeError(
                f"{self.symbol} launch failed: CUDA error {err}")
        self.launches += 1


class WindowAttentionForward(_CudaKernel):
    """The CUDA forward kernel, a CTA per sample with all its heads: out
    (B, D). ``forward_plan`` chooses the launch."""

    symbol = "window_attention_fwd"
    n_pointers = 11
    n_ints = 7 + len(ForwardPlan._fields)
    plain = staticmethod(window_attention_plain)

    def __init__(self, source: Path = FWD_SOURCE,
                 build_dir: Path = BUILD_DIR):
        super().__init__(source, build_dir)

    def __call__(self, q, timeline_k, timeline_v, pe_k, pe_v, w_idx, start,
                 n_valid, s_lo, mask, num_heads: int) -> torch.Tensor:
        inputs = (q, timeline_k, timeline_v, pe_k, pe_v, w_idx, start,
                  n_valid, s_lo, mask)
        B, D = _check_inputs(*inputs, num_heads)
        W, S, _ = timeline_k.shape
        L = mask.shape[1]
        plan = forward_plan(L, D, num_heads)
        out = torch.empty_like(q)
        self._launch([t.data_ptr() for t in inputs + (out,)],
                     (B, W, S, pe_k.shape[0], L, D, num_heads, *plan),
                     q.device)
        return out


class WindowAttentionBackward(_CudaKernel):
    """The CUDA backward kernel, a CTA per sample with all its heads: (dq,
    dtk, dtv, dpk, dpv) for the output gradient g. ``backward_plan`` chooses
    the launch. The gradient tables are zeroed on the current stream, then
    the kernel adds into them with float4 atomics, so their last bits vary
    from run to run (``WindowAttentionBackwardGrouped`` is the deterministic
    alternative)."""

    symbol = "window_attention_bwd"
    n_pointers = 16
    n_ints = 7 + len(BackwardPlan._fields)
    plain = staticmethod(window_attention_bwd_plain)

    def __init__(self, source: Path = BWD_SOURCE,
                 build_dir: Path = BUILD_DIR):
        super().__init__(source, build_dir)

    def __call__(self, q, timeline_k, timeline_v, pe_k, pe_v, w_idx, start,
                 n_valid, s_lo, mask, g, num_heads: int):
        inputs = (q, timeline_k, timeline_v, pe_k, pe_v, w_idx, start,
                  n_valid, s_lo, mask)
        B, D = _check_inputs(*inputs, num_heads)
        _check_grad(g, q)
        W, S, _ = timeline_k.shape
        L = mask.shape[1]
        plan = backward_plan(L, D, num_heads)
        dq = torch.empty_like(q)
        grads = _zeroed_like(timeline_k, timeline_v, pe_k, pe_v)
        self._launch([t.data_ptr() for t in inputs + (g, dq, *grads)],
                     (B, W, S, pe_k.shape[0], L, D, num_heads, *plan),
                     q.device)
        return (dq, *grads)


class WindowAttentionForwardGrouped(_CudaKernel):
    """The grouped CUDA forward: out (B, D). One call launches the sort of
    the minibatch by (worker, start) on the card and then the kernel, a CTA
    per run of sorted samples of one worker (``grouped_forward_plan``); each
    output goes straight to its own row."""

    symbol = "window_attention_fwd_grouped"
    n_pointers = 13
    n_ints = 7 + len(GroupedPlan._fields)
    plain = staticmethod(window_attention_grouped_plain)

    def __init__(self, source: Path = FWD_GROUPED_SOURCE,
                 build_dir: Path = BUILD_DIR):
        super().__init__(source, build_dir)

    def __call__(self, q, timeline_k, timeline_v, pe_k, pe_v, w_idx, start,
                 n_valid, s_lo, mask, num_heads: int) -> torch.Tensor:
        inputs = (q, timeline_k, timeline_v, pe_k, pe_v, w_idx, start,
                  n_valid, s_lo, mask)
        B, D = _check_inputs(*inputs, num_heads)
        W, S, _ = timeline_k.shape
        L = mask.shape[1]
        plan = grouped_forward_plan(L, D, num_heads)
        # The sort's int32 scratch, meta (5, B) and seg (W + 1), in one
        # buffer, freed when this returns; the caching allocator gives its
        # memory only to later work on this stream.
        scratch = torch.empty(5 * B + W + 1, dtype=torch.int32,
                              device=q.device)
        meta = scratch.data_ptr()
        out = torch.empty_like(q)
        self._launch([t.data_ptr() for t in inputs] + [meta, meta + 20 * B]
                     + [out.data_ptr()],
                     (B, W, S, pe_k.shape[0], L, D, num_heads, *plan),
                     q.device)
        return out

    def sort(self, w_idx, start, n_valid, s_lo, W: int):
        """The kernels' sort alone, on the card (not counted as a launch):
        meta (5, B), the sorted samples' (row, w_idx, start, n_valid, s_lo),
        and seg (W + 1,), each worker's first sorted position."""
        B = w_idx.shape[0]
        buf = torch.empty(5 * B + W + 1, dtype=torch.int32,
                          device=w_idx.device)
        meta, seg = buf[:5 * B], buf[5 * B:]
        self._function()
        fn = self._lib.window_attention_grouped_sort
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        stream = torch.cuda.current_stream(w_idx.device).cuda_stream
        err = fn(*(t.data_ptr() for t in (w_idx, start, n_valid, s_lo, meta,
                                          seg)), B, W, stream)
        if err != 0:
            raise RuntimeError(f"window_attention_grouped_sort launch "
                               f"failed: CUDA error {err}")
        return meta.view(5, B), seg


class WindowAttentionBackwardGrouped(_CudaKernel):
    """The grouped, deterministic CUDA backward: (dq, dtk, dtv, dpk, dpv) for
    the output gradient g. No float is added atomically and every entry is
    summed in one fixed order (the minibatch sorted by (worker, start)), so
    two calls on one input return the same bits. One call launches the sort
    and the kernel's three passes and counts as one launch;
    ``grouped_backward_plan`` chooses the first pass's launch."""

    symbol = "window_attention_bwd_grouped"
    n_pointers = 22
    n_ints = 7 + len(GroupedPlan._fields)
    plain = staticmethod(window_attention_grouped_bwd_plain)

    def __init__(self, source: Path = BWD_GROUPED_SOURCE,
                 build_dir: Path = BUILD_DIR):
        super().__init__(source, build_dir)
        self._pe_chunk = None

    def pe_chunk(self) -> int:
        """Sorted samples per partial PE-gradient sum, as the source sets."""
        if self._pe_chunk is None:
            self._function()
            fn = self._lib.window_attention_bwd_grouped_pe_chunk
            fn.argtypes = []
            fn.restype = ctypes.c_int
            self._pe_chunk = int(fn())
        return self._pe_chunk

    def __call__(self, q, timeline_k, timeline_v, pe_k, pe_v, w_idx, start,
                 n_valid, s_lo, mask, g, num_heads: int):
        inputs = (q, timeline_k, timeline_v, pe_k, pe_v, w_idx, start,
                  n_valid, s_lo, mask)
        B, D = _check_inputs(*inputs, num_heads)
        _check_grad(g, q)
        W, S, _ = timeline_k.shape
        P, L = pe_k.shape[0], mask.shape[1]
        H = num_heads
        plan = grouped_backward_plan(L, D, H)
        chunks = -(-B // self.pe_chunk())
        # One scratch buffer, each part starting 16-byte aligned, passed as
        # addresses: the sort's int32 meta (5, B) and seg (W + 1), then
        # float32 probs, dscores (B, H, L) and part_k, part_v (chunks, P, D).
        sizes = [(n + 3) // 4 * 4 for n in (5 * B, W + 1, B * H * L,
                                            B * H * L, chunks * P * D,
                                            chunks * P * D)]
        scratch = torch.empty(sum(sizes), dtype=torch.float32,
                              device=q.device)
        base, parts = scratch.data_ptr(), []
        for size in sizes:
            parts.append(base)
            base += 4 * size
        grads = [torch.empty_like(t) for t in
                 (q, timeline_k, timeline_v, pe_k, pe_v)]
        # The scratch is freed when this returns; the caching allocator gives
        # its memory only to later work on this stream.
        self._launch([t.data_ptr() for t in inputs + (g,)] + parts
                     + [t.data_ptr() for t in grads],
                     (B, W, S, P, L, D, H, *plan), q.device)
        return tuple(grads)


def _zeroed_like(*tensors) -> list:
    """Zeroed float32 tensors shaped like ``tensors``: views of one buffer
    that a single fill zeroes, each starting 16-byte aligned."""
    sizes = [(t.numel() + 3) // 4 * 4 for t in tensors]
    buf = torch.zeros(sum(sizes), dtype=torch.float32,
                      device=tensors[0].device)
    views = buf.split(sizes)
    return [v[:t.numel()].view(t.shape) for v, t in zip(views, tensors)]


def _check_inputs(q, timeline_k, timeline_v, pe_k, pe_v, w_idx, start,
                  n_valid, s_lo, mask, num_heads: int):
    """Raises unless the inputs are what the CUDA kernel takes."""
    tensors = dict(q=q, timeline_k=timeline_k, timeline_v=timeline_v,
                   pe_k=pe_k, pe_v=pe_v, w_idx=w_idx, start=start,
                   n_valid=n_valid, s_lo=s_lo, mask=mask)
    for name, t in tensors.items():
        if t.device != q.device or t.device.type != "cuda":
            raise ValueError(f"{name} must be on q's CUDA device, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name in ("q", "timeline_k", "timeline_v", "pe_k", "pe_v"):
        if tensors[name].dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {tensors[name].dtype}")
    for name in ("w_idx", "start", "n_valid", "s_lo"):
        if tensors[name].dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {tensors[name].dtype}")
    if mask.dtype not in (torch.bool, torch.uint8):
        raise ValueError(f"mask must be bool or uint8, got {mask.dtype}")
    if q.dim() != 2:
        raise ValueError(f"q must be (B, D), got {tuple(q.shape)}")
    B, D = q.shape
    if D % num_heads != 0:
        raise ValueError(f"D={D} is not divisible by num_heads={num_heads}")
    if (timeline_k.dim() != 3 or timeline_k.shape[2] != D
            or timeline_v.shape != timeline_k.shape):
        raise ValueError("timeline_k/v must both be (W, S, D)")
    if pe_k.dim() != 2 or pe_k.shape[1] != D or pe_v.shape != pe_k.shape:
        raise ValueError("pe_k/v must both be (P, D)")
    for name in ("w_idx", "start", "n_valid", "s_lo"):
        if tensors[name].shape != (B,):
            raise ValueError(f"{name} must be ({B},)")
    if mask.dim() != 2 or mask.shape[0] != B:
        raise ValueError(f"mask must be ({B}, L)")
    return B, D


def _check_grad(g, q) -> None:
    if (g.device != q.device or g.dtype != torch.float32
            or g.shape != q.shape or not g.is_contiguous()):
        raise ValueError("g must be a contiguous float32 tensor shaped "
                         "and placed like q")


window_attention_fwd = WindowAttentionForward()
window_attention_bwd = WindowAttentionBackward()
window_attention_fwd_grouped = WindowAttentionForwardGrouped()
window_attention_bwd_grouped = WindowAttentionBackwardGrouped()


class _WindowAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, timeline_k, timeline_v, pe_k, pe_v, w_idx, start,
                n_valid, s_lo, mask, num_heads, kernel, backward_kernel):
        ctx.save_for_backward(q, timeline_k, timeline_v, pe_k, pe_v, w_idx,
                              start, n_valid, s_lo, mask)
        ctx.num_heads = num_heads
        ctx.backward_kernel = backward_kernel
        args = (q, timeline_k, timeline_v, pe_k, pe_v, w_idx, start, n_valid,
                s_lo, mask, num_heads)
        if kernel is None:
            return window_attention_plain(*args)
        if q.device.type == "cpu":
            return kernel.plain(*args)
        return kernel(*args)

    @staticmethod
    def backward(ctx, grad_out):
        saved = ctx.saved_tensors
        needs = ctx.needs_input_grad[:5]
        kernel = ctx.backward_kernel
        if not any(needs):
            grads = (None,) * 5
        elif kernel is None:
            grads = window_attention_bwd_plain(*saved, grad_out,
                                               ctx.num_heads, needs)
        elif saved[0].device.type == "cpu":
            grads = kernel.plain(*saved, grad_out, ctx.num_heads, needs)
        else:
            grads = kernel(*saved, grad_out.contiguous(), ctx.num_heads)
            grads = tuple(t if need else None for t, need in zip(grads, needs))
        return (*grads, None, None, None, None, None, None, None, None)


def window_attention(q, timeline_k, timeline_v, pe_k, pe_v, w_idx, start,
                     n_valid, s_lo, mask, num_heads: int,
                     kernel: Optional[_CudaKernel] = window_attention_fwd,
                     backward_kernel: Optional[_CudaKernel] = None):
    """Differentiable window attention (counterpart of
    ``fused_window_attention``). CUDA inputs go forward through ``kernel``
    (the per-sample or the grouped forward) and backward through
    ``backward_kernel`` (the per-sample or the grouped backward); CPU inputs
    go through those kernels' plain versions. A ``kernel`` of None is the
    plain forward, a ``backward_kernel`` of None the plain VJP, on either
    device."""
    return _WindowAttention.apply(q, timeline_k, timeline_v, pe_k, pe_v,
                                  w_idx, start, n_valid, s_lo, mask,
                                  num_heads, kernel, backward_kernel)
