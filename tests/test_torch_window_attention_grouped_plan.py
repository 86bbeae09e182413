"""Launch plans and index walk of the grouped window-attention kernels
(``grouped_forward_plan`` / ``grouped_backward_plan``, ``grouped_order``,
``grouped_runs``, ``run_tiles`` and ``reduce_candidates`` in
etmppo_tpu_torch.ops.window_attention, which state in Python what
csrc/window_runs.cuh and the grouped kernels do on the card).

The kernels run only on the card; what is checked here is what the wrapper
hands them and the walk they make: for every shipped configuration that runs
the kernels and for chip_smoke.py's shapes, the plans fit the card and are
ones the C entries accept; the sort is the stable (worker, start) sort; the
runs split each worker's samples into runs of at most R; a run's tiles reach
every window row of its samples exactly once; and the backward's second
pass visits exactly the samples whose window meets its rows. The grouped
backward's source holds no atomics (``tests/test_torch_build.py`` rebuilds
the libraries when a header they include changes).
"""
import functools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from etmppo_tpu_torch.config import load_config
from etmppo_tpu_torch.ops import window_attention as wa

CONFIG_DIR = Path(__file__).resolve().parent.parent / "etmppo_tpu" / "configs"
# The shipped YAMLs with use_pallas_attention: true (the list
# tests/test_torch_window_attention_plan.py checks against the directory).
KERNEL_CONFIGS = (
    "headroom_768.yaml", "minigrid.yaml", "mortar_mayhem_grid.yaml",
    "mortar_mayhem_grid_seed1.yaml", "mystery_path_grid.yaml",
    "mystery_path_grid_gtrxl.yaml", "mystery_path_grid_seed1.yaml",
    "mystery_path_grid_seed2.yaml", "mystery_path_grid_seed3.yaml",
    "mystery_path_grid_seed4.yaml", "searing_spotlights.yaml",
    "searing_spotlights_beta.yaml", "searing_spotlights_shaped.yaml")
PLANS = {"forward": wa.grouped_forward_plan,
         "backward": wa.grouped_backward_plan}
SMEM_PER_CTA = 232448       # 227 KB, the most one CTA may have on sm_90
CSRC = wa.FWD_GROUPED_SOURCE.parent
# chip_smoke.py's minibatches, built on the CPU: its three shapes and its
# edge cases.
CASES = sorted(chip_smoke.SHAPES) + sorted(chip_smoke.EDGE_CASES)


def _window_shape(name: str):
    trx = load_config(str(CONFIG_DIR / name)).transformer
    return trx.memory_length, trx.embed_dim, trx.num_heads


def _check_plan(plan, which: str, L: int, D: int, H: int) -> None:
    """What the grouped kernels' C entries require of a plan, and the card's
    limits."""
    R, rows, depth, threads, smem = plan
    assert R in (4, 8) and 1 <= rows <= 32 and depth in (2, 4)
    assert threads == 8 * H * R and threads <= wa.MAX_THREADS
    assert smem <= SMEM_PER_CTA
    if which == "forward":
        assert smem == wa.grouped_forward_smem_bytes(L, D, R, rows, depth)
    else:
        assert smem == wa.grouped_backward_smem_bytes(L, D, H, R, rows, depth)
    # An instance exists for the head width (csrc/window_runs.cuh).
    assert D // H <= wa.GROUPED_MAX_HEAD_WIDTH


@functools.lru_cache(maxsize=None)
def _minibatch(case: str):
    """(w_idx, start, n_valid, s_lo, W, S, P, L) of one of chip_smoke.py's
    minibatches, built on the CPU."""
    gen = torch.Generator().manual_seed(0)
    if case in chip_smoke.SHAPES:
        args, _ = chip_smoke.window_inputs(gen, "cpu", case)
    else:
        args, _ = chip_smoke.edge_inputs(gen, "cpu", case)
    W, S, _ = args[1].shape
    return (*args[5:9], W, S, args[3].shape[0], args[9].shape[1])


def _sorted_fields(case: str):
    w_idx, start, n_valid, s_lo, W, S, P, L = _minibatch(case)
    order, seg = wa.grouped_order(w_idx, start, W)
    return order, seg, w_idx[order], start[order], n_valid[order], s_lo[order]


@pytest.mark.parametrize("which", sorted(PLANS))
@pytest.mark.parametrize("name", KERNEL_CONFIGS)
def test_grouped_plan_fits_each_shipped_config(name, which):
    L, D, H = _window_shape(name)
    plan = PLANS[which](L, D, H)
    _check_plan(plan, which, L, D, H)
    # Every shipped shape stages tiles of whole chunks of 8 rows.
    assert plan.rows_per_tile in (8, 16)


@pytest.mark.parametrize("which", sorted(PLANS))
@pytest.mark.parametrize("shape", sorted(chip_smoke.plan_shapes()))
def test_grouped_plan_fits_chip_smoke_shapes(shape, which):
    L, D, H = chip_smoke.plan_shapes()[shape]
    _check_plan(PLANS[which](L, D, H), which, L, D, H)


@pytest.mark.parametrize("which", sorted(PLANS))
@pytest.mark.parametrize("L, D, H", [(1, 4, 1), (118, 384, 4), (7, 6, 3),
                                     (33, 1000, 8), (200, 64, 16)])
def test_grouped_plan_fits_any_window(L, D, H, which):
    """Windows of any length, odd widths and up to 16 heads (runs of 4
    samples where 8 would need more than 512 threads)."""
    plan = PLANS[which](L, D, H)
    _check_plan(plan, which, L, D, H)
    assert plan.samples_per_run == (8 if 64 * H <= wa.MAX_THREADS else 4)


def test_grouped_plans_that_cannot_run_raise():
    for plan in PLANS.values():
        with pytest.raises(ValueError, match="head widths"):
            plan(16, 1040, 4)
        with pytest.raises(ValueError, match="threads"):
            plan(16, 64, 32)
        with pytest.raises(ValueError, match="shared memory"):
            plan(40000, 128, 1)


def test_grouped_wrappers_pass_the_plan():
    """The grouped C entries take the seven shapes and the plan's five
    ints."""
    for kernel in (wa.window_attention_fwd_grouped,
                   wa.window_attention_bwd_grouped):
        assert kernel.n_ints == 7 + len(wa.GroupedPlan._fields) == 12


def test_grouped_constants_match_the_sources():
    runs = (CSRC / "window_runs.cuh").read_text()
    bwd = wa.BWD_GROUPED_SOURCE.read_text()
    ring = (CSRC / "window_ring.cuh").read_text()
    assert f"constexpr int kRunHead = {wa.RUN_HEAD};" in runs
    assert f"constexpr int kRunFields = {wa.RUN_FIELDS};" in runs
    assert (f"constexpr int kMaxHeadWidth = {wa.GROUPED_MAX_HEAD_WIDTH};"
            in runs)
    assert f"constexpr int kRows = {wa.REDUCE_ROWS};" in bwd
    depths = {d for _, d in wa.GROUPED_TILES}
    assert f"constexpr int kMaxDepth = {max(depths)};" in ring
    assert depths == {2, 4}


# --- the sort ------------------------------------------------------------

def _python_order(w_idx, start, W):
    """The stable sort by (clamped worker, start), written out."""
    key = lambda b: (min(max(int(w_idx[b]), 0), W - 1), int(start[b]), b)
    return sorted(range(len(w_idx)), key=key)


@pytest.mark.parametrize("kind", ["random", "ties", "descending workers",
                                  "one start", "out of range"])
def test_grouped_order_is_the_stable_worker_start_sort(kind):
    rng = np.random.default_rng(3)
    B, W = 200, 6
    w_idx = rng.integers(0, W, B)
    start = rng.integers(-5, 50, B)
    if kind == "ties":
        start = rng.integers(0, 3, B)
    elif kind == "descending workers":
        w_idx = np.sort(w_idx)[::-1].copy()
    elif kind == "one start":
        start[:] = 7
    elif kind == "out of range":
        w_idx[::7] = -2
        w_idx[1::7] = W + 3
    w_t = torch.tensor(w_idx, dtype=torch.int32)
    s_t = torch.tensor(start, dtype=torch.int32)
    order, seg = wa.grouped_order(w_t, s_t, W)
    assert order.tolist() == _python_order(w_idx, start, W)
    again, seg_again = wa.grouped_order(w_t, s_t, W)
    assert torch.equal(order, again) and torch.equal(seg, seg_again)
    clamped = np.clip(w_idx, 0, W - 1)
    assert seg.tolist() == [int((clamped < w).sum()) for w in range(W + 1)]


# --- runs, tiles and pass-2 candidates on chip_smoke.py's minibatches -----

@pytest.mark.parametrize("R", [4, 8])
@pytest.mark.parametrize("case", CASES)
def test_runs_split_each_worker_into_runs_of_r(case, R):
    order, seg, w_s, *_ = _sorted_fields(case)
    W, B = len(seg) - 1, len(order)
    runs = wa.grouped_runs(seg, R)
    assert len(runs) == -(-B // R) + W
    seen = []
    for run in runs:
        if run is None:
            continue
        w, j0, j1 = run
        assert 0 < j1 - j0 <= R
        clamped = w_s[j0:j1].clamp(0, W - 1)
        assert (clamped == w).all()
        seen.extend(range(j0, j1))
    assert sorted(seen) == list(range(B))


@pytest.mark.parametrize("case", CASES)
def test_run_tiles_reach_every_window_row_once(case):
    """The plain walk of each run's tiles (rows per tile as the forward plan
    has them): every window row l of every sample, once, from the tile that
    holds its (clamped) table row; a tile is skipped only where no window
    meets it."""
    order, seg, _, st_s, nv_s, slo_s = _sorted_fields(case)
    *_, W, S, P, L = _minibatch(case)
    rows = 8
    for run in wa.grouped_runs(seg, 8):
        if run is None:
            continue
        _, j0, j1 = run
        samples = [(int(st_s[j]), int(nv_s[j]), int(slo_s[j]))
                   for j in range(j0, j1)]
        tiles, taken = wa.run_tiles(samples, S, P, L, rows)
        walked = [[] for _ in samples]
        for (table, r0, n), per_sample in zip(tiles, taken):
            assert 0 < n <= rows and r0 + n <= (S if table == 0 else P)
            for i, (st, nv, slo) in enumerate(samples):
                nv = min(max(nv, 0), L)
                for l, tile_row in per_sample[i]:
                    base, n_tab = (st, S) if l < nv else (slo, P)
                    assert (table == 0) == (l < nv)
                    assert 0 <= tile_row < n
                    assert r0 + tile_row == min(max(base + l, 0), n_tab - 1)
                    walked[i].append(l)
        for ls in walked:
            assert ls == list(range(L))   # once each, in window order
        # The tiles skipped inside the union meet no window.
        for table, n_tab in ((0, S), (1, P)):
            spans = []
            for st, nv, slo in samples:
                nv = min(max(nv, 0), L)
                base, la, lb = (st, 0, nv) if table == 0 else (slo, nv, L)
                if la < lb:
                    clamp = lambda x: min(max(x, 0), n_tab - 1)
                    spans.append((clamp(base + la), clamp(base + lb - 1) + 1))
            listed = {r0 for t, r0, _ in tiles if t == table}
            if not spans:
                assert not listed
                continue
            lo, hi = min(a for a, _ in spans), max(b for _, b in spans)
            for r0 in range(lo, hi, rows):
                meets = any(a < min(r0 + rows, hi) and b > r0
                            for a, b in spans)
                assert meets == (r0 in listed)


@pytest.mark.parametrize("case", CASES)
def test_reduce_candidates_hold_the_samples_that_meet_the_tile(case):
    """Pass 2's range for rows [t0, t0 + 8) of worker w holds every sample
    of w whose window has a timeline row there, and the per-candidate test
    the kernel makes keeps exactly those."""
    order, seg, w_s, st_s, nv_s, _ = _sorted_fields(case)
    *_, W, S, P, L = _minibatch(case)
    rows = wa.REDUCE_ROWS

    def meets(j, w, t0):
        nv = min(max(int(nv_s[j]), 0), L)
        hi = nv if int(w_s[j]) == w else 0
        st = int(st_s[j])
        return 0 < hi and st + hi > t0 and st < t0 + rows

    for w in range(W):
        segment = range(int(seg[w]), int(seg[w + 1]))
        for t0 in range(0, S, rows):
            j_lo, j_hi = wa.reduce_candidates(st_s, seg, w, t0, L, rows)
            assert int(seg[w]) <= j_lo <= j_hi <= int(seg[w + 1])
            wanted = {j for j in segment if any(
                int(w_s[j]) == w and 0 <= r - int(st_s[j]) < min(
                    max(int(nv_s[j]), 0), L) for r in range(t0, t0 + rows))}
            assert wanted <= set(range(j_lo, j_hi))
            assert {j for j in range(j_lo, j_hi) if meets(j, w, t0)} == wanted


# --- sources -------------------------------------------------------------

def _with_headers(source: Path) -> str:
    text = source.read_text()
    return text + "".join((source.parent / h).read_text() for h in
                          re.findall(r'#include "([^"]+)"', text))


def test_grouped_backward_source_has_no_atomics():
    """No float is added atomically in the grouped backward: no atomicAdd
    and no PTX red.* in its source or the headers it includes."""
    text = _with_headers(wa.BWD_GROUPED_SOURCE)
    assert "atomicAdd" not in text
    assert not re.search(r"\bred\.", text)
