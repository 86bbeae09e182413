"""Tests of the benchmark itself (``python -m pytest portbench/tests``), on
the CPU at small sizes; tests marked ``card`` need a CUDA card and skip
without one (decided inside each test)."""
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card")


def tiny(cell):
    """The cell at a size a CPU test holds: 2 workers x 16 steps, TrXL 2 x
    32 (its blocks, norm placement and PE kept), 4 serving streams whose
    warm-up ticks outlast the longest episode, so that episodes finish
    however few ticks a loaded machine fits into the window."""
    cfg = cell.config["config"]
    cell.overrides = dict(
        n_workers=2, worker_steps=16, n_mini_batch=2, epochs=2,
        hidden_layer_size=32,
        transformer=dict(cfg["transformer"], embed_dim=32, num_heads=2,
                         memory_length=8))
    if cell.traffic["driver"] == "serve":
        cell.traffic.update(streams=4, bank_batches=3, warmup_ticks=44,
                            episode_steps=[4, 40],
                            trace_ticks=40, sample_episodes=8)
    return cell


def load(name):
    """The cell ``name`` of ``BENCHMARK.json`` or of the cells kept under
    ``portbench/later/`` for a later benchmark (the serving cell)."""
    from portbench import harness
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    for path in sorted((harness.HERE / "later").glob("*.json")):
        kept = json.loads(path.read_text())
        for key in ("workloads", "end_to_end", "per_layer"):
            bench[key] = bench[key] + kept[key]
    return harness.load_cell(name, bench=bench)


@pytest.fixture
def tiny_cell():
    """``tiny`` of the cell of that name, or of a cell composed in a test."""
    return lambda cell: tiny(load(cell) if isinstance(cell, str) else cell)
