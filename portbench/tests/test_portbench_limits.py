"""Every limits file holds exactly the numbers its cell's comparison
emits: ``compare.judge`` reads ``correct`` false for a number without a
limit and for a limit without a number, so a key too many or too few
refuses every run of the cell, however small its numbers."""
import json

import pytest

from portbench import compare, control, harness
from test_portbench_harness import SEED

LIMITS = sorted(p.stem for p in (harness.HERE / "limits").glob("*.json"))


def emitted(cell) -> set:
    """The names of the numbers the cell's comparison computes, from its
    control at a small size."""
    if cell.traffic["driver"] == "train":
        numbers, _ = control.training(cell, SEED, "tf32", "cpu")
    else:
        numbers, _ = control.serving(cell, SEED, "tf32", "cpu", ticks=200)
    return set(numbers)


@pytest.mark.parametrize("name", LIMITS)
def test_a_limits_file_holds_exactly_the_numbers_compared(name, tiny_cell):
    cell = tiny_cell(name)         # a cell of BENCHMARK.json or of later/
    assert set(cell.limits) == emitted(cell)


def test_every_cell_has_a_limits_file():
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    kept = [json.loads(p.read_text())
            for p in (harness.HERE / "later").glob("*.json")]
    cells = {w["name"] for w in bench["workloads"]} | {
        w["name"] for k in kept for w in k["workloads"]}
    assert cells == set(LIMITS)


@pytest.mark.parametrize("change", ["missing", "extra"])
def test_a_key_too_few_or_too_many_reads_incorrect(change):
    limits = json.loads(
        (harness.HERE / "limits" / "mystery_path_grid.train.json")
        .read_text())
    numbers = dict.fromkeys(limits, 0.0)
    assert compare.judge(numbers, limits)
    if change == "missing":
        del limits["loss_gap.s1"]
    else:
        limits["loss_gap.s2"] = 1.0
    assert not compare.judge(numbers, limits)
