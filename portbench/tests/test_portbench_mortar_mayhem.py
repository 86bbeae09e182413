"""The cell ``mortar_mayhem_grid.train_grouped`` as ``BENCHMARK.json`` gives
it, with its own limits, in a small CPU rehearsal: the program takes the
grouped window-attention pair from the configuration's
``grouped_attention``, the comparison passes it, and fails the control,
the planted faults and a fault of the grouped route alone: one sorted
sample's output row off by one inside a run of the grouped kernels."""
import json

import pytest
import torch

from etmppo_tpu_torch.ops.window_attention import (
    window_attention_bwd_grouped, window_attention_fwd_grouped)
from portbench import compare, control, harness
from test_portbench_harness import (SEED, altered_action, half_batch,
                                    half_batch_after_first, rehearse,
                                    unchanged_state)

CELL = "mortar_mayhem_grid.train_grouped"


def first_sorted(w_idx, start, n: int):
    """The rows of the first ``n`` samples in the grouped kernels' order (the
    minibatch sorted by worker, then start, then row), each a 0-d tensor,
    found with argmin alone, which a CUDA graph can capture."""
    B = w_idx.shape[0]
    rows = torch.arange(B, device=w_idx.device)
    key = (w_idx.long() * 2 ** 32 + (start.long() + 2 ** 31)) * B + rows
    picks = []
    for _ in range(n):
        picks.append(key.argmin())
        key = torch.where(rows == picks[-1], torch.iinfo(torch.int64).max,
                          key)
    return picks


class _RowOffByOne:
    """The grouped forward writing the output of the third sorted sample of
    the first run into the row of the second too, as a run whose setup read
    a neighbour's row would."""

    def __init__(self, kernel):
        self._kernel = kernel
        self.symbol = kernel.symbol

    @property
    def launches(self):
        return self._kernel.launches

    @launches.setter
    def launches(self, n):
        self._kernel.launches = n

    @staticmethod
    def _moved(out, args):
        _, second, third = first_sorted(args[5], args[6], 3)
        rows = torch.arange(out.shape[0], device=out.device)
        return torch.where((rows == second)[:, None],
                           out.index_select(0, third.view(1)), out)

    def __call__(self, *args, **kwargs):
        return self._moved(self._kernel(*args, **kwargs), args)

    def plain(self, *args, **kwargs):
        return self._moved(self._kernel.plain(*args, **kwargs), args)


def row_off_by_one_in_a_run(trainer):
    trainer.update_fn.kernel = _RowOffByOne(trainer.update_fn.kernel)


def test_the_cell_has_its_own_configuration_and_limits(tiny_cell):
    cell = tiny_cell(CELL)
    assert cell.config["config"]["grouped_attention"] is True
    assert cell.config["reduced"] == []
    assert cell.limits == json.loads(
        (harness.HERE / "limits" / f"{CELL}.json").read_text())
    names = {m["name"] for m in cell.per_layer}
    assert {"grouped_sort_ms.train", "window_attn_fwd_roofline",
            "window_attn_bwd_roofline", "mfu.train", "device_idle.train",
            "first_launch_s.train"} <= names


@pytest.mark.parametrize("trace", [False, True])
def test_a_rehearsal_on_the_grouped_pair_reads_correct(trace, tiny_cell):
    pairs = []

    def seen(trainer):
        upd = trainer.update_fn
        pairs.append((upd.kernel, upd.backward_kernel))
    cell = tiny_cell(CELL)
    cell.faults = [seen]
    result = harness.run_cell(cell, SEED, 0.5, trace, "cpu", 0.0)
    assert pairs == [(window_attention_fwd_grouped,
                      window_attention_bwd_grouped)]
    assert result["correct"] is True, result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    if not trace:
        assert set(result["metrics"]) == {m["name"] for m in
                                          cell.end_to_end}


@pytest.mark.parametrize("mode", ["tf32", "half_batch", "alter_action"])
def test_stand_ins_fail(mode, tiny_cell):
    cell = tiny_cell(CELL)
    numbers, _ = control.training(cell, SEED, mode, "cpu")
    assert not compare.judge(numbers, cell.limits), numbers


@pytest.mark.parametrize("fault", [unchanged_state, half_batch,
                                   altered_action, half_batch_after_first,
                                   row_off_by_one_in_a_run])
def test_planted_faults_fail(fault, tiny_cell):
    assert rehearse(tiny_cell(CELL), faults=[fault])["correct"] is False


def test_the_faults_take_the_kernels_order():
    w_idx = torch.tensor([2, 0, 1, 0, 0, 2, 0], dtype=torch.int32)
    start = torch.tensor([5, 9, 3, 4, 7, 1, 7], dtype=torch.int32)
    # Sorted: worker 0 at starts 4, 7, 7, 9 (rows 3, 4, 6, 1).
    assert [int(i) for i in first_sorted(w_idx, start, 4)] == [3, 4, 6, 1]
    out = torch.arange(7.0)[:, None].repeat(1, 2)
    moved = _RowOffByOne._moved(out, [None] * 5 + [w_idx, start])
    assert moved[:, 0].tolist() == [0, 1, 2, 3, 6, 5, 6]
