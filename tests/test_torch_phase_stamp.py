"""The phase clock's stamps (``utils/profiling.PhaseClock.stamp``): their
arithmetic on the host's clock, which is also the stamp kernel's
(``csrc/phase_stamp.cu``), and the kernel's wrapper; on a card (marked
``card``, skipped without one) a replayed CUDA graph that fills the stamp
buffer with rising stamps. This file imports neither JAX nor the JAX
package, so the card runs it without the tests' conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_phase_stamp.py
"""
import itertools

import pytest
import torch

from etmppo_tpu_torch.utils import profiling
from etmppo_tpu_torch.utils.profiling import PHASES, SLOT, PhaseClock

P = len(PHASES)


def test_host_stamps_sum_each_phase(monkeypatch):
    """Nanoseconds 10, 20, 30, ...: the sums, the last opens and closes,
    a repeated phase adding up, and a new update zeroing every sum."""
    ticks = itertools.count(10, 10)
    monkeypatch.setattr(profiling.time, "perf_counter_ns",
                        lambda: next(ticks))
    clock = PhaseClock(on=True)
    clock.stamp(opens=("update", "rollout"))                      # 10, 20
    for _ in range(2):
        clock.stamp(opens=("rollout.policy",))                    # 30 | 60
        clock.stamp(closes=("rollout.policy",),
                    opens=("rollout.env_step",))                  # 40 | 70
        clock.stamp(closes=("rollout.env_step",))                 # 50 | 80
    clock.stamp(closes=("rollout", "update"))                     # 90, 100
    buf = clock._buffer.tolist()
    want = {"update": 90, "rollout": 70, "rollout.policy": 20,
            "rollout.env_step": 20}
    assert {p: buf[SLOT[p]] for p in want} == want
    assert buf[P + SLOT["rollout.policy"]] == 60
    assert buf[2 * P + SLOT["rollout.policy"]] == 70
    assert buf[2 * P + SLOT["update"]] == 100
    clock.stamp(opens=("update",))                                # 110
    assert clock._buffer[:P].tolist() == [0] * P
    assert buf[P + SLOT["update"]] == 10 and clock._buffer[P] == 110


def test_stamp_kernel_takes_only_an_int64_cuda_buffer():
    stamp = profiling.PhaseStamp()
    assert stamp.source.name == "phase_stamp.cu"
    with pytest.raises(ValueError, match="int64 CUDA buffer"):
        stamp(torch.zeros(3 * P, dtype=torch.int64), -1, 0, P)


@pytest.mark.card
def test_a_replayed_graph_stamps_rising_times():
    """Stamps captured into a CUDA graph: every replay records its own,
    each later than the one before it, and the graph holds one node per
    stamp more than the same work without the clock."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from etmppo_tpu_torch.training.fused import graph_nodes
    device = torch.device("cuda", 0)
    x = torch.randn(256, 256, device=device)

    def work(clock):
        clock.stamp(opens=("update", "rollout"))
        for _ in range(3):
            clock.stamp(opens=("rollout.policy",))
            y = x @ x
            clock.stamp(closes=("rollout.policy",))
            x.copy_(y / y.norm())
        clock.stamp(closes=("rollout", "update"))

    nodes = {}
    for on in (False, True):
        clock = PhaseClock(on, device)
        for kernel in clock.kernels:
            kernel.load()
        stream = torch.cuda.Stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream):
            work(clock)                                 # warm-up
        torch.cuda.current_stream(device).wait_stream(stream)
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(graph):
            work(clock)
        graph.instantiate()
        nodes[on] = graph_nodes(graph)
    assert nodes[True] == nodes[False] + 2 + 3 * 2 + 2
    K = 3
    rows = []
    for k in range(K):
        graph.replay()
        clock.store(k, K)
        rows.append(clock._rows[k].clone())
    torch.cuda.synchronize(device)
    rows = torch.stack(rows).cpu()
    opens = rows[:, P]                  # each replay's update open
    assert bool((opens[1:] > opens[:-1]).all()), rows
    for row in rows:        # adjacent stamps may read the same microsecond
        assert row[2 * P] >= row[2 * P + 1] >= row[2 * P + 2] > row[P + 2]
        assert row[P + 2] > row[P + 1] >= row[P]
        assert row[0] >= row[1] >= row[2] > 0
