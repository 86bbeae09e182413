"""The trainer's phase clock (``utils/profiling.PhaseClock``) on the CPU,
where its stamps read ``time.perf_counter_ns()``, at the size of the
benchmark's CPU rehearsal (2 workers x 16 steps, TrXL 2 x 32) of the two
training flagships, MiniGrid-Memory and Mystery Path Grid.

* The spans nest: each device phase's last occurrence lies inside its
  parent's, every self time is at least 0, and the rollout's children sum to
  at most the rollout; the launch's and the set-up's host spans likewise.
* The spans of one update share its index, and a launch's are keyed by its
  first update's.
* Off, the clock has no buffer, stamps nothing and adds no output.
* The trained values are the same bits with the clock on and off, on the
  eager route and on the graph route (on ``test_torch_fused``'s stand-in for
  ``torch.cuda.graph``), where ``FusedTrainLoop.capture`` keeps its keys.
* Under a mesh (two gloo ranks, ``parallel.probe.train``), where the
  stamps of the update's top phases run between the segments: the same
  bits with the clock on and off, and nested spans on every rank.
* ``cli.py --profile`` writes ``phases.json`` beside ``trace.json``.

The stamps themselves, the kernel on a card included:
``tests/test_torch_phase_stamp.py``.
"""
import copy
import json

import pytest
import torch

from etmppo_tpu_torch import cli
from etmppo_tpu_torch.config import (MINIGRID_FLAGSHIP, MYSTERY_PATH_GRID,
                                     config_from_dict)
from etmppo_tpu_torch.parallel import probe
from etmppo_tpu_torch.parallel.mesh import spawn
from etmppo_tpu_torch.training import trainer as trainer_lib
from etmppo_tpu_torch.training.trainer import PPOTrainer
from etmppo_tpu_torch.utils import profiling
from etmppo_tpu_torch.utils.profiling import PHASES, PhaseClock, parent
from test_torch_fused import _assert_equal, _stand_in_graphs, _state

FLAGSHIPS = {"minigrid": MINIGRID_FLAGSHIP, "mystery_path": MYSTERY_PATH_GRID}
LAUNCH_SPANS = {"launch", "launch.drain", "launch.log"}
CAPTURE_SPANS = {"launch.warm_up", "launch.capture", "launch.instantiate"}
SETUP_SPANS = {"setup.trainer", "setup.env", "setup.model",
               "setup.optimizer", "setup.kernels"}
CAPTURE_KEYS = {"capture_s", "instantiate_s", "nodes", "pool_bytes",
                "reset_launches"}


def _raw(name, tmp_path, **overrides):
    raw = copy.deepcopy(FLAGSHIPS[name])
    raw.update(n_workers=2, worker_steps=16, n_mini_batch=2, epochs=2,
               hidden_layer_size=32, checkpoint_interval=0,
               summary_dir=str(tmp_path / "summaries"),
               checkpoint_dir=str(tmp_path / "models"))
    raw["transformer"] = dict(raw["transformer"], embed_dim=32, num_heads=2,
                              memory_length=8)
    raw.update(overrides)
    return raw


def _trainer(name, tmp_path, phase_clock, **overrides):
    return PPOTrainer(config_from_dict(_raw(name, tmp_path, **overrides)),
                      device="cpu", enable_metrics=False,
                      phase_clock=phase_clock)


def _children(names, of):
    return [n for n in names if parent(n) == of]


def _assert_nested(seconds: dict, root: str) -> None:
    """Every span's self time (its seconds less its children's) >= 0."""
    for name in seconds:
        kids = _children(seconds, name)
        assert sum(seconds[k] for k in kids) <= seconds[name], (name, kids)
    assert all(parent(n) is not None for n in seconds if n != root)


@pytest.mark.parametrize("name", sorted(FLAGSHIPS))
def test_spans_nest(name, tmp_path):
    trainer = _trainer(name, tmp_path, True)
    trainer.train_chunk(2)
    clock = trainer.clock
    for u in (0, 1):
        record = clock.updates[u]
        seconds, last = record["seconds"], record["last"]
        assert set(seconds) == set(PHASES)
        assert all(s > 0 for s in seconds.values()), seconds
        _assert_nested(seconds, "update")
        rollout = seconds["rollout"]
        assert sum(seconds[k] for k in _children(PHASES, "rollout")) <= rollout
        assert set(last) == set(PHASES)
        assert last["update"][0] == 0.0
        for phase in PHASES[1:]:
            lo, hi = last[phase]
            p_lo, p_hi = last[parent(phase)]
            assert p_lo <= lo <= hi <= p_hi, (phase, last)
    launch = clock.launches[0]
    assert set(launch) == LAUNCH_SPANS | {"updates"}
    _assert_nested({k: v for k, v in launch.items() if k != "updates"},
                   "launch")
    assert set(clock.setup) == SETUP_SPANS
    _assert_nested(clock.setup, "setup.trainer")


def test_spans_of_an_update_share_its_index(tmp_path):
    trainer = _trainer("minigrid", tmp_path, True)
    trainer.train_chunk(2)
    trainer.train_one_update()          # no launch: not in the record
    trainer.train_chunk(3)
    clock = trainer.clock
    assert sorted(clock.updates) == [0, 1, 3, 4, 5]
    assert sorted(clock.launches) == [0, 3]
    assert [clock.launches[u]["updates"] for u in (0, 3)] == [2, 3]
    record = json.loads(json.dumps(clock.record()))
    assert record["phases"] == list(PHASES)
    assert sorted(map(int, record["updates"])) == [0, 1, 3, 4, 5]


def test_off_leaves_no_buffer_stamp_or_output(tmp_path, monkeypatch):
    stamps = []
    monkeypatch.setattr(PhaseClock, "_host_stamp",
                        lambda self, c, o: stamps.append((c, o)))
    trainer = _trainer("mystery_path", tmp_path, False)
    clock = trainer.clock
    assert not clock.on and clock._buffer is None and clock._kernel is None
    trainer.train_chunk(2)
    assert stamps == [] and clock._rows is None
    assert clock.updates == {} and clock.launches == {}
    assert set(clock.setup) == SETUP_SPANS
    on = _trainer("mystery_path", tmp_path, True)
    on.train_chunk(2)
    # A rollout step stamps 4 boundaries, a minibatch 4, an update 12 more.
    T, minibatches = 16, 2 * 2
    assert len(stamps) == 2 * (4 * T + 4 * minibatches + 12)


@pytest.mark.parametrize("name", sorted(FLAGSHIPS))
def test_trained_values_are_the_same_bits_on_and_off(name, tmp_path):
    runs = {}
    for on in (False, True):
        trainer = _trainer(name, tmp_path, on)
        results = trainer.train_chunk(2) + [trainer.train_one_update()]
        runs[on] = (results, _state(trainer))
    assert runs[False][0] == runs[True][0]
    _assert_equal(runs[False][1], runs[True][1])


@pytest.mark.parametrize("on", [False, True], ids=["off", "on"])
def test_graph_route_on_a_stand_in(on, tmp_path, monkeypatch):
    """The graph route's launches with the clock on and off: the same bits
    as eager updates; ``capture`` keeps its keys, its seconds the clock's
    capture and instantiation spans; with the clock on, every update of
    both launches in the record, the warm-up's and the replays'."""
    want = _trainer("minigrid", tmp_path, False)
    want = want.train_chunk(3) + want.train_chunk(2)
    monkeypatch.setattr(trainer_lib, "choose_route",
                        lambda device, mesh: ("graph", "stand-in"))
    trainer = _trainer("minigrid", tmp_path, on)
    _stand_in_graphs(monkeypatch, trainer)
    assert trainer.train_chunk(3) + trainer.train_chunk(2) == want
    capture = trainer.fused_loop.capture
    assert set(capture) == CAPTURE_KEYS and capture["reset_launches"] == 0
    assert capture["capture_s"] >= 0 and capture["instantiate_s"] >= 0
    clock = trainer.clock
    if not on:
        assert clock.updates == {} and clock.launches == {}
        return
    assert sorted(clock.updates) == [0, 1, 2, 3, 4]
    first, second = clock.launches[0], clock.launches[3]
    replays = {"launch.replays", "updates"}
    assert set(first) == LAUNCH_SPANS | CAPTURE_SPANS | replays
    assert set(second) == LAUNCH_SPANS | replays
    assert first["launch.capture"] == capture["capture_s"]
    assert first["launch.instantiate"] == capture["instantiate_s"]
    for u, record in clock.updates.items():
        _assert_nested(record["seconds"], "update")


def test_under_a_mesh(tmp_path):
    cfg = config_from_dict(_raw("minigrid", tmp_path, n_workers=4,
                                num_devices=2))
    runs = {on: spawn(probe.train, 2, (cfg,), kwargs=dict(
        updates=2, chunk=2, keep_params=False, threads=1, phase_clock=on),
        device="cpu", timeout=300, collective_timeout=120)
        for on in (False, True)}
    for off, on in zip(runs[False], runs[True]):
        assert off["results"] == on["results"]
        assert all(map(torch.equal, off["digests"], on["digests"]))
        assert off["phases"]["updates"] == {}
        updates = on["phases"]["updates"]
        assert sorted(updates) == [0, 1]
        for record in updates.values():
            assert all(s > 0 for s in record["seconds"].values())
            _assert_nested(record["seconds"], "update")


def test_cli_profile_writes_the_phases(tmp_path):
    path = tmp_path / "tiny.json"
    path.write_text(json.dumps(_raw("minigrid", tmp_path, updates=2,
                                    updates_per_launch=2)))
    cli.train_main([f"--config={path}", "--run-id=t", "--cpu",
                    f"--profile={tmp_path / 'prof'}"])
    record = json.loads((tmp_path / "prof" / "t" /
                         profiling.PHASES_FILE).read_text())
    assert (tmp_path / "prof" / "t" / profiling.TRACE_FILE).exists()
    assert sorted(record["updates"]) == ["0", "1"]
    assert set(record["launches"]["0"]) == LAUNCH_SPANS | {"updates"}
    assert set(record["setup"]) == SETUP_SPANS
    assert record["capture"] == {}              # the eager route captures none
