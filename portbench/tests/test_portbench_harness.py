"""The harness finds a cell's files by name, prints the contract's last
line in a small CPU rehearsal, and its comparison passes the program and
fails its control and the planted faults."""
import copy
import json
import subprocess
import sys
import time

import pytest
import torch

from portbench import compare, control, harness

TRAIN = ["minigrid_s9.train", "mystery_path_grid.train"]
SEED = 2 ** 31 + 11


def rehearse(cell, trace=False, faults=()):
    cell.faults = list(faults)
    return harness.run_cell(cell, SEED, 0.5, trace, "cpu",
                            time.perf_counter())


def test_finds_configuration_mix_limits_and_metrics_by_name(tiny_cell):
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    kept = [json.loads(p.read_text())
            for p in (harness.HERE / "later").glob("*.json")]
    for w in bench["workloads"] + [w for k in kept for w in k["workloads"]]:
        cell = tiny_cell(w["name"])
        assert (harness.HERE / f"{cell.traffic['driver']}.py").exists()
        assert cell.config["name"] == w["config"]
        assert set(cell.limits) and all(v >= 0 for v in cell.limits.values())
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
        for m in cell.per_layer:
            assert (harness.HERE / "metrics" / f"{m['name']}.py").exists()
            assert harness.read_metric(m["name"], {}) is None


@pytest.mark.parametrize("name,trace", [(n, t) for n in TRAIN +
                                        ["minigrid_s9.serve64"]
                                        for t in (False, True)])
def test_rehearsal_prints_the_last_line(name, trace, tiny_cell, capsys):
    cell = tiny_cell(name)
    result = rehearse(cell, trace)
    harness.emit(result)
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    last = err.strip().splitlines()[-len(line["checks"]):]
    assert all(s.startswith("check ") for s in last)
    if not trace:
        assert set(line["metrics"]) == {m["name"] for m in
                                        cell.end_to_end}


@pytest.mark.parametrize("name", TRAIN)
@pytest.mark.parametrize("mode", ["tf32", "half_batch", "alter_action"])
def test_stand_ins_fail_training(name, mode, tiny_cell):
    cell = tiny_cell(name)
    numbers, _ = control.training(cell, SEED, mode, "cpu")
    assert not compare.judge(numbers, cell.limits), numbers


@pytest.mark.parametrize("mode", ["tf32", "alter_action"])
def test_stand_ins_fail_serving(mode, tiny_cell):
    cell = tiny_cell("minigrid_s9.serve64")
    numbers, _ = control.serving(cell, SEED, mode, "cpu", ticks=400)
    assert not compare.judge(numbers, cell.limits), numbers


def unchanged_state(trainer):
    """The update returns the parameters it started from."""
    run = trainer.update_fn.run

    def kept(*args, **kwargs):
        before = [p.detach().clone() for p in trainer.model.parameters()]
        out = run(*args, **kwargs)
        with torch.no_grad():
            for p, b in zip(trainer.model.parameters(), before):
                p.copy_(b)
        return out
    trainer.update_fn.run = kept


def half_batch(trainer):
    """Each minibatch's loss over its first half."""
    minibatch = trainer.update_fn.minibatch

    def half(fields, idx, global_adv=None, mask=None):
        idx = idx[: len(idx) // 2]
        return minibatch(fields, idx, None if global_adv is None
                         else global_adv[: len(idx)], mask)
    trainer.update_fn.minibatch = half


def half_batch_after_first(trainer):
    """From the second update on (on the card, the graph's replays), each
    minibatch's loss over its first half."""
    permutations, minibatch = (trainer.update_fn.permutations,
                               trainer.update_fn.minibatch)
    updates = []

    def counted(device):
        updates.append(1)
        return permutations(device)

    def half(fields, idx, global_adv=None, mask=None):
        if len(updates) > 1:
            idx = idx[: len(idx) // 2]
            global_adv = None if global_adv is None else global_adv[
                : len(idx)]
        return minibatch(fields, idx, global_adv, mask)
    trainer.update_fn.permutations = counted
    trainer.update_fn.minibatch = half


def altered_action(trainer):
    """Worker 0 takes the next action at every fifth rollout step."""
    sample = trainer.rollout_fn.sample_actions

    def altered(logits, step):
        actions, log_probs = sample(logits, step)
        if step % 5 == 0:
            actions = actions.clone()
            actions[0] = (actions[0] + 1) % logits[0].shape[-1]
        return actions, log_probs
    trainer.rollout_fn.sample_actions = altered


def altered_answer(server):
    """Stream 0's action is the next one at every step."""
    step = server._step

    def altered(obs, active):
        actions, values = step(obs, active)
        actions = actions.clone()
        actions[0] = (actions[0] + 1) % server.action_branches[0]
        return actions, values
    server._step = altered


@pytest.mark.parametrize("name", TRAIN)
@pytest.mark.parametrize("fault", [unchanged_state, half_batch,
                                   altered_action])
def test_planted_faults_fail_training(name, fault, tiny_cell):
    assert rehearse(tiny_cell(name), faults=[fault])["correct"] is False


@pytest.mark.parametrize("name", TRAIN)
def test_a_fault_in_the_later_updates_alone_fails(name, tiny_cell):
    """The first update (the eager warm-up on the card) stays sound; the
    later updates' first-minibatch loss catches the fault."""
    result = rehearse(tiny_cell(name), faults=[half_batch_after_first])
    check = result["checks"]["loss_gap.replay_s1"]
    assert result["correct"] is False
    assert check["value"] > check["limit"], result["checks"]
    assert result["checks"]["loss_gap.s1"]["value"] <= result["checks"][
        "loss_gap.s1"]["limit"]


def bypass_the_tap(trainer):
    """The loop's own body in place of the one the comparison reads."""
    loop = trainer.fused_loop
    loop.body = type(loop).body.__get__(loop)


@pytest.mark.parametrize("name", TRAIN)
def test_a_hook_the_program_no_longer_calls_stops_the_run(name, tiny_cell):
    with pytest.raises(RuntimeError, match="first launch showed"):
        rehearse(tiny_cell(name), faults=[bypass_the_tap])


def test_a_hook_the_program_lacks_stops_the_run():
    from types import SimpleNamespace
    from portbench.train import Tap
    f = lambda *a: None  # noqa: E731
    trainer = SimpleNamespace(
        fused_loop=SimpleNamespace(rollout_fn=f, body=f),
        update_fn=SimpleNamespace(permutations=f, _backward=f))
    with pytest.raises(RuntimeError, match="loop._replay"):
        Tap(trainer, 3, 3)


def test_planted_fault_fails_serving(tiny_cell):
    result = rehearse(tiny_cell("minigrid_s9.serve64"),
                      faults=[altered_answer])
    assert result["correct"] is False


def mortar_mayhem_cell():
    """A Mortar Mayhem Grid training cell composed here and not in
    ``BENCHMARK.json``: the port's published configuration under the
    ``train_launches`` mix. Its limits are ``mystery_path_grid.train``'s, a
    stand-in: the cell's own come with its configuration."""
    from etmppo_tpu_torch.config import MORTAR_MAYHEM_GRID
    stand_in = harness.load_cell("mystery_path_grid.train")
    traffic = json.loads(
        (harness.HERE / "traffic" / "train_launches.json").read_text())
    return harness.Cell(
        "mortar_mayhem_grid.train", 1,
        dict(name="mortar_mayhem_grid",
             config=copy.deepcopy(MORTAR_MAYHEM_GRID)),
        traffic, stand_in.limits, stand_in.end_to_end, stand_in.per_layer)


@pytest.mark.parametrize("trace", [False, True])
def test_a_composed_mortar_mayhem_cell_reads_correct(trace, tiny_cell):
    cell = tiny_cell(mortar_mayhem_cell())
    result = rehearse(cell, trace)
    assert result["correct"] is True, result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    if not trace:
        assert set(result["metrics"]) == {m["name"] for m in
                                          cell.end_to_end}


@pytest.mark.parametrize("fault", [unchanged_state, half_batch,
                                   altered_action])
def test_planted_faults_fail_a_composed_mortar_mayhem_cell(fault,
                                                           tiny_cell):
    result = rehearse(tiny_cell(mortar_mayhem_cell()), faults=[fault])
    assert result["correct"] is False


def test_a_run_without_a_card_prints_no_result():
    proc = subprocess.run(
        [sys.executable, str(harness.HERE / "run.py"), "--workload",
         "minigrid_s9.train", "--seed", str(SEED), "--seconds", "1"],
        capture_output=True, text=True, cwd=harness.ROOT, timeout=300,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    assert proc.returncode != 0 and proc.stdout.strip() == ""


@pytest.mark.card
def test_a_cell_runs_correct_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    proc = subprocess.run(
        [sys.executable, str(harness.HERE / "run.py"), "--workload",
         "minigrid_s9.train", "--seed", str(SEED), "--seconds", "2"],
        capture_output=True, text=True, cwd=harness.ROOT, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1])["correct"]
