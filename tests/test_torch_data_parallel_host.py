"""Data parallelism in etmppo_tpu_torch on the CPU, on the host env paths
and through the CLI, with real 2-rank gloo groups (``parallel.mesh.spawn``;
the ranks run ``parallel.probe.train``): the C++ engine seeded by offset
(bit for bit the single engine's rows), a 2-rank native run, the process
pool with 1 and 2 pipeline groups (counterpart of
tests/test_sharding.py's test_host_env_trainer_on_mesh), and the CLI, which
spawns the ranks itself and writes from rank 0 alone. Tolerances as in
tests/test_torch_data_parallel.py: with one pipeline group a rank's rows
are one device's rows to ``ROWS_RTOL``/``ROWS_ATOL`` (the CPU's matmuls
block by the batch's rows), the stats to 1e-3 relative; the ranks'
parameters are bit-identical after every update.
"""
import dataclasses
import glob
import json
import os

import numpy as np
import pytest
import torch

import jax

from etmppo_tpu.training import checkpoint as jax_checkpoint
from etmppo_tpu_torch import cli
from etmppo_tpu_torch.config import config_from_dict
from etmppo_tpu_torch.envs.factory import native_seed
from etmppo_tpu_torch.envs.native import NativeEnvBatch
from etmppo_tpu_torch.parallel import probe
from etmppo_tpu_torch.parallel.mesh import spawn
from etmppo_tpu_torch.training.ppo import STAT_NAMES

torch.set_num_threads(1)

ROWS_RTOL, ROWS_ATOL = 1e-5, 1e-6
STATS_RTOL = 1e-3
FLOAT_ROWS = ("values", "log_probs", "advantages")
SPAWN = dict(device="cpu", timeout=300, collective_timeout=120)


def _raw(tmp_path, **overrides):
    raw = dict(
        environment={"type": "PocMemoryEnv"}, updates=2, epochs=2,
        n_workers=4, worker_steps=8, n_mini_batch=2, hidden_layer_size=16,
        transformer={"num_blocks": 2, "embed_dim": 16, "num_heads": 2,
                     "memory_length": 4, "layer_norm": "pre", "gtrxl": True},
        num_devices=2, summary_dir=str(tmp_path / "summaries"),
        checkpoint_dir=str(tmp_path / "models"))
    raw.update(overrides)
    return raw


def _assert_replicated(ranks):
    for u, digest in enumerate(ranks[0]["digests"]):
        for r in ranks[1:]:
            assert torch.equal(r["digests"][u], digest), u
            for name, p in ranks[0]["params"][u].items():
                assert torch.equal(r["params"][u][name], p), (u, name)


def _assert_rows(ranks, one, n_workers):
    """Each rank's batch rows against one device's rows of its workers."""
    per = n_workers // len(ranks)
    for r in ranks:
        rows = slice(r["rank"] * per, (r["rank"] + 1) * per)
        for name, got in r["batch"].items():
            want = one["batch"][name][rows]
            if name in FLOAT_ROWS:
                np.testing.assert_allclose(got.numpy(), want.numpy(),
                                           rtol=ROWS_RTOL, atol=ROWS_ATOL,
                                           err_msg=name)
            else:
                assert torch.equal(got, want), name


# --- host envs -----------------------------------------------------------------


def test_rank_engine_seeded_by_offset_is_the_single_engines_rows():
    """A rank's PocMemoryEnv-native engine of workers 3..5, seeded by
    offset, steps bit for bit as rows 3..5 of one engine of 6 workers, over
    64 steps with every reset and episode end."""
    whole = NativeEnvBatch("PocMemoryEnv-native")
    part = NativeEnvBatch("PocMemoryEnv-native", seed=native_seed(3))
    whole.start(6)
    part.start(3)
    try:
        np.testing.assert_array_equal(part.reset_all(), whole.reset_all()[3:])
        rng = np.random.default_rng(0)
        ends = 0
        for _ in range(64):
            actions = rng.integers(0, 2, size=(6, 1))
            w_obs, w_rew, w_done, w_info = whole.step(actions)
            p_obs, p_rew, p_done, p_info = part.step(actions[3:])
            np.testing.assert_array_equal(p_obs, w_obs[3:])
            np.testing.assert_array_equal(p_rew, w_rew[3:])
            np.testing.assert_array_equal(p_done, w_done[3:])
            assert p_info == w_info[3:]
            ends += int(p_done.sum())
        assert ends > 0
    finally:
        whole.close()
        part.close()


def test_two_ranks_train_on_the_native_engine(tmp_path):
    cfg = config_from_dict(_raw(tmp_path, updates=1,
                                environment={"type": "PocMemoryEnv-native"}))
    ranks = spawn(probe.train, 2, (cfg,), kwargs=dict(threads=1), **SPAWN)
    _assert_replicated(ranks)
    result = ranks[0]["results"][0]
    assert all(np.isfinite(v) for v in result.values())


@pytest.mark.parametrize("groups", [1, 2])
def test_two_ranks_train_on_a_process_pool(tmp_path, groups):
    """Counterpart of test_host_env_trainer_on_mesh: a pool of stub envs on
    each rank (2 workers a rank) trains 2 updates. With one group the draws
    are one device's, so the batch rows and the result are one device's
    too."""
    cfg = config_from_dict(_raw(tmp_path, host_pipeline_groups=groups))
    kwargs = dict(updates=2, stub_pool=1, threads=1,
                  batch_fields=("actions", "dones") + FLOAT_ROWS)
    ranks = spawn(probe.train, 2, (cfg,), kwargs=kwargs, **SPAWN)
    _assert_replicated(ranks)
    for r in ranks:
        assert all(np.isfinite(v) for res in r["results"]
                   for v in res.values())
    if groups == 1:
        one = probe.train(None, dataclasses.replace(cfg, num_devices=1),
                          **kwargs)
        _assert_rows(ranks, one, cfg.n_workers)
        for got, want in zip(ranks[0]["results"], one["results"]):
            for key in STAT_NAMES:
                np.testing.assert_allclose(got[key], want[key],
                                           rtol=STATS_RTOL, atol=1e-6)


# --- the CLI -----------------------------------------------------------------


def test_cli_spawns_two_ranks_and_only_rank_0_writes(tmp_path):
    raw = _raw(tmp_path)
    path = tmp_path / "dp.json"
    path.write_text(json.dumps(raw))
    result = cli.train_main(["--cpu", f"--config={path}", "--run-id=dp"])
    assert all(np.isfinite(v) for v in result.values())
    csvs = glob.glob(str(tmp_path / "summaries" / "dp" / "*" / "metrics.csv"))
    assert len(csvs) == 1
    with open(csvs[0]) as f:
        assert len(f.read().splitlines()) == 1 + raw["updates"]
    assert sorted(os.listdir(tmp_path / "models")) == ["dp.nn"]
    params, config = jax_checkpoint.load_model(str(tmp_path / "models" /
                                                    "dp.nn"))
    assert config.num_devices == 2
    assert jax.tree_util.tree_leaves(params)


def test_cli_sets_no_deadline_on_the_whole_run(tmp_path, monkeypatch):
    """A data-parallel run through the CLI may take days: ``spawn`` gets no
    deadline for the whole run (hung ranks fail on ``collective_timeout``)."""
    calls = []

    def record(fn, num_devices, args=(), **kwargs):
        calls.append((fn, num_devices, kwargs))
        return [{"reward_mean": 0.0}]
    monkeypatch.setattr("etmppo_tpu_torch.parallel.mesh.spawn", record)
    path = tmp_path / "dp.json"
    path.write_text(json.dumps(_raw(tmp_path)))
    assert cli.train_main(["--cpu", f"--config={path}"]) == {
        "reward_mean": 0.0}
    (fn, num_devices, kwargs), = calls
    assert fn is cli.train_rank and num_devices == 2
    assert kwargs["timeout"] is None and kwargs["device"] == "cpu"
