"""The etmppo_tpu_torch slice end to end on the CPU: config, trainer, CLI,
and the package's independence from JAX and from etmppo_tpu."""
import dataclasses
import glob
import json
import math
import os
import re
import subprocess
import sys

import pytest
import torch
import yaml

from etmppo_tpu.config import load_config as jax_load_config
from etmppo_tpu_torch import cli
from etmppo_tpu_torch.config import (CARTPOLE_MASKED, HEADROOM_768,
                                     MINIGRID_FLAGSHIP,
                                     MORTAR_MAYHEM_GRID, MYSTERY_PATH_GRID,
                                     POC_MEMORY, SEARING_SPOTLIGHTS,
                                     SEARING_SPOTLIGHTS_BETA,
                                     SEARING_SPOTLIGHTS_SHAPED,
                                     config_from_dict, config_to_dict,
                                     load_config)
from etmppo_tpu_torch.ops.window_attention import window_attention_fwd
from etmppo_tpu_torch.training import trainer as trainer_lib
from etmppo_tpu_torch.training.trainer import PPOTrainer

torch.set_num_threads(1)

PACKAGE = os.path.join(os.path.dirname(__file__), "..", "etmppo_tpu_torch")


def _tiny(tmp_path, **overrides):
    raw = dict(
        environment={"type": "Minigrid", "name": "MiniGrid-MemoryS9-v0"},
        updates=2, epochs=2, n_workers=2, worker_steps=16, n_mini_batch=2,
        hidden_layer_size=32,
        transformer={"num_blocks": 2, "embed_dim": 32, "num_heads": 4,
                     "memory_length": 8, "positional_encoding": "relative",
                     "layer_norm": "post"},
        use_pallas_attention=True, summary_dir=str(tmp_path / "summaries"),
        checkpoint_dir=str(tmp_path / "models"))
    raw.update(overrides)
    return raw


@pytest.mark.parametrize("raw,path,kernels", [
    (MINIGRID_FLAGSHIP, "etmppo_tpu/configs/minigrid.yaml", True),
    (MYSTERY_PATH_GRID, "etmppo_tpu/configs/mystery_path_grid.yaml", True),
    (MORTAR_MAYHEM_GRID, "etmppo_tpu/configs/mortar_mayhem_grid.yaml", True),
    (POC_MEMORY, "etmppo_tpu/configs/poc_memory_env.yaml", False),
    (CARTPOLE_MASKED, "etmppo_tpu/configs/cartpole.yaml", False),
    (SEARING_SPOTLIGHTS, "etmppo_tpu/configs/searing_spotlights.yaml", True),
    (SEARING_SPOTLIGHTS_BETA,
     "etmppo_tpu/configs/searing_spotlights_beta.yaml", True),
    (SEARING_SPOTLIGHTS_SHAPED,
     "etmppo_tpu/configs/searing_spotlights_shaped.yaml", True),
    (HEADROOM_768, "etmppo_tpu/configs/headroom_768.yaml", True),
])
def test_flagship_dicts_are_exactly_their_yaml(raw, path, kernels):
    """``kernels``: the config runs the window-attention kernel pair (else
    the gathered-window loss)."""
    with open(path) as f:
        assert raw == yaml.safe_load(f)
    config = config_from_dict(raw)
    assert config == load_config(path)
    assert config.use_pallas_attention == config.pallas_backward == kernels


@pytest.mark.parametrize("path", sorted(glob.glob("etmppo_tpu/configs/*.yaml")))
def test_every_yaml_loads_like_the_jax_package(path):
    assert config_to_dict(load_config(path)) == dataclasses.asdict(
        jax_load_config(path))


def test_config_validation():
    with pytest.raises(ValueError):
        config_from_dict({"transformer": {"embed_dim": 30, "num_heads": 4}})
    with pytest.raises(ValueError):
        config_from_dict({"n_workers": 3, "worker_steps": 5, "n_mini_batch": 2})
    cfg = config_from_dict(MINIGRID_FLAGSHIP)
    assert cfg.batch_size == 8192 and cfg.mini_batch_size == 1024
    assert cfg.learning_rate_schedule.value(0) == pytest.approx(3.5e-4)
    assert cfg.learning_rate_schedule.value(251) == pytest.approx(1e-4)


def test_trainer_takes_two_updates_on_cpu(tmp_path):
    cfg = config_from_dict(_tiny(tmp_path))
    launches = window_attention_fwd.launches
    trainer = PPOTrainer(cfg, run_id="cpu", device="cpu")
    try:
        result = trainer.run_training(print_every=0)
    finally:
        trainer.close()
    assert trainer.update == 2
    assert all(math.isfinite(v) for v in result.values())
    assert result["env_steps_per_second"] > 0
    # the CPU path never reaches the CUDA wrapper
    assert window_attention_fwd.launches == launches
    with open(trainer.writer.csv_path) as f:
        rows = f.read().splitlines()
    assert len(rows) == 3 and "gradients/model" in rows[0]
    assert str(tmp_path) in trainer.writer.csv_path


def test_trainer_is_deterministic_given_the_seed(tmp_path):
    def run():
        trainer = PPOTrainer(config_from_dict(_tiny(tmp_path, updates=1)),
                             device="cpu", enable_metrics=False)
        trainer.run_training(print_every=0)
        return trainer.model.state_dict()
    a, b = run(), run()
    assert all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("overrides,match", [
    (dict(num_devices=2), "num_devices"),
    (dict(compute_dtype="bfloat16"), "float32"),
    (dict(obs_uint8=True), "obs_uint8"),
    (dict(environment={"type": "CartPole-native"}), "CartPole-native"),
])
def test_trainer_refuses_unported_options(tmp_path, overrides, match):
    """Every option that was refused until it was ported now trains:
    ``num_devices: 2`` on two gloo ranks (a trainer built without its rank's
    mesh refuses, naming how to start the ranks), ``compute_dtype:
    bfloat16`` (parameters stay float32), ``obs_uint8`` (the batch holds
    uint8 obs), and a ``-native`` env type through the host rollout."""
    cfg = config_from_dict(_tiny(tmp_path, **overrides))
    if cfg.num_devices != 1:
        from etmppo_tpu_torch.parallel import probe
        from etmppo_tpu_torch.parallel.mesh import spawn
        with pytest.raises(RuntimeError, match=match):
            PPOTrainer(cfg, device="cpu", enable_metrics=False)
        ranks = spawn(probe.train, 2, (cfg,), kwargs=dict(threads=1),
                      device="cpu", timeout=300)
        assert all(math.isfinite(v) for v in ranks[0]["results"][0].values())
        assert torch.equal(ranks[0]["digests"][0], ranks[1]["digests"][0])
        return
    if not cfg.environment.type.endswith("-native"):
        trainer = PPOTrainer(cfg, device="cpu", enable_metrics=False)
        _, batch = trainer.rollout_fn(trainer.rollout_state)
        result = trainer.train_one_update()
        assert all(math.isfinite(v) for v in result.values())
        if match == "float32":
            assert trainer.model.compute_dtype == torch.bfloat16
            assert {p.dtype for p in trainer.model.parameters()} == {
                torch.float32}
        else:
            assert batch.obs.dtype == torch.uint8 and cfg.obs_uint8
        return
    from etmppo_tpu_torch.envs.native import NativeEnvBatch
    from etmppo_tpu_torch.training.host_rollout import HostRolloutFn
    trainer = PPOTrainer(cfg, device="cpu", enable_metrics=False)
    try:
        assert isinstance(trainer.env, NativeEnvBatch)
        assert isinstance(trainer.rollout_fn, HostRolloutFn)
        assert trainer.env.observation_shape == (4,)
        assert cfg.environment.type == match
    finally:
        trainer.close()


def test_trainer_raises_without_a_gpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PPOTrainer(config_from_dict(_tiny(tmp_path)), device="cuda",
                   enable_metrics=False)


@pytest.mark.parametrize("fmt", ["json", "yaml"])
def test_cli_trains_on_cpu(tmp_path, capsys, fmt):
    path = tmp_path / f"tiny.{fmt}"
    with open(path, "w") as f:
        (json.dump if fmt == "json" else yaml.safe_dump)(
            _tiny(tmp_path, updates=5), f)
    result = cli.train_main([f"--config={path}", "--run-id=cli", "--cpu",
                             "--updates=1"])
    out = capsys.readouterr().out
    assert "env steps/s" in out and "pi_loss=" in out
    assert result["env_steps_per_second"] > 0
    assert os.path.isdir(tmp_path / "summaries" / "cli")


def test_cli_without_cpu_flag_needs_a_gpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = tmp_path / "tiny.json"
    path.write_text(json.dumps(_tiny(tmp_path)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.train_main([f"--config={path}"])


def test_cli_profile_and_seeds(tmp_path, capsys):
    """--seeds 2 trains seeds 0 and 1 as <run-id>_s<seed> and prints the
    mean and std of their final reward; --profile writes a Chrome trace of
    each run, with the trainer's rollout and PPO update spans."""
    from etmppo_tpu_torch.utils.profiling import TRACE_FILE, device_busy
    path = tmp_path / "poc.json"
    path.write_text(json.dumps(dict(
        POC_MEMORY, n_workers=2, worker_steps=32, n_mini_batch=2, epochs=1,
        hidden_layer_size=16,
        transformer=dict(POC_MEMORY["transformer"], num_blocks=2,
                         embed_dim=16),
        summary_dir=str(tmp_path / "summaries"),
        checkpoint_dir=str(tmp_path / "models"))))
    prof = tmp_path / "prof"
    result = cli.train_main([f"--config={path}", "--run-id=s", "--cpu",
                             "--updates=2", "--seeds=2",
                             f"--profile={prof}"])
    out = capsys.readouterr().out
    assert "[2 seeds] final reward_mean: " in out and "+/-" in out
    assert out.count("pi_loss=") == 4 and result["env_steps_per_second"] > 0
    for seed in (0, 1):
        assert os.path.exists(tmp_path / "models" / f"s_s{seed}.nn")
        with open(prof / f"s_s{seed}" / TRACE_FILE) as f:
            names = {e.get("name") for e in json.load(f)["traceEvents"]}
        assert {"rollout", "ppo_update"} <= names
        shares = device_busy(str(prof / f"s_s{seed}" / TRACE_FILE),
                             ["rollout", "ppo_update"])
        assert shares["total"]["wall_s"] >= shares["rollout"]["wall_s"] > 0
        assert shares["total"]["busy_s"] == 0.0      # no device on the CPU
    assert not (tmp_path / "models" / "s.nn").exists()


def test_trace_and_device_busy(tmp_path):
    """``trace`` writes a Chrome trace holding the ``annotate`` spans;
    ``device_busy`` takes the union of device intervals within each span's
    window (here a synthetic trace: two overlapping kernels, a copy that
    crosses from the first window into the second, a kernel that runs past
    the host's last span, and one before the first)."""
    from etmppo_tpu_torch.utils.profiling import (TRACE_FILE, annotate,
                                                  device_busy, trace)
    with trace(str(tmp_path / "t")):
        with annotate("outer"):
            torch.ones(4).sum()
    with open(tmp_path / "t" / TRACE_FILE) as f:
        assert "outer" in {e.get("name") for e in json.load(f)["traceEvents"]}

    def ev(cat, name, ts, dur):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    events = [ev("user_annotation", "a", 100, 50),
              ev("user_annotation", "b", 150, 40),
              ev("user_annotation", "a", 400, 10),      # a later "a": ignored
              ev("kernel", "k1", 110, 20), ev("kernel", "k2", 120, 20),
              ev("gpu_memcpy", "c", 145, 10), ev("kernel", "k3", 180, 30),
              ev("kernel", "k0", 10, 50), ev("cpu_op", "x", 100, 100)]
    path = tmp_path / "synthetic.json"
    path.write_text(json.dumps({"traceEvents": events}))
    got = device_busy(str(path), ["a", "b"])
    # a: [100, 150): k1 + k2 cover 110-140, the copy 145-150 -> 35 us
    # b: [150, 210): the copy 150-155, k3 180-210 -> 35 us
    assert got["a"]["wall_s"] == pytest.approx(50e-6)
    assert got["a"]["busy_s"] == pytest.approx(35e-6)
    assert got["b"]["wall_s"] == pytest.approx(60e-6)
    assert got["b"]["busy_s"] == pytest.approx(35e-6)
    assert got["total"]["busy_share"] == pytest.approx(70 / 110)
    with pytest.raises(ValueError, match="no span"):
        device_busy(str(path), ["a", "missing"])


def test_package_never_imports_jax_or_the_jax_package():
    forbidden = re.compile(
        r"^\s*(import|from)\s+(jax|flax|msgpack|optax|yaml|etmppo_tpu|PIL)"
        r"(\.|\s|$)")
    sources = glob.glob(os.path.join(PACKAGE, "**", "*.py"), recursive=True)
    sources.append(os.path.join(PACKAGE, "..", "chip_smoke.py"))
    hits = []
    for path in sources:
        with open(path) as f:
            for n, line in enumerate(f, 1):
                if forbidden.match(line) and not line.strip() == "import yaml":
                    hits.append(f"{path}:{n}: {line.strip()}")
    assert not hits
    # the only yaml import is inside the YAML-reading function
    with open(os.path.join(PACKAGE, "config.py")) as f:
        assert re.findall(r"^(\s*)import yaml", f.read(), re.M) == ["    "]


def test_importing_the_port_loads_no_jax():
    code = ("import sys, etmppo_tpu_torch.cli, etmppo_tpu_torch.interop, "
            "etmppo_tpu_torch.training.trainer, "
            "etmppo_tpu_torch.training.checkpoint, "
            "etmppo_tpu_torch.envs.mystery_path, "
            "etmppo_tpu_torch.envs.mortar_mayhem, "
            "etmppo_tpu_torch.envs.poc_memory, "
            "etmppo_tpu_torch.envs.cartpole, "
            "etmppo_tpu_torch.envs.searing_spotlights, "
            "etmppo_tpu_torch.utils.profiling, "
            "etmppo_tpu_torch.serve, etmppo_tpu_torch.serve_http, "
            "etmppo_tpu_torch.evaluate, etmppo_tpu_torch.enjoy, "
            "etmppo_tpu_torch.utils.render, etmppo_tpu_torch.utils.flops, "
            "etmppo_tpu_torch.utils.runtime, etmppo_tpu_torch.envs.native, "
            "etmppo_tpu_torch.envs.host, etmppo_tpu_torch.envs.factory, "
            "etmppo_tpu_torch.training.host_rollout, "
            "etmppo_tpu_torch.training.metrics, "
            "etmppo_tpu_torch.training.rollout, "
            "etmppo_tpu_torch.training.ppo, "
            "etmppo_tpu_torch.models.actor_critic, "
            "etmppo_tpu_torch.models.transformer, "
            "etmppo_tpu_torch.parallel.mesh, "
            "etmppo_tpu_torch.parallel.multihost, "
            "etmppo_tpu_torch.parallel.probe, "
            "etmppo_tpu_torch.config; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'msgpack', 'optax', 'yaml', 'etmppo_tpu', "
            "'PIL', 'tensorboard', 'tensorflow')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


def test_format_update_line():
    line = trainer_lib.format_update(3, dict(
        policy_loss=0.1, value_loss=0.2, entropy=1.0, loss=0.3,
        value_mean=0.5, advantage_mean=0.0, success=0.25, reward_mean=0.4))
    assert line.startswith("   3 reward=0.40") and "success=0.25" in line


def test_metrics_match_the_jax_package(tmp_path):
    from etmppo_tpu.training import metrics as jmetrics
    from etmppo_tpu_torch.training import metrics
    infos = [{"reward": 0.5 * i, "length": 10.0 + i, "success": float(i % 2)}
             for i in range(7)]
    result = metrics.process_episode_info(infos)
    assert result == jmetrics.process_episode_info(infos)
    assert metrics.process_episode_info([]) == {}
    stats = dict(zip(("policy_loss", "value_loss", "loss", "entropy", "kl",
                      "clip_fraction"), (0.1, 0.2, 0.3, 1.0, 0.01, 0.05)))
    assert metrics.training_scalars(stats, result, 0.4, 0.0) == \
        jmetrics.training_scalars(stats, result, 0.4, 0.0)
    writer = metrics.MetricsWriter(str(tmp_path), "run")
    writer.write(0, {"a": 1.0})
    writer.write(1, {"a": 2.0})
    writer.close()
    with open(writer.csv_path) as f:
        assert f.read().splitlines() == ["update,a", "0,1.0", "1,2.0"]
