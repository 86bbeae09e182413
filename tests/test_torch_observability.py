"""Observability and the CLI of etmppo_tpu_torch against the JAX package:
TensorBoard scalars, ``--debug-nans`` and the default ``--config``.

* ``MetricsWriter`` writes the same TensorBoard tags, steps and values as
  the JAX package's (read back with tensorboard's ``EventAccumulator``)
  beside its CSV; where ``torch.utils.tensorboard`` does not import (as on a
  machine without tensorboard) it says so once and writes the CSV only.
* ``--debug-nans``: with a NaN learning rate both packages' ``train_main``
  raise ``FloatingPointError`` (JAX's through ``jax_debug_nans``); without
  the flag both finish. The port's checks name where the value appeared:
  a module's forward output, a backward function, a parameter after the
  optimizer step. No hook and no anomaly mode outlive the run.
* Without ``--config`` the port's CLI trains PocMemory, as the JAX CLI
  does with ``poc_memory_env.yaml``.
"""
import dataclasses
import math
import os
import sys

import pytest
import torch
import yaml

import jax

from etmppo_tpu import cli as jax_cli
from etmppo_tpu.training import metrics as jax_metrics
from etmppo_tpu_torch import cli
from etmppo_tpu_torch.config import (POC_MEMORY, config_from_dict,
                                     config_to_dict)
from etmppo_tpu_torch.training import metrics
from etmppo_tpu_torch.training.checkpoint import read_model_config
from etmppo_tpu_torch.utils import runtime

torch.set_num_threads(1)

SCALARS = [{"losses/loss": 0.5, "episode/reward_mean": 0.25,
            "gradients/model": 1.5},
           {"losses/loss": -0.125, "episode/reward_mean": 0.75,
            "gradients/model": 0.0625}]


def _events(log_dir):
    from tensorboard.backend.event_processing.event_accumulator import \
        EventAccumulator
    acc = EventAccumulator(log_dir)
    acc.Reload()
    return {tag: [(e.step, e.value) for e in acc.Scalars(tag)]
            for tag in acc.Tags()["scalars"]}


def test_tensorboard_scalars_match_the_jax_writer(tmp_path):
    written = []
    for package, lib in (("jax", jax_metrics), ("port", metrics)):
        writer = lib.MetricsWriter(str(tmp_path / package), "run")
        for update, scalars in enumerate(SCALARS):
            writer.write(update, scalars)
        writer.close()
        written.append(_events(writer.log_dir))
    jax_events, port_events = written
    assert set(port_events) == set(SCALARS[0])
    assert port_events == jax_events
    assert port_events["losses/loss"] == [(0, 0.5), (1, -0.125)]
    with open(os.path.join(writer.log_dir, "metrics.csv")) as f:
        assert f.readline().strip() == ("update,losses/loss,"
                                        "episode/reward_mean,gradients/model")


def test_csv_only_without_tensorboard(tmp_path, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    writer = metrics.MetricsWriter(str(tmp_path), "run")
    assert "TensorBoard is off" in capsys.readouterr().out
    writer.write(0, {"a": 1.0})
    writer.close()
    assert os.listdir(writer.log_dir) == ["metrics.csv"]
    off = metrics.MetricsWriter(str(tmp_path), "off", use_tensorboard=False)
    off.close()
    assert os.listdir(off.log_dir) == ["metrics.csv"]


# --- --debug-nans -----------------------------------------------------------


def _tiny_poc(tmp_path, lr):
    """PocMemory at a small width, one update, learning rate ``lr``."""
    raw = dict(POC_MEMORY, n_workers=4, worker_steps=16, n_mini_batch=2,
               epochs=1, hidden_layer_size=16, updates=1,
               updates_per_launch=1,
               transformer=dict(POC_MEMORY["transformer"], num_blocks=2,
                                embed_dim=16, num_heads=2, memory_length=8),
               learning_rate_schedule=dict(
                   POC_MEMORY["learning_rate_schedule"], initial=lr,
                   final=lr),
               summary_dir=str(tmp_path / "summaries"),
               checkpoint_dir=str(tmp_path / "models"))
    path = tmp_path / "tiny.yaml"
    path.write_text(yaml.safe_dump(raw))
    return str(path)


def _no_checks_left():
    from torch.optim.optimizer import _global_optimizer_post_hooks
    assert not torch.nn.modules.module._global_forward_hooks
    assert not _global_optimizer_post_hooks
    assert not torch.is_anomaly_enabled()
    assert not runtime.debug_nans_enabled()


@pytest.mark.parametrize("debug", [False, True], ids=["off", "on"])
def test_debug_nans_with_a_nan_learning_rate(tmp_path, debug, capsys):
    """A NaN learning rate makes every parameter NaN at the first optimizer
    step: with the flag, both packages raise FloatingPointError in their
    first update; without it, both finish their one update."""
    path = _tiny_poc(tmp_path, float("nan"))
    flag = ["--debug-nans"] if debug else []
    try:
        if debug:
            with pytest.raises(FloatingPointError):
                jax_cli.train_main([f"--config={path}", "--cpu",
                                    "--run-id=j"] + flag)
        else:
            jax_cli.train_main([f"--config={path}", "--cpu", "--run-id=j"])
    finally:
        jax.config.update("jax_debug_nans", False)
    if debug:
        with pytest.raises(FloatingPointError,
                           match="after the optimizer step"):
            cli.train_main([f"--config={path}", "--cpu", "--run-id=p"]
                           + flag)
        assert " 0 reward=" not in capsys.readouterr().out
    else:
        result = cli.train_main([f"--config={path}", "--cpu", "--run-id=p"])
        # the second minibatch's loss comes from NaN parameters, unchecked
        assert math.isnan(result["loss"])
        assert os.path.exists(tmp_path / "models" / "p.nn")
    _no_checks_left()


def test_debug_nans_clean_run_finishes(tmp_path):
    path = _tiny_poc(tmp_path, 3e-4)
    result = cli.train_main([f"--config={path}", "--cpu", "--run-id=c",
                             "--debug-nans"])
    assert all(math.isfinite(v) for v in result.values())
    _no_checks_left()


def test_debug_nans_names_where_the_value_appeared():
    """A forward output (by the module's qualified name), a backward
    function (anomaly mode's error as FloatingPointError) and a parameter
    after a step."""
    model = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.ReLU())
    runtime.set_debug_nans(True)
    try:
        runtime.name_modules(model)
        with pytest.raises(FloatingPointError, match=r"Sequential\.0"):
            model(torch.tensor([[float("nan"), 0.0, 1.0]]))
        x = torch.zeros(1, requires_grad=True)
        with pytest.raises(FloatingPointError, match="SqrtBackward"):
            with runtime.nan_errors():
                (x.sqrt() * 0.0).sum().backward()
        opt = torch.optim.SGD(model.parameters(), lr=float("nan"))
        model(torch.ones(1, 3)).sum().backward()
        with pytest.raises(FloatingPointError,
                           match=r"Sequential\.0\.weight"):
            opt.step()
    finally:
        runtime.set_debug_nans(False)
    _no_checks_left()
    # off, the same NaN passes unchecked
    assert torch.isnan(model(torch.tensor([[float("nan"), 0.0, 1.0]]))).any()


# --- the default --config ----------------------------------------------------


def test_cli_without_config_trains_poc_memory(tmp_path, monkeypatch, capsys):
    """``train_main(["--cpu", "--updates=1"])``: POC_MEMORY at its full
    width, one update, its model and summaries under the working
    directory, as the JAX CLI's default does."""
    monkeypatch.chdir(tmp_path)
    result = cli.train_main(["--cpu", "--updates=1"])
    assert "pi_loss=" in capsys.readouterr().out
    assert all(math.isfinite(v) for v in result.values())
    saved = config_to_dict(read_model_config(str(tmp_path / "models" /
                                                 "run.nn")))
    assert saved == config_to_dict(dataclasses.replace(
        config_from_dict(POC_MEMORY), updates=1))
    assert os.path.isdir(tmp_path / "summaries" / "run")
