"""The grouped window-attention pair as a configuration key
(``grouped_attention``), at Mortar Mayhem Grid's layout on the CPU (2
workers x 16 steps, TrXL 3 x 32, memory 8; the kernels' plain versions).

* The key is false by default, and ``config_to_dict`` leaves it out then, so
  a config without it is the JAX package's dict; set, it round-trips, and
  the JAX package reads such a dict as it reads one without the key.
* A trainer takes the pair the key names, and the ``.nn`` a trainer built
  from the key saves loads as before.
* ``capture["attention_launches"]`` counts each window-attention kernel's
  launches in a captured update by symbol, on a stand-in for
  ``torch.cuda.graph`` whose replay runs the captured body.
"""
import copy
import dataclasses
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import yaml

import jax

from etmppo_tpu.config import config_from_dict as jax_config_from_dict
from etmppo_tpu.training import checkpoint as jax_checkpoint
from etmppo_tpu_torch import cli
from etmppo_tpu_torch.config import (MORTAR_MAYHEM_GRID, config_from_dict,
                                     config_to_dict)
from etmppo_tpu_torch.envs.mystery_path import MysteryPathReset
from etmppo_tpu_torch.interop import state_dict_to_flax
from etmppo_tpu_torch.ops.window_attention import (
    ATTENTION_SYMBOLS, window_attention_bwd, window_attention_bwd_grouped,
    window_attention_fwd, window_attention_fwd_grouped)
from etmppo_tpu_torch.parallel.probe import CountingKernel
from etmppo_tpu_torch.training import trainer as trainer_lib
from etmppo_tpu_torch.training.checkpoint import load_model, save_model
from etmppo_tpu_torch.training.fused import FusedTrainLoop, launch_counts
from etmppo_tpu_torch.training.ppo import PPOUpdate
from etmppo_tpu_torch.training.trainer import PPOTrainer
from etmppo_tpu_torch.utils.profiling import PhaseClock
from test_torch_checkpoint import _assert_trees_equal
from test_torch_fused import _stand_in_graphs

torch.set_num_threads(1)

PER_SAMPLE = (window_attention_fwd, window_attention_bwd)
GROUPED = (window_attention_fwd_grouped, window_attention_bwd_grouped)


def _raw(tmp_path, **overrides):
    raw = copy.deepcopy(MORTAR_MAYHEM_GRID)
    raw.update(n_workers=2, worker_steps=16, n_mini_batch=2, epochs=2,
               hidden_layer_size=32, checkpoint_interval=0,
               summary_dir=str(tmp_path / "summaries"),
               checkpoint_dir=str(tmp_path / "models"))
    raw["transformer"] = dict(raw["transformer"], embed_dim=32, num_heads=2,
                              memory_length=8)
    raw.update(overrides)
    return raw


def _trainer(raw, run_id="run"):
    return PPOTrainer(config_from_dict(raw), run_id=run_id, device="cpu",
                      enable_metrics=False)


def test_the_key_is_false_by_default_and_left_out_of_the_dict():
    config = config_from_dict(MORTAR_MAYHEM_GRID)
    assert config.grouped_attention is False
    assert "grouped_attention" not in config_to_dict(config)
    grouped = config_from_dict(dict(MORTAR_MAYHEM_GRID,
                                    grouped_attention=True))
    assert grouped.grouped_attention is True
    raw = config_to_dict(grouped)
    assert raw["grouped_attention"] is True
    assert config_from_dict(raw) == grouped
    assert config_to_dict(dataclasses.replace(grouped,
                                              grouped_attention=False)) == (
        config_to_dict(config))


def test_the_jax_package_reads_the_key_as_if_it_were_not_there():
    grouped = config_to_dict(config_from_dict(dict(MORTAR_MAYHEM_GRID,
                                                   grouped_attention=True)))
    plain = config_to_dict(config_from_dict(MORTAR_MAYHEM_GRID))
    assert dataclasses.asdict(jax_config_from_dict(grouped)) == (
        dataclasses.asdict(jax_config_from_dict(plain))) == plain


@pytest.mark.parametrize("suffix", [".json", ".yaml"])
def test_the_cli_reads_the_key_from_a_config_file(suffix, tmp_path):
    raw = _raw(tmp_path, grouped_attention=True)
    path = tmp_path / f"grouped{suffix}"
    path.write_text(json.dumps(raw) if suffix == ".json"
                    else yaml.safe_dump(raw))
    assert cli._read_config(str(path)) == config_from_dict(raw)
    assert cli._read_config(str(path)).grouped_attention


@pytest.mark.parametrize("key,want", [(False, PER_SAMPLE), (True, GROUPED)])
def test_a_trainer_takes_the_pair_the_key_names(key, want, tmp_path):
    trainer = _trainer(_raw(tmp_path, grouped_attention=key))
    upd = trainer.update_fn
    assert (upd.kernel, upd.backward_kernel) == want


def test_a_grouped_runs_model_loads_as_before(tmp_path):
    """The ``.nn`` of a trainer built from the key: the port loads its
    weights and config back; the JAX package loads its weights and reads
    its config as the same one without the key."""
    raw = _raw(tmp_path, grouped_attention=True)
    trainer = _trainer(raw)
    trainer.train_one_update()
    path = str(tmp_path / "grouped.nn")
    save_model(path, trainer.model, trainer.config)
    model, config = load_model(path, device="cpu")
    assert config == trainer.config and config.grouped_attention
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k
    params, jconfig = jax_checkpoint.load_model(path)
    _assert_trees_equal(jax.tree.map(np.asarray, params),
                        state_dict_to_flax(trainer.model.state_dict()))
    assert dataclasses.asdict(jconfig) == config_to_dict(
        dataclasses.replace(config, grouped_attention=False))


@pytest.mark.parametrize("grouped", [False, True],
                         ids=["per-sample", "grouped"])
def test_a_capture_counts_the_attention_launches(grouped, tmp_path,
                                                 monkeypatch):
    """Each kernel of the update's pair launches once a block a minibatch,
    3 blocks x 2 epochs x 2 minibatches in a captured update; the other
    pair never."""
    monkeypatch.setattr(trainer_lib, "choose_route",
                        lambda device, mesh: ("graph", "stand-in"))
    trainer = _trainer(_raw(tmp_path, grouped_attention=grouped))
    upd = trainer.update_fn
    upd.kernel = CountingKernel(upd.kernel)
    upd.backward_kernel = CountingKernel(upd.backward_kernel)
    _stand_in_graphs(monkeypatch, trainer)
    trainer.train_chunk(3)
    pair = GROUPED if grouped else PER_SAMPLE
    want = dict.fromkeys(ATTENTION_SYMBOLS, 0)
    want.update({k.symbol: 3 * 2 * 2 for k in pair})
    assert trainer.fused_loop.capture["attention_launches"] == want
    assert upd.kernel.launches == upd.backward_kernel.launches == 3 * 12


def test_the_count_reads_the_updates_own_pair_by_symbol():
    """The loop counts the kernels its components list: a kernel the
    update does not take (the other pair, a backward of None) counts
    nothing, nor does the env's reset kernel."""
    fwd, bwd = (CountingKernel(k) for k in GROUPED)
    other = CountingKernel(window_attention_fwd)
    reset = MysteryPathReset()
    ran = {fwd: 72, bwd: 72, other: 120, reset: 512}
    for backward, want_bwd in ((bwd, 72), (None, 0)):
        upd = SimpleNamespace(kernel=fwd, backward_kernel=backward,
                              config=SimpleNamespace(
                                  use_pallas_attention=True))
        loop = SimpleNamespace(
            update_fn=SimpleNamespace(kernels=PPOUpdate.kernels.fget(upd)),
            rollout_fn=SimpleNamespace(env=SimpleNamespace(kernels=(reset,))),
            clock=PhaseClock())
        launches = {k: ran[k] for k in FusedTrainLoop.kernels.fget(loop)}
        counts = launch_counts(launches, None)["attention_launches"]
        assert counts == dict(window_attention_fwd=0, window_attention_bwd=0,
                              window_attention_fwd_grouped=72,
                              window_attention_bwd_grouped=want_bwd)
