"""Model artifacts and checkpoints of etmppo_tpu_torch.

* The msgpack codec (``utils/flax_msgpack.py``) against flax's: it decodes
  the committed artifacts to the same trees, re-encodes them to the same
  bytes, and flax reads what it writes.
* ``load_model`` reads the committed ``models/*.nn`` (written by the JAX
  package): the port's forward on the loaded weights matches the JAX model's
  forward on the same parameters to 1e-5 of each output's largest entry.
  The trained weights make block inputs of up to ~5e3 next to entries of
  order 1, and float32 sums of such terms err in proportion to the largest
  (measured: under 3e-6 of it). And the
  JAX package's ``load_model`` reads what the port's ``save_model`` wrote,
  exactly.
* An interrupted run resumes exactly on the CPU: 1 update, a checkpoint, a
  new trainer that resumes and takes 1 more update, ends bit for bit where 2
  uninterrupted updates end. The CLI's ``--resume`` does the same.
"""
import collections
import dataclasses
import glob
import json
import os
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

from etmppo_tpu.envs.factory import create_env as jax_create_env
from etmppo_tpu.models.actor_critic import ActorCriticModel as JModel
from etmppo_tpu.training import checkpoint as jax_checkpoint
from etmppo_tpu_torch import cli
from etmppo_tpu_torch.config import config_from_dict, config_to_dict
from etmppo_tpu_torch.interop import flax_to_state_dict, state_dict_to_flax
from etmppo_tpu_torch.training.checkpoint import (Checkpointer, load_model,
                                                  read_model_config,
                                                  save_model)
from etmppo_tpu_torch.training.trainer import PPOTrainer
from etmppo_tpu_torch.utils import flax_msgpack

torch.set_num_threads(1)
torch.backends.cudnn.allow_tf32 = False

ARTIFACTS = sorted(glob.glob("models/*.nn"))
PORTED_ENVS = ("Minigrid", "MysteryPath-Grid", "MortarMayhem-Grid",
               "PocMemoryEnv", "CartPole", "CartPoleMasked",
               "SearingSpotlights")


def _payload(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def _assert_trees_equal(a, b, where=""):
    assert type(a) is type(b) is dict and list(a) == list(b), where
    for k in a:
        if isinstance(a[k], dict):
            _assert_trees_equal(a[k], b[k], f"{where}/{k}")
        else:
            assert a[k].dtype == b[k].dtype, f"{where}/{k}"
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{where}/{k}")


# --- the msgpack codec -------------------------------------------------


def test_codec_decodes_and_reencodes_a_committed_artifact():
    data = _payload("models/minigrid-tpu.nn")["params_bytes"]
    tree = flax_msgpack.unpackb(data)
    _assert_trees_equal(tree, serialization.msgpack_restore(data))
    assert flax_msgpack.packb(tree) == data


def test_codec_round_trip_and_flax_reads_its_bytes():
    rng = np.random.default_rng(0)
    tree = {"b": [0, 127, 128, 255, 65536, 2 ** 40, -1, -32, -33, -200,
                  -70000, -2 ** 40, 1.5, -0.25, True, False, None,
                  "", "x" * 31, "y" * 32, "z" * 300, b"", b"\x00" * 70000],
            "a": {str(i): rng.normal(size=(i, 3)).astype(np.float32)
                  for i in range(18)},
            "c": np.arange(5, dtype=np.int32), "d": np.zeros((2, 0)),
            "e": np.ones((), np.float32), "f": np.arange(4, dtype=np.uint8)}
    data = flax_msgpack.packb(tree)
    for decoded in (flax_msgpack.unpackb(data),
                    serialization.msgpack_restore(data)):
        assert list(decoded) == list(tree) and decoded["b"] == tree["b"]
        for k in "acdef":
            sub = decoded[k] if k != "a" else decoded["a"]["17"]
            want = tree[k] if k != "a" else tree["a"]["17"]
            assert sub.dtype == want.dtype
            np.testing.assert_array_equal(sub, want)
    # The same bytes as flax's own encoder for the same tree.
    assert data == serialization.msgpack_serialize(tree, in_place=True)


@pytest.mark.parametrize("value", [
    {1: 2}, {"a": object()}, {"a": 1 + 2j}, {"a": 2 ** 64}])
def test_codec_refuses_what_flax_to_bytes_does_not_write(value):
    with pytest.raises(ValueError):
        flax_msgpack.packb(value)


def test_codec_refuses_chunked_arrays_and_other_ext_types():
    chunked = serialization.msgpack_serialize(
        {"w": {"__msgpack_chunked_array__": True, "shape": {"0": 1},
               "chunks": {"0": np.zeros(1, np.float32)}}})
    with pytest.raises(ValueError, match="chunked"):
        flax_msgpack.unpackb(chunked)
    with pytest.raises(ValueError, match="ext type 2"):
        flax_msgpack.unpackb(serialization.msgpack_serialize({"c": 1 + 2j}))
    with pytest.raises(ValueError, match="truncated"):
        flax_msgpack.unpackb(flax_msgpack.packb({"a": "abc"})[:-1])


# --- the committed artifacts -------------------------------------------


@pytest.mark.parametrize("path", ARTIFACTS)
def test_every_artifact_config_reads_like_the_jax_package(path):
    assert config_to_dict(read_model_config(path)) == dataclasses.asdict(
        jax_checkpoint.read_model_config(path))


@pytest.mark.parametrize("path", [p for p in ARTIFACTS if _payload(p)[
    "config"]["environment"]["type"] in PORTED_ENVS])
def test_load_model_gives_the_artifact_weights(path):
    model, config = load_model(path, device="cpu")
    assert config == read_model_config(path)
    tree = serialization.msgpack_restore(_payload(path)["params_bytes"])
    want = flax_to_state_dict(tree)
    got = model.state_dict()
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_every_committed_artifact_loads():
    assert len(ARTIFACTS) == 19
    assert all(_payload(p)["config"]["environment"]["type"] in PORTED_ENVS
               for p in ARTIFACTS)


def test_load_model_needs_a_gpu_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_model("models/poc-full.nn")


def test_load_model_refuses_a_pickled_class(tmp_path):
    path = tmp_path / "evil.nn"
    with open(path, "wb") as f:
        pickle.dump({"format": "etmppo_tpu/flax-msgpack/v1",
                     "config": collections.Counter(a=1), "params_bytes": b""},
                    f)
    with pytest.raises(pickle.UnpicklingError, match="builtin"):
        read_model_config(str(path))


@pytest.mark.parametrize("path", ["models/minigrid-tpu.nn",
                                  "models/mpg-gtrxl.nn", "models/mmg-full.nn",
                                  "models/mmg-s1.nn",
                                  "models/cartpole-full.nn",
                                  "models/ss-full.nn"])
def test_loaded_model_forward_matches_jax(path):
    model, config = load_model(path, device="cpu")
    params, jconfig = jax_checkpoint.load_model(path)
    env = jax_create_env(jconfig.environment)
    jmodel = JModel(config=jconfig, obs_shape=env.observation_shape,
                    action_branches=env.action_branches,
                    max_episode_steps=env.max_episode_steps)
    rng = np.random.default_rng(0)
    B, L = 4, config.transformer.memory_length
    blocks, D = config.transformer.num_blocks, config.transformer.embed_dim
    obs = rng.random((B,) + env.observation_shape).astype(np.float32)
    memory = rng.normal(size=(B, L, blocks, D)).astype(np.float32)
    mask = rng.random((B, L)) < 0.6
    indices = rng.integers(0, env.max_episode_steps, (B, L)).astype(np.int32)
    j_logits, j_value, j_mem = jmodel.apply(
        params, *map(jnp.asarray, (obs, memory, mask, indices)))
    with torch.no_grad():
        t_logits, t_value, t_mem = model(
            *map(torch.as_tensor, (obs, memory, mask, indices)))
    for t, j in zip(t_logits + [t_value, t_mem], list(j_logits) + [j_value,
                                                                  j_mem]):
        j = np.asarray(j)
        np.testing.assert_allclose(t.numpy(), j, rtol=0,
                                   atol=1e-5 * np.abs(j).max())


def test_legacy_gate_layout_loads_and_matches_jax():
    """poc-full.nn stores its GRU gate weights as bias-free Dense modules
    (``{"kernel": (in, out)}``), an earlier layout the JAX model no longer
    takes. The port reads the same matrices; its forward matches the JAX
    model's on those weights in the current layout."""
    path = "models/poc-full.nn"
    tree = serialization.msgpack_restore(_payload(path)["params_bytes"])
    gate = tree["params"]["transformer"]["block_0"]["gate1"]
    assert set(gate["Wr"]) == {"kernel"}
    model, config = load_model(path, device="cpu")
    assert torch.equal(model.transformer.blocks[0].gate1.Wr,
                       torch.as_tensor(np.array(gate["Wr"]["kernel"])))
    jparams = state_dict_to_flax(model.state_dict())
    env = jax_create_env(jax_checkpoint.read_model_config(path).environment)
    jmodel = JModel(config=jax_checkpoint.read_model_config(path),
                    obs_shape=env.observation_shape,
                    action_branches=env.action_branches,
                    max_episode_steps=env.max_episode_steps)
    rng = np.random.default_rng(0)
    B, L = 4, config.transformer.memory_length
    obs = rng.normal(size=(B, 3)).astype(np.float32)
    memory = rng.normal(size=(B, L, 4, 64)).astype(np.float32)
    mask = rng.random((B, L)) < 0.6
    indices = rng.integers(0, env.max_episode_steps, (B, L)).astype(np.int32)
    j_logits, j_value, _ = jmodel.apply(
        jparams, *map(jnp.asarray, (obs, memory, mask, indices)))
    with torch.no_grad():
        t_logits, t_value, _ = model(
            *map(torch.as_tensor, (obs, memory, mask, indices)))
    for t, j in ((t_logits[0], j_logits[0]), (t_value, j_value)):
        j = np.asarray(j)
        np.testing.assert_allclose(t.numpy(), j, rtol=0,
                                   atol=1e-5 * np.abs(j).max())


# --- artifacts the port writes -----------------------------------------


def _tiny(tmp_path, env="Minigrid", **overrides):
    raw = dict(
        environment={"type": env, "name": "MiniGrid-MemoryS9-v0"},
        updates=2, epochs=2, n_workers=2, worker_steps=16, n_mini_batch=2,
        hidden_layer_size=32,
        transformer={"num_blocks": 2, "embed_dim": 32, "num_heads": 4,
                     "memory_length": 8, "positional_encoding": "relative",
                     "layer_norm": "post"},
        use_pallas_attention=True, pallas_backward=True,
        summary_dir=str(tmp_path / "summaries"),
        checkpoint_dir=str(tmp_path / "models"))
    raw.update(overrides)
    return raw


@pytest.mark.parametrize("env", PORTED_ENVS)
def test_the_jax_package_loads_what_the_port_saves(tmp_path, env):
    config = config_from_dict(_tiny(tmp_path, env))
    trainer = PPOTrainer(config, run_id="w", device="cpu",
                         enable_metrics=False)
    path = str(tmp_path / "w.nn")
    save_model(path, trainer.model, config)
    params, jconfig = jax_checkpoint.load_model(path)
    _assert_trees_equal(jax.tree.map(np.asarray, params),
                        state_dict_to_flax(trainer.model.state_dict()))
    assert dataclasses.asdict(jconfig) == config_to_dict(config)
    model, _ = load_model(path, device="cpu")
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k


# --- checkpoints and resume --------------------------------------------


def _state_dicts(trainer):
    return trainer.model.state_dict(), trainer.update_fn.optimizer.state_dict()


def _assert_equal_nested(a, b, where=""):
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b), where
    elif isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            _assert_equal_nested(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_equal_nested(x, y, f"{where}/{i}")
    else:
        assert a == b, where


def test_an_interrupted_run_resumes_exactly(tmp_path, capsys):
    raw = _tiny(tmp_path, checkpoint_interval=1)
    straight = PPOTrainer(config_from_dict(raw), run_id="straight",
                          device="cpu", enable_metrics=False)
    straight.run_training(print_every=0)

    first = PPOTrainer(config_from_dict(dict(raw, updates=1)), run_id="cut",
                       device="cpu", enable_metrics=False)
    first.run_training(print_every=0)
    resumed = PPOTrainer(config_from_dict(raw), run_id="cut", device="cpu",
                         enable_metrics=False)
    assert resumed.resume_from_checkpoint() and resumed.update == 1
    _assert_equal_nested(_state_dicts(resumed), _state_dicts(first))
    result = resumed.run_training(print_every=0)
    assert resumed.update == 2
    _assert_equal_nested(_state_dicts(resumed), _state_dicts(straight))
    assert "env_steps_per_second_steady" not in result
    out = capsys.readouterr().out
    assert f"Model saved to {tmp_path / 'models' / 'cut.nn'}" in out
    assert Checkpointer(str(tmp_path / "models"), "cut").updates() == [1, 2]


def test_checkpointer_keeps_the_last_three(tmp_path):
    ckpt = Checkpointer(str(tmp_path), "run")
    assert ckpt.latest_update() is None
    for update in range(1, 6):
        ckpt.save(update, {"update": update, "x": torch.full((2,), update)})
    assert ckpt.updates() == [3, 4, 5]
    assert ckpt.directory == str(tmp_path / "run_ckpt")
    assert ckpt.restore()["update"] == 5
    assert torch.equal(ckpt.restore(4)["x"], torch.full((2,), 4))


def test_trainer_without_a_checkpoint_does_not_resume(tmp_path):
    trainer = PPOTrainer(config_from_dict(_tiny(tmp_path)), device="cpu",
                         enable_metrics=False)
    assert trainer.checkpointer is None
    assert not trainer.resume_from_checkpoint() and trainer.update == 0


def test_cli_resume(tmp_path, capsys):
    path = tmp_path / "tiny.json"
    path.write_text(json.dumps(_tiny(tmp_path, checkpoint_interval=1)))
    args = [f"--config={path}", "--run-id=cli", "--cpu"]
    cli.train_main(args + ["--resume", "--updates=1"])
    out = capsys.readouterr().out
    assert "No checkpoint found; starting fresh" in out
    assert "Model saved to" in out
    result = cli.train_main(args + ["--resume"])
    out = capsys.readouterr().out
    assert "Resumed from checkpoint at update 1" in out
    assert out.count("pi_loss=") == 1 and result["env_steps_per_second"] > 0
    assert os.path.exists(tmp_path / "models" / "cli.nn")
    assert sorted(os.listdir(tmp_path / "models" / "cli_ckpt")) == [
        "1.pt", "2.pt"]
