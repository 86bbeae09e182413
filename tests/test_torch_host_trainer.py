"""``PPOTrainer`` and the CLI on host envs: the native C++ engine and the
process pool, through ``HostRolloutFn``; a host run's checkpoint and
resume; the engine or pool closed with the trainer."""
import json
import math

import numpy as np
import torch

from etmppo_tpu_torch import cli
from etmppo_tpu_torch.config import POC_MEMORY, config_from_dict
from etmppo_tpu_torch.envs.host import HostEnvBatch
from etmppo_tpu_torch.envs.native import NativeEnvBatch
from etmppo_tpu_torch.training import trainer as trainer_lib
from etmppo_tpu_torch.training.host_rollout import (HostRolloutFn,
                                                    HostRolloutState)
from etmppo_tpu_torch.training.trainer import PPOTrainer

torch.set_num_threads(1)


def _native(tmp_path, env_type="PocMemoryEnv-native", **overrides):
    raw = dict(
        POC_MEMORY, environment={"type": env_type}, updates=2, n_workers=4,
        worker_steps=32, n_mini_batch=2, epochs=1, hidden_layer_size=16,
        transformer=dict(POC_MEMORY["transformer"], num_blocks=2,
                         embed_dim=16),
        summary_dir=str(tmp_path / "summaries"),
        checkpoint_dir=str(tmp_path / "models"))
    raw.update(overrides)
    return raw


def test_trains_on_the_native_engine_and_closes_it(tmp_path):
    trainer = PPOTrainer(config_from_dict(_native(tmp_path)), run_id="n",
                         device="cpu")
    try:
        assert isinstance(trainer.env, NativeEnvBatch)
        assert isinstance(trainer.rollout_fn, HostRolloutFn)
        assert trainer.rollout_fn.n_groups == 1
        result = trainer.run_training(print_every=0)
    finally:
        trainer.close()
    assert trainer.update == 2
    assert all(math.isfinite(v) for v in result.values())
    assert "success" in result and result["env_steps_per_second"] > 0
    assert trainer.env._handle is None
    assert (tmp_path / "models" / "n.nn").exists()


def test_host_run_resumes_its_rollout_state(tmp_path):
    """The checkpoint of a host run holds the obs, the episode steps, the
    memory and the rollout generator; a resumed trainer gets them back (its
    freshly started envs restart their episodes, as in the JAX package, so
    the run does not continue bit for bit)."""
    raw = _native(tmp_path, checkpoint_interval=1)
    first = PPOTrainer(config_from_dict(raw), run_id="r", device="cpu",
                       enable_metrics=False)
    try:
        first.run_training(print_every=0)
    finally:
        first.close()
    resumed = PPOTrainer(config_from_dict(raw), run_id="r", device="cpu",
                         enable_metrics=False)
    try:
        assert resumed.resume_from_checkpoint() and resumed.update == 2
        a, b = first.rollout_state, resumed.rollout_state
        assert isinstance(b, HostRolloutState)
        assert isinstance(b.obs, np.ndarray)
        np.testing.assert_array_equal(a.obs, b.obs)
        assert torch.equal(a.episode_step, b.episode_step)
        assert torch.equal(a.memory, b.memory)
        assert torch.equal(first.rollout_fn.generator.get_state(),
                           resumed.rollout_fn.generator.get_state())
        assert a.memory.abs().sum() > 0
        stats = resumed.train_one_update()
        assert all(math.isfinite(v) for v in stats.values())
    finally:
        resumed.close()


def test_cli_trains_a_native_config_on_cpu(tmp_path, capsys):
    path = tmp_path / "native.json"
    path.write_text(json.dumps(_native(tmp_path, "CartPoleMasked-native")))
    result = cli.train_main([f"--config={path}", "--run-id=cli", "--cpu"])
    out = capsys.readouterr().out
    assert out.count("pi_loss=") == 2 and "env steps/s" in out
    assert result["env_steps_per_second"] > 0
    assert (tmp_path / "models" / "cli.nn").exists()


class _PoolEnv:
    """A deterministic Python env (the reference's protocol)."""

    class _Space:
        def __init__(self, shape=None, n=None):
            self.shape, self.n = shape, n

    observation_space = _Space(shape=(3,))
    action_space = _Space(n=2)
    max_episode_steps = 32      # PocMemory's memory length

    def reset(self):
        self.t = 0
        return np.zeros(3, np.float32)

    def step(self, action):
        self.t += 1
        done = self.t >= 3 + int(action[0])
        info = {"reward": 1.0, "length": float(self.t)} if done else None
        return np.full(3, self.t, np.float32), np.float32(1.0), done, info

    def close(self):
        pass


def test_trains_pipelined_on_a_process_pool_and_closes_it(tmp_path,
                                                         monkeypatch):
    pools = []

    def create_env(config, n_workers, device):
        pools.append(HostEnvBatch(make_env=_PoolEnv, n_procs=2))
        return pools[-1]
    monkeypatch.setattr(trainer_lib, "create_env", create_env)
    trainer = PPOTrainer(
        config_from_dict(_native(tmp_path, host_pipeline_groups=2)),
        device="cpu", enable_metrics=False)
    procs = list(pools[0]._procs)
    try:
        assert trainer.rollout_fn.n_groups == 2 and len(procs) == 2
        result = trainer.run_training(print_every=0)
    finally:
        trainer.close()
    assert all(math.isfinite(v) for v in result.values())
    assert result["length_mean"] >= 3
    for proc in procs:
        proc.join(timeout=10)
    assert not any(p.is_alive() for p in procs)
