"""Float32 precision is decided in one place, ``utils/runtime.py``: every
entry point of the port turns TF32 off for matmuls and for cuDNN's
convolutions (PyTorch leaves the latter on by default), also on the CPU,
where the flags are process-wide and harmless. The JAX package computes in
float32, so this is what the parity tests hold the port to."""
import glob
import os
import re

import pytest
import torch

from etmppo_tpu_torch.config import POC_MEMORY, config_from_dict
from etmppo_tpu_torch.envs.factory import create_env
from etmppo_tpu_torch.models.actor_critic import ActorCriticModel
from etmppo_tpu_torch.training.checkpoint import save_model

torch.set_num_threads(1)

REPO = os.path.join(os.path.dirname(__file__), "..")


def _tiny_config(tmp_path):
    return config_from_dict(dict(
        POC_MEMORY, n_workers=2, worker_steps=16, n_mini_batch=2, epochs=1,
        hidden_layer_size=16, updates=1,
        transformer=dict(POC_MEMORY["transformer"], num_blocks=1,
                         embed_dim=16),
        summary_dir=str(tmp_path / "summaries"),
        checkpoint_dir=str(tmp_path / "models")))


@pytest.fixture(scope="module")
def model_path(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("runtime")
    cfg = _tiny_config(tmp)
    env = create_env(cfg.environment, 1, "cpu")
    model = ActorCriticModel(cfg, env.observation_shape, env.action_branches,
                             env.max_episode_steps, device="cpu",
                             generator=torch.Generator().manual_seed(0))
    path = str(tmp / "tiny.nn")
    save_model(path, model, cfg)
    return path


def _trainer(tmp_path, path):
    from etmppo_tpu_torch.training.trainer import PPOTrainer
    PPOTrainer(_tiny_config(tmp_path), device="cpu",
               enable_metrics=False).close()


def _load_model(tmp_path, path):
    from etmppo_tpu_torch.training.checkpoint import load_model
    load_model(path, device="cpu")


def _policy_server(tmp_path, path):
    from etmppo_tpu_torch.serve import PolicyServer
    PolicyServer(path, max_streams=2, device="cpu")


def _evaluate_model(tmp_path, path):
    from etmppo_tpu_torch.evaluate import evaluate_model
    evaluate_model(path, episodes=2, device="cpu")


def _run_episodes(tmp_path, path):
    from etmppo_tpu_torch.enjoy import run_episodes
    run_episodes(path, episodes=1, render=False, device="cpu")


def _resolve_device(tmp_path, path):
    from etmppo_tpu_torch.utils.runtime import resolve_device
    assert resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("entry", [
    _resolve_device, _trainer, _load_model, _policy_server, _evaluate_model,
    _run_episodes], ids=lambda f: f.__name__.strip("_"))
def test_entry_points_turn_tf32_off(entry, model_path, tmp_path,
                                    monkeypatch):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    entry(tmp_path, model_path)
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_precision_is_set_in_one_place():
    """No module of the package but ``utils/runtime.py`` assigns a TF32
    flag, and ``chip_smoke.py`` asserts the flags rather than set them."""
    assign = re.compile(r"allow_tf32\s*=[^=]")
    package = os.path.join(REPO, "etmppo_tpu_torch")
    setters = sorted(
        os.path.relpath(p, package)
        for p in glob.glob(os.path.join(package, "**", "*.py"),
                           recursive=True)
        if assign.search(open(p).read()))
    assert setters == [os.path.join("utils", "runtime.py")]
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        smoke = f.read()
    assert not assign.search(smoke)
    assert smoke.count("allow_tf32 is False") >= 2
