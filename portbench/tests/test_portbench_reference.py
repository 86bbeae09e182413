"""The plain reference held to the port on the CPU at small sizes: the
model's forward on raw memory windows, and the two envs' resets and steps
from the same draws. (The whole training and serving comparison is held
in test_portbench_harness.py.)"""
import json
import subprocess
import sys

import pytest
import torch

from portbench.reference import envs as ref_envs
from portbench.reference import model as ref_model


@pytest.mark.parametrize("name", ["minigrid_s9", "mystery_path_grid"])
def test_forward_matches_the_port(name, tiny_cell):
    from etmppo_tpu_torch.config import config_from_dict
    from etmppo_tpu_torch.models.actor_critic import ActorCriticModel
    cell = tiny_cell("minigrid_s9.train" if name == "minigrid_s9"
                     else "mystery_path_grid.train")
    cfg = dict(cell.config["config"], **cell.overrides)
    env = ref_envs.make_env(cfg["environment"], 1, "cpu")
    weights = ref_model.make_weights(ref_model.param_spec(
        cfg, env.observation_shape, env.action_branches), 5, "cpu")
    port = ActorCriticModel(config_from_dict(cfg), env.observation_shape,
                            env.action_branches, env.max_episode_steps,
                            device="cpu")
    port.load_state_dict(weights, strict=True)
    m = ref_model.Model(cfg, env.observation_shape, env.action_branches,
                        env.max_episode_steps, "cpu")
    B, L, trx = 6, cfg["transformer"]["memory_length"], cfg["transformer"]
    obs = torch.rand((B,) + env.observation_shape)
    memory = torch.rand(B, env.max_episode_steps, trx["num_blocks"],
                        trx["embed_dim"])
    e = torch.tensor([0, 1, 5, 7, 20, env.max_episode_steps - 1])
    window, mask, slots = m.window(memory, e)
    logits, value, items = m.forward(weights, obs, window, mask, slots)
    with torch.no_grad():
        p_logits, p_value, p_items = port(obs, window, mask, slots)
    torch.testing.assert_close(value, p_value, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(items, p_items, rtol=1e-5, atol=1e-6)
    for a, b in zip(logits, p_logits):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("env_type", ["Minigrid", "MysteryPath-Grid"])
def test_envs_step_as_the_port(env_type):
    from etmppo_tpu_torch.config import EnvConfig, config_from_dict
    from etmppo_tpu_torch.config import MINIGRID_FLAGSHIP, MYSTERY_PATH_GRID
    from etmppo_tpu_torch.envs.factory import create_env
    raw = (MINIGRID_FLAGSHIP if env_type == "Minigrid"
           else MYSTERY_PATH_GRID)["environment"]
    W = 6
    port = create_env(config_from_dict({"environment": raw}).environment, W,
                      "cpu")
    ref = ref_envs.make_env(raw, W, "cpu")
    g_port, g_ref = (torch.Generator().manual_seed(9) for _ in range(2))
    p_state, p_obs = port.reset(port.sample_reset_draws(g_port))
    r_state, r_obs = ref.reset(ref.reset_draws(g_ref))
    assert torch.equal(p_obs, r_obs)
    n_actions = ref.action_branches[0]
    for step in range(300):
        actions = torch.randint(0, n_actions, (W, 1), generator=g_ref)
        g_port.set_state(g_ref.get_state())
        p_state, p_obs, p_rew, p_done, p_info = port.step(p_state, actions)
        r_state, r_obs, r_rew, r_done, r_info = ref.step(r_state, actions)
        assert torch.equal(p_obs, r_obs), step
        assert torch.equal(p_rew, r_rew) and torch.equal(p_done, r_done)
        for k in r_info:
            assert torch.equal(p_info[k], r_info[k])
        # Auto-reset as the rollouts do: all workers' resets drawn.
        pr_state, pr_obs = port.reset(port.sample_reset_draws(g_port))
        rr_state, rr_obs = ref.reset(ref.reset_draws(g_ref))
        assert torch.equal(pr_obs, rr_obs)
        from etmppo_tpu_torch.envs.core import select_state
        p_state = select_state(p_done, pr_state, p_state)
        r_state = ref_envs.where_rows(r_done, rr_state, r_state)
        done4 = p_done[:, None, None, None]
        p_obs = torch.where(done4, pr_obs, p_obs)
    del EnvConfig


PRECISION_PROBE = """
import json, sys
sys.path.insert(0, {root!r})
import torch
from portbench.reference import model
torch.backends.cuda.matmul.allow_tf32 = True
torch.backends.cudnn.allow_tf32 = True
torch.set_float32_matmul_precision("medium")
cfg = dict(hidden_layer_size=8, transformer=dict(
    embed_dim=8, num_heads=2, memory_length=4, num_blocks=1,
    layer_norm="pre", positional_encoding=""))
model.Model(cfg, (5,), (3,), 16, "cpu")
print(json.dumps([torch.backends.cuda.matmul.allow_tf32,
                  torch.backends.cudnn.allow_tf32,
                  torch.get_float32_matmul_precision(),
                  "etmppo_tpu_torch" in sys.modules]))
"""


def test_the_reference_sets_its_precision_itself():
    """TF32 on in the process before it, and the program never imported:
    building the reference's model turns TF32 off for matmuls and
    convolutions."""
    from portbench import harness
    proc = subprocess.run(
        [sys.executable, "-c", PRECISION_PROBE.format(root=str(harness.ROOT))],
        capture_output=True, text=True, timeout=300, cwd=harness.ROOT,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == [
        False, False, "highest", False]
