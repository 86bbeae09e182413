"""The plain reference held to the port on the CPU at small sizes: the
model's forward on raw memory windows, and the envs' resets and steps
from the same draws, each env found by its type. (The whole training and serving comparison is held
in test_portbench_harness.py.)"""
import copy
import json
import subprocess
import sys

import pytest
import torch

from portbench import harness
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


def port_env_config(env_type: str) -> dict:
    from etmppo_tpu_torch.config import (MINIGRID_FLAGSHIP,
                                         MORTAR_MAYHEM_GRID,
                                         MYSTERY_PATH_GRID)
    return {"Minigrid": MINIGRID_FLAGSHIP, "MysteryPath-Grid":
            MYSTERY_PATH_GRID, "MortarMayhem-Grid": MORTAR_MAYHEM_GRID}[
                env_type]["environment"]


def step_both(raw: dict, W: int, steps: int, script=None) -> list:
    """The port's env and the reference's from the same draws, ``steps``
    steps of uniform actions (where ``script(state, actions)`` returns
    None, else its actions, from the reference's state), auto-reset as the
    rollouts do it: every worker's reset drawn at every step and kept
    where an episode ended. Asserts each observation, reward, done and
    info bit-equal; returns each ending's (worker, success, length)."""
    from etmppo_tpu_torch.config import config_from_dict
    from etmppo_tpu_torch.envs.core import select_state
    from etmppo_tpu_torch.envs.factory import create_env
    port = create_env(config_from_dict({"environment": raw}).environment, W,
                      "cpu")
    ref = ref_envs.make_env(raw, W, "cpu")
    assert (ref.max_episode_steps, ref.observation_shape,
            ref.action_branches) == (port.max_episode_steps,
                                     port.observation_shape,
                                     port.action_branches)
    g_port, g_ref = (torch.Generator().manual_seed(9) for _ in range(2))
    p_state, p_obs = port.reset(port.sample_reset_draws(g_port))
    r_state, r_obs = ref.reset(ref.reset_draws(g_ref))
    assert torch.equal(p_obs, r_obs)
    n_actions = ref.action_branches[0]
    endings = []
    for step in range(steps):
        actions = torch.randint(0, n_actions, (W, 1), generator=g_ref)
        if script is not None:
            actions = script(r_state, actions)
        g_port.set_state(g_ref.get_state())
        p_state, p_obs, p_rew, p_done, p_info = port.step(p_state, actions)
        r_state, r_obs, r_rew, r_done, r_info = ref.step(r_state, actions)
        assert torch.equal(p_obs, r_obs), step
        assert torch.equal(p_rew, r_rew) and torch.equal(p_done, r_done)
        assert set(p_info) == set(r_info)
        for k in r_info:
            assert torch.equal(p_info[k], r_info[k]), (step, k)
        endings += [(w, r_info["success"][w].item(),
                     int(r_info["length"][w].item()))
                    for w in torch.nonzero(r_done)[:, 0].tolist()]
        pr_state, pr_obs = port.reset(port.sample_reset_draws(g_port))
        rr_state, rr_obs = ref.reset(ref.reset_draws(g_ref))
        assert torch.equal(pr_obs, rr_obs)
        p_state = select_state(p_done, pr_state, p_state)
        r_state = ref_envs.where_rows(r_done, rr_state, r_state)
        done4 = p_done[:, None, None, None]
        p_obs = torch.where(done4, pr_obs, p_obs)
    return endings


@pytest.mark.parametrize("env_type", ["Minigrid", "MysteryPath-Grid",
                                      "MortarMayhem-Grid"])
def test_envs_step_as_the_port(env_type):
    step_both(port_env_config(env_type), 6, 300)


class Commands:
    """Carries out each worker's commands: the move to a command's tile at
    the first step of its window, then stay. Odd workers step off, toward
    the centre, at the last step of one command's window an episode (a
    different one each episode), and so fail it."""

    def __init__(self, env, W):
        self.env, self.episode = env, [0] * W

    def __call__(self, state, actions):
        env = self.env
        out = actions.clone()
        for w in range(actions.shape[0]):
            t = int(state.t[w])
            if t == 0 and w % 2:
                self.episode[w] += 1
            if t < env.announce:
                continue                  # frozen: any action
            k, into = divmod(t - env.announce, env.per_command)
            out[w, 0] = 0
            if into == 0:
                out[w, 0] = state.commands[w, k]
            elif (w % 2 and into == env.per_command - 1
                  and k == (3 * self.episode[w] + w) % env.C):
                x, y = state.pos[w].tolist()
                centre = env.A // 2
                out[w, 0] = (2 if x < centre else 4 if x > centre
                             else 3 if y < centre else 1)
        return out


@pytest.mark.parametrize("duration", [2, 0])
def test_mortar_mayhem_commands_carried_out_as_the_port(duration):
    """Bit-equal over 300 steps of carried-out commands, and every ending
    seen. At the published 2 steps of explosion the last command is
    verified on the 120th step, so the cap ends every successful episode,
    and the odd workers' episodes end by failure (the last command's at
    the cap as well); with none (``duration`` 0) nothing fails, a command
    held to its last step is verified, and the odd workers' episodes run
    into the cap unverified."""
    raw = copy.deepcopy(port_env_config("MortarMayhem-Grid"))
    raw["reset_params"]["explosion_duration"] = [duration]
    W = 6
    ref = ref_envs.make_env(raw, W, "cpu")
    endings = step_both(raw, W, 300, Commands(ref, W))
    cap = ref.max_episode_steps
    success = {(w % 2, n) for w, won, n in endings if won == 1.0}
    failure = {(w % 2, n) for w, won, n in endings if won == 0.0}
    assert success == {(0, cap)}, endings
    if duration:
        assert {odd for odd, _ in failure} == {1}, endings
        assert min(n for _, n in failure) < cap, endings
    else:
        assert failure == {(1, cap)}, endings


def test_every_configured_env_type_resolves():
    types = {json.loads(p.read_text())["config"]["environment"]["type"]
             for p in (harness.HERE / "configs").glob("*.json")}
    for env_type in sorted(types | {"MortarMayhem-Grid"}):
        assert ref_envs.env_file(env_type).is_file(), env_type
        env = ref_envs.make_env({"type": env_type}, 2, "cpu")
        assert env.max_episode_steps > 0


def test_an_unknown_env_type_names_the_file_looked_for():
    with pytest.raises(NotImplementedError, match="env_no_such_env_v2.py"):
        ref_envs.make_env({"type": "No-Such  Env.v2"}, 2, "cpu")


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
    proc = subprocess.run(
        [sys.executable, "-c", PRECISION_PROBE.format(root=str(harness.ROOT))],
        capture_output=True, text=True, timeout=300, cwd=harness.ROOT,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == [
        False, False, "highest", False]
