"""The frozen arithmetic: the FLOP count against PyTorch's counter on the
benchmark's own reference, and a window-attention call's bound on
hand-made indices."""
import math

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import yardstick
from portbench.reference import model as ref_model
from portbench.reference.envs import make_env

SMALL = dict(hidden_layer_size=24, transformer=dict(
    num_blocks=2, embed_dim=16, num_heads=2, memory_length=8,
    positional_encoding="relative", layer_norm="post", gtrxl=False))


def small_cfg(env_type, layer_norm):
    cfg = dict(SMALL, environment=dict(type=env_type,
                                       name="MiniGrid-MemoryS9-v0"))
    cfg["transformer"] = dict(SMALL["transformer"], layer_norm=layer_norm)
    return cfg


@pytest.mark.parametrize("env_type,layer_norm", [
    ("Minigrid", "post"), ("MysteryPath-Grid", "pre")])
def test_forward_and_backward_flops_match_the_counter(env_type, layer_norm):
    cfg = small_cfg(env_type, layer_norm)
    env = make_env(cfg["environment"], 1, "cpu")
    spec = ref_model.param_spec(cfg, env.observation_shape,
                                env.action_branches)
    weights = {k: v.requires_grad_(True) for k, v in
               ref_model.make_weights(spec, 3, "cpu").items()}
    m = ref_model.Model(cfg, env.observation_shape, env.action_branches,
                        env.max_episode_steps, "cpu")
    B, L = 5, cfg["transformer"]["memory_length"]
    obs = torch.rand((B,) + env.observation_shape)
    window = torch.rand(B, L, 2, 16)
    e = torch.arange(B) * 7
    _, mask, slots = m.window(torch.zeros(B, env.max_episode_steps, 2, 16), e)
    f = yardstick.forward_flops(cfg, env.observation_shape,
                                env.action_branches)
    per_sample = f["conv1"] + f["dense"] + f["attention"]
    with FlopCounterMode(display=False) as fwd:
        logits, value, _ = m.forward(weights, obs, window, mask, slots)
    # The reference projects each sample's L window rows itself.
    assert fwd.get_total_flops() == B * per_sample + B * L * f["kv_row"]
    with FlopCounterMode(display=False) as bwd:
        (value.sum() + sum(lg.sum() for lg in logits)).backward()
    # Backward: twice the forward's products, the first convolution's
    # weights alone, attention 8 L D a block; the K/V rows' weights, and
    # their inputs too under pre-LN.
    kv_bwd = f["kv_row"] * (2 if layer_norm == "pre" else 1)
    assert bwd.get_total_flops() == B * (
        f["conv1"] + 2 * f["dense"] + 2 * f["attention"]) + B * L * kv_bwd


def test_update_flops_add_up():
    cfg = dict(small_cfg("Minigrid", "post"), n_workers=4, worker_steps=8,
               epochs=3, n_mini_batch=2)
    env = make_env(cfg["environment"], 1, "cpu")
    f = yardstick.forward_flops(cfg, env.observation_shape,
                                env.action_branches)
    rows = 32
    fwd = f["conv1"] + f["dense"] + f["attention"]
    bwd = f["conv1"] + 2 * f["dense"] + 2 * f["attention"]
    want = rows * (fwd + f["kv_row"]) + 3 * (
        rows * (fwd + bwd) + 2 * rows * 2 * f["kv_row"])
    assert yardstick.update_flops(cfg, env) == want
    assert yardstick.step_flops(cfg, env.observation_shape,
                                env.action_branches, 7) == 7 * (
        fwd + f["kv_row"])


def test_window_bound_counts_each_row_once():
    # Two workers, T = 4 steps, max_ep = 5, L = 3, D = 8. Worker 0 starts
    # an episode at step 0 that runs past the rollout. Worker 1 enters the
    # rollout at episode step 3 (timeline rows 0..2 hold its slots 0..2),
    # ends that episode at step 1 and starts one at step 2 (row 5).
    steps = torch.tensor([[0, 1, 2, 3], [3, 4, 0, 1]])
    dones = torch.tensor([[False] * 4, [False, True, False, False]])
    src = yardstick.timeline_sources(steps, dones, max_ep=5, L=3)
    assert src.s_lo.tolist() == [[0, 0, 0, 1], [1, 2, 0, 0]]
    assert src.start.tolist() == [[0, 0, 0, 1], [1, 2, 5, 5]]
    # The new episode's windows hold its slots 0..1 written in the rollout;
    # slot 2 is a PE-only row.
    assert src.n_valid.tolist() == [[3, 3, 3, 3], [3, 3, 2, 2]]
    idx = torch.tensor([0, 3, 6])               # (w0, t0), (w0, t3), (w1, t2)
    S = 5 + 4 + 3
    # Rows: w0 0..2 and 1..3 -> 4 distinct; w1 5..6 -> 2; PE row 2 for
    # (w1, t2)'s third slot: 7 rows of K and V, D floats each.
    n_bytes = 2 * 7 * 8 * 4 + 2 * 3 * 8 * 4 + 4 * 3 * 4 + 3 * 3
    t = yardstick.window_bound_s(src, idx, 4, 2, 5, 3, 8, backward=False)
    assert math.isclose(t, max(n_bytes / yardstick.H100_BYTES_PER_S,
                               4 * 3 * 3 * 8 / yardstick.H100_FP32_FLOPS))
    back = n_bytes + 3 * 8 * 4 + 2 * (2 * S + 5) * 8 * 4
    t = yardstick.window_bound_s(src, idx, 4, 2, 5, 3, 8, backward=True)
    assert math.isclose(t, max(back / yardstick.H100_BYTES_PER_S,
                               8 * 3 * 3 * 8 / yardstick.H100_FP32_FLOPS))
