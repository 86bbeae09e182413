"""Watch a trained agent (counterpart of ``etmppo_tpu/enjoy.py``).

Loads a saved model and its config, rebuilds the env with one worker and
runs episodes on the raw-memory path: at episode step t the full
``model.forward`` over ``memory[index_table[t]]`` with mask row
``min(t, L-1)``, then ``memory[t] = new_memory``.

    python -m etmppo_tpu_torch.enjoy --model=models/run.nn [--episodes=N] \
        [--cpu] [--no-render] [--render-dir=D]

It runs on the CUDA device unless ``--cpu`` is given, and raises without a
GPU. With rendering, an env with ``render_ascii`` prints each state and an
image env writes one animated GIF per episode to
``<render-dir>/episode_NNN.gif`` (default ``renders/<model-stem>/``).
"""
from __future__ import annotations

import os
from typing import List, Optional

import torch

from .envs.factory import create_env
from .ops import distributions
from .ops.memory_index import build_memory_indices, build_memory_mask
from .training.checkpoint import load_model


@torch.no_grad()
def run_episodes(model_path: str, episodes: int = 1, render: bool = True,
                 seed: int = 0, render_dir: Optional[str] = None,
                 device="cuda") -> List[float]:
    """Runs ``episodes`` episodes and returns their returns. The resets and
    the env's step draws come from a generator seeded ``seed``, the actions
    from one seeded ``seed + 1``, both on ``device``."""
    model, config = load_model(model_path, device)
    device = model.lin_hidden.weight.device
    env = create_env(config.environment, 1, device)
    trx = config.transformer
    L = trx.memory_length
    max_ep = env.max_episode_steps
    mask_table = torch.as_tensor(build_memory_mask(L), device=device)
    index_table = torch.as_tensor(build_memory_indices(max_ep, L),
                                  device=device).long()
    env_generator = torch.Generator(device).manual_seed(seed)
    action_generator = torch.Generator(device).manual_seed(seed + 1)

    is_image_env = len(env.observation_shape) == 3
    if render and is_image_env and render_dir is None:
        stem = os.path.splitext(os.path.basename(model_path))[0]
        render_dir = os.path.join("renders", stem)

    returns = []
    for ep in range(episodes):
        state, obs = env.reset(env.sample_reset_draws(env_generator))
        memory = torch.zeros(max_ep, trx.num_blocks, trx.embed_dim,
                             device=device)
        done, t, info, frames = False, 0, {}, []
        while not done:
            if render and hasattr(env, "render_ascii"):
                print(env.render_ascii(state))
            if render and is_image_env:
                frames.append(obs[0].cpu().numpy())
            indices = index_table[t][None]
            logits, _, new_memory = model(
                obs, memory[indices[0]][None], mask_table[min(t, L - 1)][None],
                indices)
            memory[t] = new_memory[0]
            actions, _ = distributions.sample_multi(logits, action_generator)
            state, obs, _, done_t, info = env.step(
                state, actions, env.sample_step_draws(env_generator))
            done = bool(done_t[0])
            t += 1
        ep_return = float(info["reward"][0])
        returns.append(ep_return)
        print(f"Episode length: {int(info['length'][0])}")
        print(f"Episode reward: {ep_return}")
        if "success" in info:
            print(f"Episode success: {bool(info['success'][0])}")
        if render and is_image_env and frames:
            from .utils.render import save_episode_gif
            frames.append(obs[0].cpu().numpy())   # terminal observation
            path = save_episode_gif(
                frames, os.path.join(render_dir, f"episode_{ep:03d}.gif"))
            print(f"Episode rendered to {path}")
    return returns


if __name__ == "__main__":
    from .cli import enjoy_main
    enjoy_main()
