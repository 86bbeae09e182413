"""etmppo_tpu_torch's rendering and ``enjoy``.

* ``utils/render.py`` writes GIFs and PNGs without PIL; PIL, which this
  test environment has, decodes them. Each decoded frame must equal the
  upscaled input exactly (a frame of at most 256 colours, as every frame of
  the image envs is) or its 3-3-2 quantisation (more colours). Against the
  GIF of ``etmppo_tpu.utils.render`` (written by PIL): PIL merges identical
  consecutive frames and sums their delays, the port writes every frame, so
  the frames are compared after consecutive identical ones are collapsed.
* ``PocMemoryEnv.render_ascii`` equals JAX's on the same states.
* ``cli.enjoy_main --cpu`` runs episodes on the raw-memory path, prints the
  episode lines and writes one GIF per episode of an image env, with a
  frame per step and the terminal observation.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from etmppo_tpu.config import load_config
from etmppo_tpu.envs.factory import create_env as jax_create_env
from etmppo_tpu.envs.poc_memory import PocMemoryEnv as JPoc
from etmppo_tpu.models.actor_critic import ActorCriticModel as JModel
from etmppo_tpu.training.checkpoint import save_model
from etmppo_tpu.utils.render import save_episode_gif as jax_save_episode_gif
from etmppo_tpu_torch import cli
from etmppo_tpu_torch.config import (MINIGRID_FLAGSHIP, MORTAR_MAYHEM_GRID,
                                     MYSTERY_PATH_GRID, SEARING_SPOTLIGHTS,
                                     config_from_dict)
from etmppo_tpu_torch.envs.factory import create_env
from etmppo_tpu_torch.envs.poc_memory import PocMemoryEnv, PocMemoryResetDraws
from etmppo_tpu_torch.utils.render import save_episode_gif
from PIL import Image

torch.set_num_threads(1)


def _decode(path):
    """Every frame of a GIF as RGB, with its delay in ms."""
    img = Image.open(path)
    frames = []
    for i in range(img.n_frames):
        img.seek(i)
        frames.append((np.asarray(img.convert("RGB")), img.info["duration"]))
    return frames


def _collapse(frames):
    out = []
    for frame, ms in frames:
        if not out or not np.array_equal(out[-1][0], frame):
            out.append((frame, ms))
    return out


def _upscaled(frame, scale):
    frame = np.asarray(frame)
    if frame.dtype != np.uint8:
        frame = (np.clip(frame, 0.0, 1.0) * 255).astype(np.uint8)
    if frame.ndim == 2:
        frame = frame[:, :, None]
    frame = np.repeat(frame, 3 // frame.shape[2], axis=2)
    return np.repeat(np.repeat(frame, scale, axis=0), scale, axis=1)


def _frames(kind, rng):
    if kind == "float, 5 colours":
        return [rng.integers(0, 5, (12, 9, 3)).astype(np.float32) / 4
                for _ in range(4)]
    if kind == "uint8, 256 colours":
        palette = rng.integers(0, 256, (256, 3), dtype=np.uint8)
        return [palette[rng.permutation(256).reshape(16, 16)]
                for _ in range(3)]
    if kind == "one channel":
        return [rng.integers(0, 256, (7, 5, 1), dtype=np.uint8)
                for _ in range(3)]
    if kind == "two dims":
        return [rng.uniform(size=(6, 6)).astype(np.float32) for _ in range(2)]
    return [np.zeros((3, 3, 3), np.float32)]


@pytest.mark.parametrize("scale", [1, 4])
@pytest.mark.parametrize("kind", ["float, 5 colours", "uint8, 256 colours",
                                  "one channel", "two dims", "one frame"])
def test_gif_decodes_to_the_upscaled_frames(tmp_path, kind, scale):
    frames = _frames(kind, np.random.default_rng(len(kind)))
    path = save_episode_gif(frames, str(tmp_path / "a" / "ep.gif"),
                            scale=scale, fps=4, png_dir=str(tmp_path / "png"))
    assert path == str(tmp_path / "a" / "ep.gif")
    decoded = _decode(path)
    assert len(decoded) == len(frames)
    img = Image.open(path)
    assert img.info["loop"] == 0
    for (got, ms), frame in zip(decoded, frames):
        np.testing.assert_array_equal(got, _upscaled(frame, scale))
        assert ms == 250
    assert sorted(os.listdir(tmp_path / "png")) == [
        f"frame_{i:04d}.png" for i in range(len(frames))]
    for i, frame in enumerate(frames):
        png = Image.open(tmp_path / "png" / f"frame_{i:04d}.png")
        np.testing.assert_array_equal(np.asarray(png.convert("RGB")),
                                      _upscaled(frame, scale))


def test_more_than_256_colours_are_quantised_to_3_3_2(tmp_path):
    frame = np.random.default_rng(0).integers(0, 256, (40, 50, 3),
                                              dtype=np.uint8)
    (got, _), = _decode(save_episode_gif([frame], str(tmp_path / "q.gif"),
                                         scale=1))
    r, g, b = (frame[..., i].astype(int) for i in range(3))
    want = np.stack([(r >> 5) * 255 // 7, (g >> 5) * 255 // 7,
                     (b >> 6) * 255 // 3], axis=-1)
    np.testing.assert_array_equal(got, want)


def test_no_frames_raise(tmp_path):
    with pytest.raises(ValueError):
        save_episode_gif([], str(tmp_path / "empty.gif"))


def _episode_frames(raw, steps=24, workers=2):
    """Observations of a short random episode of a port image env."""
    env = create_env(config_from_dict(raw).environment, workers, "cpu")
    gen = torch.Generator().manual_seed(0)
    state, obs = env.reset(env.sample_reset_draws(gen))
    frames = [obs.numpy()]
    for _ in range(steps):
        actions = torch.stack([torch.randint(0, n, (workers,), generator=gen)
                               for n in env.action_branches], dim=-1)
        state, obs, _, _, _ = env.step(state, actions,
                                       env.sample_step_draws(gen))
        frames.append(obs.numpy())
    return np.stack(frames, axis=1)      # (W, T + 1, H, W, C)


@pytest.mark.parametrize("name, raw", [
    ("minigrid", MINIGRID_FLAGSHIP), ("mysterypath", MYSTERY_PATH_GRID),
    ("mortarmayhem", MORTAR_MAYHEM_GRID),
    ("searingspotlights", SEARING_SPOTLIGHTS)])
def test_image_env_frames_are_written_exactly(tmp_path, name, raw):
    """Every frame of each image env has at most 256 colours, so the GIF
    holds it exactly; the collapsed sequence equals the JAX package's GIF
    of the same frames."""
    episodes = _episode_frames(raw)
    for w, frames in enumerate(episodes):
        u8 = (np.clip(frames, 0, 1) * 255).astype(np.uint8)
        assert all(len(np.unique(f.reshape(-1, 3), axis=0)) <= 256
                   for f in u8)
        frames = list(frames) + [frames[-1]] * 2   # consecutive repeats
        port = _decode(save_episode_gif(frames, str(tmp_path / f"{w}.gif")))
        assert len(port) == len(frames)
        for (got, _), frame in zip(port, frames):
            np.testing.assert_array_equal(got, _upscaled(frame, 4))
        jax_gif = jax_save_episode_gif(frames, str(tmp_path / f"j{w}.gif"))
        want = _collapse(_decode(jax_gif))
        got = _collapse(port)
        assert len(got) == len(want)
        for (a, _), (b, _) in zip(got, want):
            np.testing.assert_array_equal(a, b)
        assert {ms for _, ms in port} == {120}     # 125 ms in centiseconds


def test_render_ascii_matches_jax():
    jenv = JPoc(glob=False, freeze=True, max_episode_steps=32)
    env = PocMemoryEnv(glob=False, freeze=True, max_episode_steps=32,
                       n_workers=6, device="cpu")
    jstates, _ = jax.vmap(jenv.reset)(
        jax.random.split(jax.random.PRNGKey(3), 6))
    start = np.searchsorted(env.start_ticks.numpy(), np.asarray(jstates.ticks))
    state, _ = env.reset(PocMemoryResetDraws(
        torch.as_tensor(start).long(),
        torch.as_tensor(np.asarray(jstates.goals)[:, 0] == 1.0)))
    rng = np.random.default_rng(0)
    keys = jax.random.split(jax.random.PRNGKey(4), 6)
    for _ in range(6):
        for w in range(6):
            one = jax.tree_util.tree_map(lambda x: x[w], jstates)
            assert env.render_ascii(state, w) == jenv.render_ascii(one)
        actions = rng.integers(0, 2, (6, 1))
        jstates, *_ = jax.vmap(jenv.step)(jstates, jnp.asarray(actions), keys)
        state, *_ = env.step(state, torch.as_tensor(actions))
    assert "goals shown: False" in env.render_ascii(state)


def _tiny_model(directory, yaml, name):
    cfg = load_config(yaml)
    cfg = dataclasses.replace(
        cfg, hidden_layer_size=16,
        transformer=dataclasses.replace(
            cfg.transformer, num_blocks=1, embed_dim=16, num_heads=2,
            memory_length=8))
    env = jax_create_env(cfg.environment)
    model = JModel(config=cfg, obs_shape=env.observation_shape,
                   action_branches=env.action_branches,
                   max_episode_steps=env.max_episode_steps)
    path = str(directory / name)
    save_model(path, model.init_params(jax.random.PRNGKey(0)), cfg)
    return path


def test_enjoy_main_writes_a_gif_for_an_image_env(tmp_path, capsys):
    path = _tiny_model(tmp_path, "etmppo_tpu/configs/minigrid.yaml", "mg.nn")
    render_dir = str(tmp_path / "renders")
    returns = cli.enjoy_main([f"--model={path}", "--cpu", "--episodes=2",
                              f"--render-dir={render_dir}"])
    lines = capsys.readouterr().out.splitlines()
    lengths = [int(x.split(": ")[1]) for x in lines
               if x.startswith("Episode length: ")]
    assert len(returns) == len(lengths) == 2
    assert [float(x.split(": ")[1]) for x in lines
            if x.startswith("Episode reward: ")] == returns
    assert sum(x.startswith("Episode success: ") for x in lines) == 2
    for ep, length in enumerate(lengths):
        gif = os.path.join(render_dir, f"episode_{ep:03d}.gif")
        assert f"Episode rendered to {gif}" in lines
        frames = _decode(gif)
        assert len(frames) == length + 1
        assert frames[0][0].shape == (84 * 4, 84 * 4, 3)


def test_enjoy_prints_ascii_for_poc_memory(tmp_path, capsys):
    path = _tiny_model(tmp_path, "etmppo_tpu/configs/poc_memory_env.yaml",
                       "poc.nn")
    returns = cli.enjoy_main([f"--model={path}", "--cpu"])
    out = capsys.readouterr().out
    length = int(out.split("Episode length: ")[1].split()[0])
    assert out.count("goals shown: ") == length and len(returns) == 1
    assert not os.path.exists("renders/poc")
    cli.enjoy_main([f"--model={path}", "--cpu", "--no-render"])
    assert "goals shown" not in capsys.readouterr().out


def test_enjoy_needs_a_gpu_by_default(tmp_path, monkeypatch):
    path = _tiny_model(tmp_path, "etmppo_tpu/configs/poc_memory_env.yaml",
                       "poc.nn")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.enjoy_main([f"--model={path}"])
