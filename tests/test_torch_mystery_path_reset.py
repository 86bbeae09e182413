"""The rollout's auto-reset, ``TorchEnv.reset_done``, and Mystery Path Grid's
reset kernel (``csrc/mystery_path_reset.cu``, ``MysteryPathReset``).

On the CPU: the default ``reset_done`` is the reset of all workers kept
where done (``select_state`` and the obs ``where``) for every device env;
Mystery Path Grid on the CPU takes that default; the kernel's wrapper
refuses what the kernel does not take. Against the JAX env's auto-reset:
``tests/test_torch_mystery_path.py``.

On a card (marked ``card``, skipped without one): the kernel against the
default path to the bit, eager and inside a replayed CUDA graph, and a
graph-route training update with the kernel against one with the default
path. This file imports neither JAX nor the JAX package, so the card runs
it without the tests' conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_mystery_path_reset.py
"""
import copy
import tempfile

import pytest
import torch

from etmppo_tpu_torch.config import MYSTERY_PATH_GRID, EnvConfig, config_from_dict
from etmppo_tpu_torch.envs.core import TorchEnv, select_state
from etmppo_tpu_torch.envs.factory import create_env
from etmppo_tpu_torch.envs.mystery_path import (MysteryPathGridEnv,
                                                MysteryPathReset,
                                                MysteryPathResetDraws)

W = 32
MYSTERY_PARAMS = {
    "flagship": MYSTERY_PATH_GRID["environment"]["reset_params"],
    "shown_and_rewarded": {"arena_size": 9, "cardinal_origin_choice": [1, 3],
                           "show_origin": True, "show_goal": True,
                           "reward_fall_off": -0.1,
                           "reward_path_progress": 0.05},
}
DEVICE_ENVS = {
    "PocMemoryEnv": EnvConfig(type="PocMemoryEnv"),
    "CartPole": EnvConfig(type="CartPole"),
    "CartPoleMasked": EnvConfig(type="CartPoleMasked"),
    "Minigrid": EnvConfig(type="Minigrid", name="MiniGrid-MemoryS9-v0"),
    "MysteryPath-Grid": EnvConfig(
        type="MysteryPath-Grid", reset_params=MYSTERY_PARAMS["flagship"]),
    "MortarMayhem-Grid": EnvConfig(type="MortarMayhem-Grid"),
    "SearingSpotlights": EnvConfig(type="SearingSpotlights"),
}


def _assert_same_bits(got, want, label=""):
    """Tensors (or NamedTuples of them) equal bit for bit."""
    if isinstance(want, tuple):
        for name, a, b in zip(getattr(want, "_fields", range(len(want))),
                              got, want):
            _assert_same_bits(a, b, f"{label}.{name}")
        return
    assert got.dtype == want.dtype and got.shape == want.shape, label
    if want.is_floating_point():
        got, want = got.view(torch.int32), want.view(torch.int32)
    assert torch.equal(got, want), label


def _default(env, done, draws, state, obs):
    return TorchEnv.reset_done(env, done, draws, state, obs)


def _stepped(env, generator, steps=3):
    """A state some random steps in, and its frame."""
    state, obs = env.reset(env.sample_reset_draws(generator))
    for _ in range(steps):
        actions = torch.stack([torch.randint(0, n, (env.n_workers,),
                                             generator=generator,
                                             device=env.device)
                               for n in env.action_branches], dim=1)
        state, obs, *_ = env.step(state, actions,
                                  env.sample_step_draws(generator))
    return state, obs


@pytest.mark.parametrize("name", sorted(DEVICE_ENVS))
def test_default_reset_done_keeps_the_reset_where_done(name):
    """The default is the rollout's former auto-reset: every worker reset
    from the draws, the reset kept where done, the rest kept as it was."""
    env = create_env(DEVICE_ENVS[name], 6, "cpu")
    generator = torch.Generator().manual_seed(3)
    state, obs = _stepped(env, generator)
    draws = env.sample_reset_draws(generator)
    done = torch.tensor([True, False, False, True, True, False])
    got_state, got_obs = env.reset_done(done, draws, state, obs)
    reset_state, reset_obs = env.reset(draws)
    _assert_same_bits(got_state, select_state(done, reset_state, state))
    _assert_same_bits(got_obs, torch.where(
        done.reshape((-1,) + (1,) * (obs.dim() - 1)), reset_obs, obs))
    for w in range(6):
        source = (reset_state, reset_obs) if done[w] else (state, obs)
        _assert_same_bits(got_obs[w], source[1][w])
        for got, want in zip(got_state, source[0]):
            _assert_same_bits(got[w], want[w])


def test_on_the_cpu_no_env_has_a_kernel_and_only_mystery_path_overrides():
    """On the CPU no env has a kernel; the two envs with a reset kernel on
    CUDA (Mystery Path Grid and Mortar Mayhem Grid) override ``reset_done``
    to take it there, the others keep the default."""
    for name, env_config in DEVICE_ENVS.items():
        env = create_env(env_config, 2, "cpu")
        assert env.kernels == () and env.reset_kernel is None, name
        assert (type(env).reset_done is TorchEnv.reset_done) == (
            name not in ("MysteryPath-Grid", "MortarMayhem-Grid")), name


def test_mystery_path_takes_the_default_on_the_cpu(monkeypatch):
    env = MysteryPathGridEnv(MYSTERY_PARAMS["shown_and_rewarded"], 4, "cpu")
    calls = []
    original = TorchEnv.reset_done

    def counted(self, *args):
        calls.append(args)
        return original(self, *args)
    monkeypatch.setattr(TorchEnv, "reset_done", counted)
    generator = torch.Generator().manual_seed(0)
    state, obs = _stepped(env, generator)
    env.reset_done(torch.tensor([True, False, True, False]),
                   env.sample_reset_draws(generator), state, obs)
    assert len(calls) == 1


def _reset_inputs():
    env = MysteryPathGridEnv({"arena_size": 7}, 3, "cpu")
    draws = env.sample_reset_draws(torch.Generator().manual_seed(1))
    state, obs = env.reset(draws)
    return torch.zeros(3, dtype=torch.bool), draws, state, obs


def test_reset_kernel_takes_only_contiguous_cuda_tensors_of_its_shapes():
    """The wrapper checks before any build or launch: a CPU tensor, a wrong
    dtype, a wrong shape or a strided tensor raises ``ValueError``."""
    kernel = MysteryPathReset()
    assert kernel.source.name == "mystery_path_reset.cu"
    assert kernel.n_pointers == 28 and kernel.launches == 0
    with pytest.raises(ValueError, match="done must be on the CUDA device"):
        kernel(*_reset_inputs(), False, False)
    cases = {
        "done": lambda d, dr, s, o: (d.long(), dr, s, o),
        "moves": lambda d, dr, s, o: (d, dr._replace(moves=dr.moves[:, :-1]),
                                      s, o),
        "reward_sum": lambda d, dr, s, o: (
            d, dr, s._replace(reward_sum=s.reward_sum.double()), o),
        "obs": lambda d, dr, s, o: (d, dr, s, o.transpose(1, 2)),
    }
    for name, change in cases.items():
        with pytest.raises(ValueError, match=f"{name} must be a contiguous"):
            kernel(*change(*_reset_inputs()), False, False)
    done, draws, state, obs = _reset_inputs()
    state = state._replace(on_path=torch.zeros(3, 85, 85, dtype=torch.bool))
    with pytest.raises(ValueError, match="arena_size 85 is not in"):
        kernel(done, draws, state, obs, False, False)
    assert kernel.launches == 0


def test_capture_counts_only_the_envs_reset_kernel():
    """``capture["reset_launches"]`` reads the env's ``reset_kernel`` alone:
    another kernel of the env, or the window-attention pair, is not a
    reset."""
    from types import SimpleNamespace

    from etmppo_tpu_torch.training.fused import FusedTrainLoop
    reset, other, window = (MysteryPathReset() for _ in range(3))
    launches = {reset: 512, other: 7, window: 48}
    for env, want in ((SimpleNamespace(kernels=(other, reset),
                                       reset_kernel=reset), 512),
                      (SimpleNamespace(kernels=(other,), reset_kernel=None), 0),
                      (create_env(DEVICE_ENVS["Minigrid"], 2, "cpu"), 0)):
        loop = SimpleNamespace(rollout_fn=SimpleNamespace(env=env))
        assert FusedTrainLoop._reset_launches(loop, launches) == want


# --- on a card -------------------------------------------------------------


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _masks(kind, done, generator):
    if kind == "all_false":
        return torch.zeros_like(done)
    if kind == "all_true":
        return torch.ones_like(done)
    return done | (torch.rand(done.shape, generator=generator,
                              device=done.device) < 0.25)


@pytest.mark.card
@pytest.mark.parametrize("params", sorted(MYSTERY_PARAMS))
@pytest.mark.parametrize("kind", ["all_false", "all_true", "random"])
def test_reset_kernel_equals_the_default_path(params, kind):
    """240 steps of random actions on W = 32 workers, the kernel's reset
    taken at each: its state and frame equal the default path's, bit for
    bit, with one launch a step."""
    device = _cuda()
    env = MysteryPathGridEnv(MYSTERY_PARAMS[params], W, device)
    kernel = env.reset_kernel
    assert env.kernels == (kernel,)
    kernel.load()
    generator = torch.Generator(device).manual_seed(11)
    state, obs = env.reset(env.sample_reset_draws(generator))
    ended = 0
    for t in range(240):
        actions = torch.randint(0, 4, (W, 1), generator=generator,
                                device=device)
        state, obs, _, done, _ = env.step(state, actions)
        mask = _masks(kind, done, generator)
        draws = env.sample_reset_draws(generator)
        want = _default(env, mask, draws, state, obs)
        got = env.reset_done(mask, draws, state, obs)
        _assert_same_bits(got, want, f"step {t}")
        ended += int(mask.sum())
        state, obs = got
    torch.cuda.synchronize(device)
    assert kernel.launches == 240
    assert ended == {"all_false": 0, "all_true": 240 * W}.get(kind, ended)
    assert kind != "random" or ended > 240 * W // 8


@pytest.mark.card
@pytest.mark.parametrize("params", sorted(MYSTERY_PARAMS))
def test_reset_kernel_replays_in_a_cuda_graph(params):
    """The kernel captured into a CUDA graph: each of 6 replays, on new
    inputs copied into the graph's buffers, equals the default path."""
    device = _cuda()
    env = MysteryPathGridEnv(MYSTERY_PARAMS[params], W, device)
    env.reset_kernel.load()
    generator = torch.Generator(device).manual_seed(5)
    state, obs = env.reset(env.sample_reset_draws(generator))
    # A buffer per field: a reset's counters share one tensor of zeros.
    inputs = [torch.zeros(W, dtype=torch.bool, device=device),
              env.sample_reset_draws(generator),
              type(state)(*(x.clone() for x in state)), obs.clone()]
    buffers = (inputs[0], *inputs[1], *inputs[2], inputs[3])
    stream = torch.cuda.Stream(device)
    stream.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(stream):
        env.reset_done(*inputs)                                # warm-up
    torch.cuda.current_stream(device).wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = env.reset_done(*inputs)
    for replay in range(6):
        actions = torch.randint(0, 4, (W, 1), generator=generator,
                                device=device)
        state, obs, _, done, _ = env.step(state, actions)
        mask = _masks("random", done, generator)
        draws = env.sample_reset_draws(generator)
        for buffer, value in zip(buffers, (mask, *draws, *state, obs)):
            buffer.copy_(value)
        graph.replay()
        want = _default(env, mask, draws, state, obs)
        _assert_same_bits(out, want, f"replay {replay}")
        state, obs = (type(out[0])(*(x.clone() for x in out[0])),
                      out[1].clone())
    torch.cuda.synchronize(device)


def _update_config(tmp):
    """Mystery Path Grid's flagship at 8 workers, with a learning rate of 0:
    the parameters stay as they are, so the second update's rollout does not
    hang on the order of the backward kernel's float atomics."""
    raw = copy.deepcopy(MYSTERY_PATH_GRID)
    raw.update(n_workers=8, checkpoint_interval=0, summary_dir=tmp,
               checkpoint_dir=tmp,
               learning_rate_schedule=dict(initial=0.0, final=0.0, power=1.0,
                                           max_decay_steps=1))
    return config_from_dict(raw)


class _KeepBatches:
    """Stands in for the loop's rollout function and keeps each batch (on
    a capture, the graph's own tensors, which the replays fill)."""

    def __init__(self, fn):
        self._fn, self.batches = fn, []

    def __call__(self, state):
        final, batch = self._fn(state)
        self.batches.append(batch)
        return final, batch

    def __getattr__(self, name):
        return getattr(self._fn, name)


BATCH_FIELDS = ("obs", "actions", "log_probs", "values", "advantages",
                "episode_steps", "dones")


@pytest.mark.card
def test_graph_route_update_with_the_kernel_equals_the_default(monkeypatch):
    """8 workers x 512 steps on the graph route: the eager warm-up update
    and a replayed one with the kernel make the same batches and rollout
    state, to the bit, as with ``reset_done`` set back to the default; the
    captured update holds 512 kernel launches and fewer nodes."""
    from etmppo_tpu_torch.training.trainer import PPOTrainer
    device = _cuda()
    runs = {}
    for path in ("kernel", "default"):
        with monkeypatch.context() as patch, \
                tempfile.TemporaryDirectory() as tmp:
            if path == "default":
                patch.setattr(MysteryPathGridEnv, "reset_done",
                              TorchEnv.reset_done)
            trainer = PPOTrainer(_update_config(tmp), run_id=path,
                                 device=device, enable_metrics=False)
            assert trainer.fused_route == "graph"
            loop = trainer.fused_loop
            loop.rollout_fn = keep = _KeepBatches(loop.rollout_fn)
            trainer.train_chunk(2)
            torch.cuda.synchronize(device)
            runs[path] = dict(
                batches=[{f: getattr(b, f).clone() for f in BATCH_FIELDS}
                         for b in keep.batches],
                state=[x.clone() for x in (*trainer.rollout_state.env_state,
                                           *trainer.rollout_state[1:])],
                capture=dict(loop.capture),
                launches=trainer.env.reset_kernel.launches)
            print(path, runs[path]["capture"], "kernel launches",
                  runs[path]["launches"])
            trainer.close()
            del trainer, loop, keep
            torch.cuda.empty_cache()
    kernel, default = runs["kernel"], runs["default"]
    assert kernel["capture"]["reset_launches"] == 512
    assert kernel["launches"] == 2 * 512       # the warm-up and one replay
    assert default["capture"]["reset_launches"] == default["launches"] == 0
    assert kernel["capture"]["nodes"] < default["capture"]["nodes"]
    assert len(kernel["batches"]) == len(default["batches"]) == 2
    for u, (a, b) in enumerate(zip(kernel["batches"], default["batches"])):
        assert bool(a["dones"].any()), u
        for f in BATCH_FIELDS:
            _assert_same_bits(a[f], b[f], f"update {u} {f}")
    for i, (a, b) in enumerate(zip(kernel["state"], default["state"])):
        _assert_same_bits(a, b, f"rollout state {i}")


def test_draws_are_the_envs_named_tuple():
    """The kernel reads the draws in ``MysteryPathResetDraws``' order."""
    assert MysteryPathResetDraws._fields == ("edge", "lateral0", "moves")
