"""Mortar Mayhem Grid's reset draws and its reset kernel
(``csrc/mortar_mayhem_reset.cu``, ``MortarMayhemReset``).

On the CPU: the uniforms and the pick (``sample_reset_uniforms``,
``commands_from_uniforms``) give the commands of the former
``sample_reset_draws`` to the bit; the env on the CPU takes
``TorchEnv.reset_done``'s default; ``reset`` with commands handed in is
unchanged; the kernel's wrapper refuses what the kernel does not take; every
env on CUDA takes the kernel. Against the JAX env:
``tests/test_torch_mortar_mayhem.py``.

On a card (marked ``card``, skipped without one): the kernel against the
default path to the bit, eager and inside a replayed CUDA graph, and a
graph-route training update with the kernel against one with the default
path. This file imports neither JAX nor the JAX package, so the card runs
it without the tests' conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_mortar_mayhem_reset.py
"""
import copy
import re
import tempfile

import pytest
import torch

from etmppo_tpu_torch.config import MORTAR_MAYHEM_GRID, config_from_dict
from etmppo_tpu_torch.envs.core import TorchEnv
from etmppo_tpu_torch.envs.mortar_mayhem import (MortarMayhemGridEnv,
                                                 MortarMayhemReset,
                                                 MortarMayhemResetDraws,
                                                 MortarMayhemResetUniforms,
                                                 MortarMayhemState)

W = 32
MORTAR_PARAMS = {
    "flagship": MORTAR_MAYHEM_GRID["environment"]["reset_params"],
    "diagonal": {"arena_size": 7, "allowed_commands": 9,
                 "command_count": [4, 6], "explosion_duration": [3],
                 "explosion_delay": [4], "reward_command_failure": -0.5,
                 "reward_command_success": 0.25,
                 "reward_episode_success": 1.0},
    # Neither 5 nor 9 allowed commands, and more than 64 commands.
    "long": {"arena_size": 9, "allowed_commands": 7, "command_count": [70],
             "explosion_duration": [1], "explosion_delay": [2]},
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


def _former_sample_reset_draws(env, generator):
    """``sample_reset_draws`` as it was before the draws were split into
    uniforms and a pick: the oracle of the split."""
    W = env.draw_width
    pos = env._start.expand(W, -1)
    commands = []
    for _ in range(env.command_count):
        cand = pos[:, None, :] + env._offsets
        ok = ((cand >= 0) & (cand < env.arena)).all(dim=2)
        u = torch.rand(W, generator=generator, device=env.device)
        pick = (u * ok.sum(dim=1)).long()
        rank = torch.cumsum(ok.long(), dim=1) - 1
        cmd = ((rank == pick[:, None]) & ok).long().argmax(dim=1)
        commands.append(cmd)
        pos = cand[torch.arange(W, device=env.device), cmd]
    return MortarMayhemResetDraws(torch.stack(commands, dim=1))


def _stepped(env, generator, steps=3):
    """A state some random steps in, and its frame."""
    state, obs = env.reset(env.sample_reset_draws(generator))
    for _ in range(steps):
        actions = torch.randint(0, env.allowed_commands, (env.n_workers, 1),
                                generator=generator, device=env.device)
        state, obs, *_ = env.step(state, actions)
    return state, obs


@pytest.mark.parametrize("params", sorted(MORTAR_PARAMS))
def test_uniforms_and_pick_give_the_former_draws(params):
    """Ten ``torch.rand(W)`` in turn, then the pick, draw the commands the
    former ``sample_reset_draws`` drew from the same generator state, and
    leave the generator where it left it."""
    env = MortarMayhemGridEnv(MORTAR_PARAMS[params], 512, "cpu")
    for seed in (0, 1, 2 ** 31 + 7):
        g_new, g_old = (torch.Generator().manual_seed(seed) for _ in range(2))
        for _ in range(3):
            uniforms = env.sample_reset_uniforms(g_new)
            assert uniforms.dtype == torch.float32
            assert uniforms.shape == (512, env.command_count)
            assert uniforms.is_contiguous()
            want = _former_sample_reset_draws(env, g_old)
            _assert_same_bits(env.commands_from_uniforms(uniforms),
                              want.commands, f"seed {seed}")
        _assert_same_bits(torch.rand(4, generator=g_new),
                          torch.rand(4, generator=g_old))
        g_draws = torch.Generator().manual_seed(seed)
        g_old = torch.Generator().manual_seed(seed)
        _assert_same_bits(env.sample_reset_draws(g_draws),
                          _former_sample_reset_draws(env, g_old))


@pytest.mark.parametrize("params", sorted(MORTAR_PARAMS))
def test_the_pick_at_the_uniforms_edges(params):
    """The largest uniform below 1 picks the last allowed command and 0 the
    first, from the centre (every command allowed) on."""
    env = MortarMayhemGridEnv(MORTAR_PARAMS[params], 2, "cpu")
    C = env.command_count
    below_one = torch.nextafter(torch.tensor(1.0), torch.tensor(0.0)).item()
    uniforms = torch.stack([torch.zeros(C), torch.full((C,), below_one)])
    commands = env.commands_from_uniforms(uniforms)
    assert commands[0, 0] == 0
    assert commands[1, 0] == env.allowed_commands - 1
    state, _ = env.reset(MortarMayhemResetDraws(commands))
    assert ((state.targets >= 0) & (state.targets < env.arena)).all()


def test_on_the_cpu_the_env_takes_the_default_reset_done(monkeypatch):
    """No kernel on the CPU: the draws are the commands, and ``reset_done``
    is ``TorchEnv``'s, called once a reset."""
    env = MortarMayhemGridEnv(MORTAR_PARAMS["flagship"], 4, "cpu")
    assert env.kernels == () and env.reset_kernel is None
    calls = []
    original = TorchEnv.reset_done

    def counted(self, *args):
        calls.append(args)
        return original(self, *args)
    monkeypatch.setattr(TorchEnv, "reset_done", counted)
    generator = torch.Generator().manual_seed(0)
    state, obs = _stepped(env, generator)
    draws = env.sample_reset_draws(generator)
    assert isinstance(draws, MortarMayhemResetDraws)
    env.reset_done(torch.tensor([True, False, True, False]), draws, state,
                   obs)
    assert len(calls) == 1


@pytest.mark.parametrize("params", sorted(MORTAR_PARAMS))
def test_reset_takes_commands_and_uniforms_alike(params):
    """``reset`` of commands handed in is the state the commands make (the
    centre, the walk's targets, zeroed counters), and ``reset`` of the
    uniforms equals ``reset`` of the commands picked from them; so does
    ``reset_done`` on the CPU."""
    env = MortarMayhemGridEnv(MORTAR_PARAMS[params], 6, "cpu")
    generator = torch.Generator().manual_seed(4)
    uniforms = env.sample_reset_uniforms(generator)
    commands = env.commands_from_uniforms(uniforms)
    state, obs = env.reset(MortarMayhemResetDraws(commands.int()))
    centre = env.arena // 2
    assert (state.pos == centre).all() and state.commands.dtype == torch.int64
    _assert_same_bits(state.commands, commands)
    walk = centre + torch.cumsum(env._offsets[commands], dim=1)
    _assert_same_bits(state.targets, walk)
    for field in ("t", "commands_done", "length"):
        assert (getattr(state, field) == 0).all(), field
    assert not state.failed.any() and (state.reward_sum == 0).all()
    _assert_same_bits(env.reset(MortarMayhemResetUniforms(uniforms)),
                      (state, obs))
    old_state, old_obs = _stepped(env, generator)
    done = torch.tensor([True, False, False, True, True, False])
    _assert_same_bits(
        env.reset_done(done, MortarMayhemResetUniforms(uniforms), old_state,
                       old_obs),
        env.reset_done(done, MortarMayhemResetDraws(commands), old_state,
                       old_obs))


def _reset_inputs(W=3, C=10):
    env = MortarMayhemGridEnv({"command_count": [C]}, W, "cpu")
    generator = torch.Generator().manual_seed(1)
    uniforms = MortarMayhemResetUniforms(env.sample_reset_uniforms(generator))
    state, obs = env.reset(uniforms)
    state = MortarMayhemState(*(x.clone() for x in state))
    return env, (torch.zeros(W, dtype=torch.bool), uniforms, state, obs)


def test_reset_kernel_takes_only_contiguous_cuda_tensors_of_its_shapes():
    """The wrapper checks before any build or launch: a CPU tensor, a wrong
    dtype, a wrong shape or a strided tensor raises ``ValueError``."""
    kernel = MortarMayhemReset()
    assert kernel.source.name == "mortar_mayhem_reset.cu"
    assert kernel.n_pointers == 21 and kernel.launches == 0
    env, inputs = _reset_inputs()
    fixed = (env._glyphs, env.arena, env.allowed_commands)
    with pytest.raises(ValueError, match="done must be on the CUDA device"):
        kernel(*inputs, *fixed)
    cases = {
        "done": lambda d, u, s, o: (d.long(), u, s, o),
        "uniforms": lambda d, u, s, o: (
            d, u._replace(uniforms=u.uniforms[:, :-1]), s, o),
        "reward_sum": lambda d, u, s, o: (
            d, u, s._replace(reward_sum=s.reward_sum.double()), o),
        "targets": lambda d, u, s, o: (
            d, u, s._replace(targets=s.targets.transpose(1, 2).contiguous()
                             .transpose(1, 2)), o),
        "failed": lambda d, u, s, o: (
            d, u, s._replace(failed=s.failed.long()), o),
        "obs": lambda d, u, s, o: (d, u, s, o.transpose(1, 2)),
    }
    for name, change in cases.items():
        with pytest.raises(ValueError, match=f"{name} must be a contiguous"):
            kernel(*change(*_reset_inputs()[1]), *fixed)
    with pytest.raises(ValueError, match="glyphs must be a contiguous"):
        kernel(*inputs, env._glyphs[:5], env.arena, env.allowed_commands)
    assert kernel.launches == 0


def test_reset_kernel_refuses_params_out_of_its_range():
    """What no env can run, and commands in place of the uniforms, the
    wrapper refuses with a message before any launch."""
    kernel = MortarMayhemReset()
    env, inputs = _reset_inputs()
    for arena, allowed, why in (
            (env.arena, 0, "allowed_commands 0 is not in [1, 9]"),
            (env.arena, 10, "allowed_commands 10 is not in [1, 9]"),
            (85, env.allowed_commands, "arena_size 85 is not in [1, 84]"),
            (0, env.allowed_commands, "arena_size 0 is not in [1, 84]")):
        with pytest.raises(ValueError, match=re.escape(why)):
            kernel(*inputs, env._glyphs, arena, allowed)
    done, uniforms, state, obs = inputs
    commands = MortarMayhemResetDraws(
        env.commands_from_uniforms(uniforms.uniforms))
    with pytest.raises(ValueError, match="the draws must be the uniforms"):
        kernel(done, commands, state, obs, env._glyphs, env.arena,
               env.allowed_commands)
    assert kernel.launches == 0


@pytest.mark.parametrize("params", [{"allowed_commands": 3},
                                    {"command_count": [70]},
                                    *MORTAR_PARAMS.values()])
def test_every_env_on_cuda_takes_the_kernel(params):
    """On CUDA every env builds the reset kernel, whatever its reset
    params, and lists it in ``kernels``. The kernel is made before the
    env's constants are put on the device, which cannot be done without a
    card."""
    env = MortarMayhemGridEnv.__new__(MortarMayhemGridEnv)
    try:
        env.__init__(params, 2, "cuda")
    except (AssertionError, RuntimeError):
        assert not torch.cuda.is_available()
    made = env.__dict__.get("reset_kernel")
    assert isinstance(made, MortarMayhemReset)
    assert env.kernels == (made,)


def test_draws_are_the_envs_named_tuples():
    """The kernel reads the uniforms, and the state in
    ``MortarMayhemState``'s order."""
    assert MortarMayhemResetUniforms._fields == ("uniforms",)
    assert MortarMayhemResetDraws._fields == ("commands",)
    assert MortarMayhemState._fields == (
        "pos", "commands", "targets", "t", "commands_done", "failed",
        "reward_sum", "length")


# --- on a card -------------------------------------------------------------


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _mask(kind, done, generator):
    if kind == "none":
        return torch.zeros_like(done)
    if kind == "all":
        return torch.ones_like(done)
    if kind == "one":
        one = torch.zeros_like(done)
        one[torch.randint(0, done.shape[0], (1,), generator=generator,
                          device=done.device)] = True
        return one
    return done | (torch.rand(done.shape, generator=generator,
                              device=done.device) < 0.25)


def _default(env, done, draws, state, obs):
    return TorchEnv.reset_done(env, done, draws, state, obs)


@pytest.mark.card
@pytest.mark.parametrize("workers", [1, W])
@pytest.mark.parametrize("params", sorted(MORTAR_PARAMS))
@pytest.mark.parametrize("kind", ["none", "one", "all", "random"])
def test_reset_kernel_equals_the_default_path(workers, params, kind):
    """240 steps of random actions, the kernel's reset taken at each with
    the mask forced (none, one, all) or the dones and a random quarter: its
    state and frame equal the default path's, bit for bit, with one launch a
    step; the commands it picks equal the former draws' from the same
    generator state."""
    device = _cuda()
    env = MortarMayhemGridEnv(MORTAR_PARAMS[params], workers, device)
    kernel = env.reset_kernel
    assert env.kernels == (kernel,)
    kernel.load()
    generator = torch.Generator(device).manual_seed(11)
    state, obs = env.reset(env.sample_reset_draws(generator))
    ended = 0
    for t in range(240):
        actions = torch.randint(0, env.allowed_commands, (workers, 1),
                                generator=generator, device=device)
        state, obs, _, done, _ = env.step(state, actions)
        mask = _mask(kind, done, generator)
        former = torch.Generator(device)
        former.set_state(generator.get_state())
        draws = env.sample_reset_draws(generator)
        assert isinstance(draws, MortarMayhemResetUniforms)
        want = _default(env, mask, draws, state, obs)
        got = env.reset_done(mask, draws, state, obs)
        _assert_same_bits(got, want, f"step {t}")
        picked = _former_sample_reset_draws(env, former).commands
        _assert_same_bits(env.commands_from_uniforms(draws.uniforms), picked)
        _assert_same_bits(got[0].commands[mask], picked[mask], f"step {t}")
        ended += int(mask.sum())
        state, obs = got
    torch.cuda.synchronize(device)
    assert kernel.launches == 240
    assert ended == {"none": 0, "one": 240,
                     "all": 240 * workers}.get(kind, ended)
    assert kind != "random" or ended > 240 * workers // 8


@pytest.mark.card
@pytest.mark.parametrize("params", sorted(MORTAR_PARAMS))
def test_reset_kernel_replays_in_a_cuda_graph(params):
    """The kernel captured into a CUDA graph: each of 6 replays, on new
    inputs copied into the graph's buffers, equals the default path."""
    device = _cuda()
    env = MortarMayhemGridEnv(MORTAR_PARAMS[params], W, device)
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
        actions = torch.randint(0, env.allowed_commands, (W, 1),
                                generator=generator, device=device)
        state, obs, _, done, _ = env.step(state, actions)
        mask = _mask("random", done, generator)
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
    """Mortar Mayhem Grid's flagship at 8 workers on the grouped pair (as
    its benchmark cell runs it), with a learning rate of 0: the parameters
    stay as they are."""
    raw = copy.deepcopy(MORTAR_MAYHEM_GRID)
    raw.update(n_workers=8, checkpoint_interval=0, summary_dir=tmp,
               checkpoint_dir=tmp, grouped_attention=True,
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
    state, to the bit, as with the env's draws and ``reset_done`` set back
    to the default path; the captured update holds 512 kernel launches and
    fewer nodes."""
    from etmppo_tpu_torch.training.trainer import PPOTrainer
    device = _cuda()
    runs = {}
    for path in ("kernel", "default"):
        with monkeypatch.context() as patch, \
                tempfile.TemporaryDirectory() as tmp:
            if path == "default":
                patch.setattr(MortarMayhemGridEnv, "reset_done",
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
