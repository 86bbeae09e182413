"""The port's fused launches (``training/fused.py``) against its own eager
updates and against the JAX package's ``FusedTrainLoop``, at the tiny size
of ``tests/test_fused.py`` (PocMemory, 4 workers x 16 steps, TrXL 2 x 16).

* A chunk is K eager updates: ``train_chunk(3)`` logs what three
  ``train_one_update`` calls log and ends in the same parameters, optimizer
  state, rollout state and generators, to the bit, on both loss paths, in
  bfloat16 and with ``obs_uint8``. On the CPU the route is ``eager``; the
  graph route's bookkeeping (the warm-up, the capture, the rollout state's
  buffers, the replayed launch counts, a resume) runs here on a stand-in
  for ``torch.cuda.graph`` whose replay runs the captured body.
* Against JAX: the same parameters, JAX's actions, reset draws and
  permutations injected; the packed ``ChunkOutputs`` have JAX's layout and
  key orders, and their values agree within the tolerances of
  ``tests/test_torch_training.py``'s full update (stats rtol 1e-3, atol
  1e-6); dones equal.
* ``run_training`` cuts the chunks where JAX's does, and reports the steady
  rate exactly when JAX's does.
"""
import contextlib
import copy
import dataclasses

import numpy as np
import pytest
import torch

import jax

from etmppo_tpu.config import load_config as jax_load_config
from etmppo_tpu.training.trainer import PPOTrainer as JaxTrainer
from etmppo_tpu_torch.config import config_from_dict
from etmppo_tpu_torch.envs.poc_memory import PocMemoryResetDraws
from etmppo_tpu_torch.interop import load_flax_params
from etmppo_tpu_torch.ops import distributions
from etmppo_tpu_torch.parallel.probe import CountingKernel
from etmppo_tpu_torch.training import fused as fused_lib
from etmppo_tpu_torch.training import trainer as trainer_lib
from etmppo_tpu_torch.training.ppo import STAT_NAMES
from etmppo_tpu_torch.training.trainer import PPOTrainer
from etmppo_tpu_torch.utils import runtime

torch.set_num_threads(1)


def _jax_cfg(tmp_path, **overrides):
    cfg = jax_load_config("etmppo_tpu/configs/poc_memory_env.yaml")
    fields = dict(
        n_workers=4, worker_steps=16, n_mini_batch=2, epochs=2,
        hidden_layer_size=16,
        transformer=dataclasses.replace(
            cfg.transformer, num_blocks=2, embed_dim=16, num_heads=2,
            memory_length=8),
        summary_dir=str(tmp_path / "summaries"),
        checkpoint_dir=str(tmp_path / "models"))
    fields.update(overrides)
    return dataclasses.replace(cfg, **fields)


def _raw(tmp_path, **overrides):
    """The same tiny config as a dict for the port."""
    return dataclasses.asdict(_jax_cfg(tmp_path, **overrides))


def _trainer(tmp_path, **overrides):
    return PPOTrainer(config_from_dict(_raw(tmp_path, **overrides)),
                      device="cpu", enable_metrics=False)


def _state(trainer):
    return copy.deepcopy(trainer._training_state())


def _assert_equal(a, b, where=""):
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b), where
    elif isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            _assert_equal(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_equal(x, y, f"{where}/{i}")
    else:
        assert a == b, where


# --- a chunk is K eager updates ------------------------------------------


@pytest.mark.parametrize("overrides", [
    {}, dict(use_pallas_attention=True),
    dict(compute_dtype="bfloat16"),
    dict(compute_dtype="bfloat16", use_pallas_attention=True,
         pallas_backward=True),
    dict(obs_uint8=True),
], ids=["gathered", "timeline", "gathered-bf16", "timeline-bf16", "uint8"])
def test_chunk_is_eager_updates_bit_for_bit(tmp_path, overrides):
    """The counterpart of test_fused_matches_unfused, held to the bit."""
    eager = _trainer(tmp_path, **overrides)
    fused = _trainer(tmp_path, **overrides)
    assert fused.fused_route == "eager"
    want = [eager.train_one_update() for _ in range(3)]
    got = fused.train_chunk(3)
    assert got == want
    assert all(np.isfinite(v) for r in got for v in r.values())
    assert list(fused.episode_infos) == list(eager.episode_infos)
    _assert_equal(_state(fused), _state(eager))
    assert {p.dtype for p in fused.model.parameters()} == {torch.float32}
    # the chunk's outputs stay on the device until the two copies
    assert fused.update == 3


def test_obs_uint8_chunk_trains_like_float_obs(tmp_path):
    """The counterpart of test_obs_uint8_storage_trains: the same seed with
    uint8 obs storage gives losses within quantization of the float run's."""
    r32 = _trainer(tmp_path).train_chunk(2)
    r8 = _trainer(tmp_path, obs_uint8=True).train_chunk(2)
    for a, b in zip(r32, r8):
        assert np.isfinite(b["loss"])
        assert abs(a["loss"] - b["loss"]) < 0.05


def test_chunk_outputs_layout(tmp_path):
    trainer = _trainer(tmp_path)
    schedule = trainer._schedule_values(2)
    assert schedule.shape == (2, 3) and schedule.dtype == np.float32
    state, outs = trainer.fused_loop(trainer.rollout_state, schedule)
    G = len(outs.grad_keys)
    assert outs.scalars.shape == (2, len(STAT_NAMES) + G + 2)
    assert outs.per_step.shape == (2, 1 + len(outs.info_keys), 4, 16)
    assert list(outs.grad_keys) == sorted(outs.grad_keys)
    assert outs.info_keys == ("length", "reward", "success")
    assert state is not trainer.rollout_state


# --- against the JAX package -----------------------------------------------


def _jax_reset_draws(env, jcfg, steps):
    """The reset draws of JAX's trainer (seed 0): init_state's, then per
    rollout step split(rng, 4) -> (rng, action, step, reset), read back from
    the states they make."""
    from etmppo_tpu.envs.factory import create_env
    jenv = create_env(jcfg.environment)
    reset = jax.jit(jax.vmap(jenv.reset))
    W = jcfg.n_workers
    _, _, state_rng, _ = jax.random.split(jax.random.PRNGKey(jcfg.seed), 4)
    rng, reset_rng = jax.random.split(state_rng)
    keys = [reset_rng]
    for _ in range(steps):
        rng, _, _, reset_rng = jax.random.split(rng, 4)
        keys.append(reset_rng)
    out = []
    for key in keys:
        states = reset(jax.random.split(key, W))[0]
        start = np.searchsorted(env.start_ticks.numpy(),
                                np.asarray(states.ticks))
        out.append(PocMemoryResetDraws(
            torch.as_tensor(start).long(),
            torch.as_tensor(np.asarray(states.goals)[:, 0] == 1.0)))
    return out


def _jax_perms(jcfg, updates):
    """Each update's permutations from JAX's trainer's update key."""
    _, _, _, rng = jax.random.split(jax.random.PRNGKey(jcfg.seed), 4)
    perms = []
    for _ in range(updates):
        rng, epoch_rng = jax.random.split(rng)
        perms.append(torch.as_tensor(np.stack([
            np.asarray(jax.random.permutation(k, jcfg.batch_size))
            for k in jax.random.split(epoch_rng, jcfg.epochs)])))
    return perms


@pytest.fixture(scope="module")
def against_jax(tmp_path_factory):
    """JAX's fused chunk of 3 and the port's, from the same parameters,
    with JAX's draws and permutations handed to the port. JAX's actions
    come from a JAX run of 3 eager updates of the same seed, which
    tests/test_fused.py holds to the fused chunk."""
    tmp = tmp_path_factory.mktemp("fused")
    K = 3
    jcfg = _jax_cfg(tmp, updates_per_launch=K)
    eager = JaxTrainer(_jax_cfg(tmp, updates_per_launch=1), run_id="e",
                       enable_metrics=False)
    actions = []
    rollout = eager.rollout_fn

    def recording(params, state):
        state, batch = rollout(params, state)
        actions.append(torch.as_tensor(np.asarray(batch.actions)).long())
        return state, batch
    eager.rollout_fn = recording
    for _ in range(K):
        eager.train_one_update()

    jax_fused = JaxTrainer(jcfg, run_id="f", enable_metrics=False)
    params = jax.tree.map(np.asarray, jax_fused.params)
    (jax_fused.params, jax_fused.opt_state, jax_fused.rollout_state,
     jax_fused._update_rng, jax_outs) = jax_fused.fused_loop(
        jax_fused.params, jax_fused.opt_state, jax_fused.rollout_state,
        jax_fused._update_rng, *jax_fused._schedule_values(K))

    port = PPOTrainer(config_from_dict(_raw(tmp, updates_per_launch=K)),
                      device="cpu", enable_metrics=False)
    load_flax_params(port.model, params)
    fn, upd = port.rollout_fn, port.update_fn
    draws = iter(_jax_reset_draws(port.env, jcfg, K * jcfg.worker_steps))
    fn.reset_draws = lambda: next(draws)
    taken = iter(actions)
    current = {}

    def sample_actions(logits, step):
        if step == 0:
            current["a"] = next(taken)
        a = current["a"][:, step]
        return a, torch.stack([distributions.log_prob(l, a[:, i])
                               for i, l in enumerate(logits)], dim=-1)
    fn.sample_actions = sample_actions
    perms = iter(_jax_perms(jcfg, K))
    run = upd.run
    upd.run = lambda batch, perms_=None: run(batch, next(perms))
    port.rollout_state = fn.init_state()
    _, outs = port.fused_loop(port.rollout_state, port._schedule_values(K))
    return jax_outs, outs


def test_chunk_outputs_have_jax_layout(against_jax):
    jax_outs, outs = against_jax
    assert outs.grad_keys == jax_outs.grad_keys
    assert outs.info_keys == jax_outs.info_keys
    assert tuple(outs.scalars.shape) == np.asarray(jax_outs.scalars).shape
    assert tuple(outs.per_step.shape) == np.asarray(jax_outs.per_step).shape


def test_chunk_matches_jax_fused_chunk(against_jax):
    jax_outs, outs = against_jax
    n = len(STAT_NAMES)
    want, got = np.asarray(jax_outs.scalars), outs.scalars.numpy()
    np.testing.assert_allclose(got[:, :n], want[:, :n], rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(got[:, n:], want[:, n:], rtol=1e-3, atol=1e-6)
    jax_steps, steps = np.asarray(jax_outs.per_step), outs.per_step.numpy()
    np.testing.assert_array_equal(steps[:, 0], jax_steps[:, 0])   # dones
    done = (steps[:, 0] == 1.0)[:, None]       # the infos are read there
    assert done.any()
    np.testing.assert_allclose(np.where(done, steps[:, 1:], 0.0),
                               np.where(done, jax_steps[:, 1:], 0.0),
                               rtol=1e-6)


# --- run_training's launches against JAX's -------------------------------


def _launch_sizes(trainer):
    """Runs ``trainer.run_training`` with its launches stubbed (each counts
    its updates and returns placeholder results) and returns the launch
    sizes and the result's keys."""
    sizes = []

    def chunk(k):
        sizes.append(k)
        trainer.update += k
        return [{name: 0.0 for name in STAT_NAMES}] * k

    def one():
        return chunk(1)[0]
    trainer.train_chunk = chunk
    trainer.train_one_update = one
    trainer._save_model = lambda: None
    trainer._save_checkpoint = lambda: None
    result = trainer.run_training(print_every=0)
    return sizes, "env_steps_per_second_steady" in result


@pytest.mark.parametrize("overrides,sizes", [
    (dict(updates=6, updates_per_launch=4), [4, 2]),
    (dict(updates=6, updates_per_launch=4, checkpoint_interval=3), [3, 3]),
    (dict(updates=4, updates_per_launch=4), [4]),
    (dict(updates=3, updates_per_launch=1), [1, 1, 1]),
])
def test_launch_sizes_match_jax(tmp_path, overrides, sizes):
    jax_trainer = JaxTrainer(_jax_cfg(tmp_path, **overrides), run_id="j",
                             enable_metrics=False)
    want = _launch_sizes(jax_trainer)
    got = _launch_sizes(_trainer(tmp_path, **overrides))
    assert got == want
    assert got[0] == sizes
    assert got[1] == (len(sizes) > 1)


def test_host_env_runs_update_by_update(tmp_path):
    """A host env has no fused launch, in both packages (JAX's
    ``fused_loop is None``)."""
    raw = dict(_raw(tmp_path, updates=3, updates_per_launch=4),
               environment={"type": "PocMemoryEnv-native"})
    trainer = PPOTrainer(config_from_dict(raw), device="cpu",
                         enable_metrics=False)
    try:
        assert trainer.fused_loop is None and trainer.fused_route is None
        with pytest.raises(RuntimeError, match="update by update"):
            trainer.train_chunk(2)
        got = _launch_sizes(trainer)
    finally:
        trainer.close()
    jax_trainer = JaxTrainer(
        _jax_cfg(tmp_path, updates=3, updates_per_launch=4), run_id="j",
        enable_metrics=False)
    jax_trainer.fused_loop = None         # what a JAX host env trainer has
    assert got == _launch_sizes(jax_trainer) == ([1, 1, 1], True)


def test_run_training_prints_every_update_after_its_chunk(tmp_path, capsys):
    trainer = _trainer(tmp_path, updates=3, updates_per_launch=2)
    result = trainer.run_training()
    out = capsys.readouterr().out
    assert out.count("fused launches: eager route") == 1
    assert [line.split()[0] for line in out.splitlines()
            if "pi_loss=" in line] == ["0", "1", "2"]
    assert result["env_steps_per_second_steady"] > 0


# --- resume across a chunk boundary ---------------------------------------


def test_resume_across_a_chunk_boundary_is_bit_for_bit(tmp_path):
    raw = _raw(tmp_path, updates=8, updates_per_launch=4,
               checkpoint_interval=4)
    straight = PPOTrainer(config_from_dict(raw), run_id="straight",
                          device="cpu", enable_metrics=False)
    straight.run_training(print_every=0)
    first = PPOTrainer(config_from_dict(dict(raw, updates=4)), run_id="cut",
                       device="cpu", enable_metrics=False)
    first.run_training(print_every=0)
    resumed = PPOTrainer(config_from_dict(raw), run_id="cut", device="cpu",
                         enable_metrics=False)
    assert resumed.resume_from_checkpoint() and resumed.update == 4
    result = resumed.run_training(print_every=0)
    assert "env_steps_per_second_steady" not in result    # one launch
    state = _state(resumed)
    want = _state(straight)
    for key in ("model", "optimizer", "rollout_state", "rollout_generator",
                "update_generator", "update"):
        _assert_equal(state[key], want[key], key)


# --- the route --------------------------------------------------------------


def test_routes():
    cuda = torch.device("cuda", 0)
    assert fused_lib.choose_route(torch.device("cpu"), None)[0] == "eager"
    assert fused_lib.choose_route(cuda, None)[0] == "graph"
    assert fused_lib.choose_route(cuda, object())[0] == "graph"
    runtime.set_debug_nans(True)
    try:
        route, why = fused_lib.choose_route(cuda, None)
    finally:
        runtime.set_debug_nans(False)
    assert route == "eager" and "debug-nans" in why
    mesh = object()
    loop = fused_lib.FusedTrainLoop(None, None, "graph", mesh=mesh)
    assert loop.route == "graph" and loop.mesh is mesh
    with pytest.raises(ValueError, match="route"):
        fused_lib.FusedTrainLoop(None, None, "jit")


def test_debug_nans_after_the_graph_route_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(trainer_lib, "choose_route",
                        lambda device, mesh: ("graph", "stand-in"))
    trainer = _trainer(tmp_path)
    runtime.set_debug_nans(True)
    try:
        with pytest.raises(RuntimeError, match="debug-nans"):
            trainer.train_chunk(1)
    finally:
        runtime.set_debug_nans(False)


# --- the graph route's bookkeeping, on a stand-in graph ---------------------


class _StandInGraph:
    """``torch.cuda.CUDAGraph`` on the CPU: the capture runs the body and
    then puts back every value it changed (a capture computes nothing); a
    replay runs the body again."""
    body = None
    trainer = None
    captures = 0

    def __init__(self, keep_graph=False):
        self.replays = 0

    def register_generator_state(self, generator):
        assert generator in (self.trainer.rollout_fn.generator,
                             self.trainer.update_fn.generator)

    def instantiate(self):
        pass

    def replay(self):
        """Runs the body; a replay runs no Python, so the kernels' counts
        are put back (the loop adds the captured launches itself)."""
        self.replays += 1
        upd = self.trainer.update_fn
        kernels = (upd.kernel, upd.backward_kernel)
        counts = [k.launches for k in kernels]
        type(self).body()
        for k, n in zip(kernels, counts):
            k.launches = n


class _StandInCapture:
    def __init__(self, graph, stream=None):
        self.trainer = graph.trainer

    def __enter__(self):
        t = self.trainer
        _StandInGraph.captures += 1
        self.values = [x.clone() for x in self._tensors()]
        self.generators = [g.get_state() for g in (
            t.rollout_fn.generator, t.update_fn.generator)]

    def _tensors(self):
        t = self.trainer
        loop = t.fused_loop
        optimizer = [v for s in t.update_fn.optimizer.state.values()
                     for v in s.values()]
        return (list(t.model.parameters()) + optimizer
                + fused_lib.state_tensors(loop._state) + list(loop._outputs))

    def __exit__(self, *exc):
        for x, v in zip(self._tensors(), self.values):
            x.data.copy_(v)
        for g, s in zip((self.trainer.rollout_fn.generator,
                         self.trainer.update_fn.generator), self.generators):
            g.set_state(s)
        return False


class _Stream:
    def wait_stream(self, other):
        pass


def _stand_in_graphs(monkeypatch, trainer):
    _StandInGraph.trainer = trainer
    _StandInGraph.body = trainer.fused_loop._graph_body
    _StandInGraph.captures = 0
    for name, value in dict(
            CUDAGraph=_StandInGraph, graph=_StandInCapture,
            Stream=lambda device=None: _Stream(),
            stream=lambda s: contextlib.nullcontext(),
            current_stream=lambda device=None: _Stream(),
            synchronize=lambda device=None: None,
            empty_cache=lambda: None,
            memory_reserved=lambda device=None: 0).items():
        monkeypatch.setattr(torch.cuda, name, value)
    monkeypatch.setattr(fused_lib, "graph_nodes", lambda graph: 0)


def test_graph_route_bookkeeping_on_a_stand_in(tmp_path, monkeypatch):
    """On the graph route: update 1 warms up eagerly and the body is
    captured once in the same launch; every later update replays it. The
    chunks equal eager updates to the bit, a train_one_update between
    chunks is adopted into the buffers, the launch counts stay the number
    of kernel calls that ran, and a resume forgets the graph."""
    raw = _raw(tmp_path, use_pallas_attention=True, pallas_backward=True,
               checkpoint_interval=4)
    eager = PPOTrainer(config_from_dict(raw), run_id="eager", device="cpu",
                       enable_metrics=False)
    monkeypatch.setattr(trainer_lib, "choose_route",
                        lambda device, mesh: ("graph", "stand-in"))
    graph = PPOTrainer(config_from_dict(raw), run_id="graph", device="cpu",
                       enable_metrics=False)
    assert graph.fused_route == "graph"
    for t in (eager, graph):
        upd = t.update_fn
        upd.kernel = CountingKernel(upd.kernel)
        upd.backward_kernel = CountingKernel(upd.backward_kernel)
    _stand_in_graphs(monkeypatch, graph)
    loop = graph.fused_loop

    want = [eager.train_one_update() for _ in range(4)]
    assert graph.train_chunk(3) == want[:3]
    assert _StandInGraph.captures == 1 and loop._graph.replays == 2
    assert graph.rollout_state is loop._state
    assert graph.train_one_update() == want[3]      # eager, rebinds the state
    assert graph.rollout_state is not loop._state
    want += [eager.train_one_update() for _ in range(2)]
    assert graph.train_chunk(2) == want[4:]         # adopts, then replays
    assert _StandInGraph.captures == 1 and loop._graph.replays == 4
    _assert_equal(_state(graph), _state(eager))
    for name in ("kernel", "backward_kernel"):
        e, g = (getattr(t.update_fn, name).launches for t in (eager, graph))
        assert e == g > 0

    graph._save_checkpoint()
    resumed = PPOTrainer(config_from_dict(raw), run_id="graph", device="cpu",
                         enable_metrics=False)
    _StandInGraph.trainer = resumed
    assert resumed.resume_from_checkpoint() and resumed.update == 6
    resumed.fused_loop._graph = "stale"
    assert resumed.resume_from_checkpoint()
    assert resumed.fused_loop._graph is None       # forgotten
    _StandInGraph.body = resumed.fused_loop._graph_body
    want += [eager.train_one_update() for _ in range(2)]
    keys = STAT_NAMES + ("value_mean", "advantage_mean")   # the episode
    for got, w in zip(resumed.train_chunk(2), want[6:]):   # statistics
        assert {k: got[k] for k in keys} == {k: w[k] for k in keys}  # restart
    assert _StandInGraph.captures == 2
    _assert_equal(_state(resumed)["model"], _state(eager)["model"])


def test_optimizer_state_loads_across_devices(tmp_path):
    """A checkpoint's optimizer state written by a capturable AdamW (the
    card's: its learning rate a tensor, its step counts on the device)
    loads into the CPU's AdamW, which stays non-capturable and trains on,
    as the card's keeps its own ``capturable``."""
    source = _trainer(tmp_path)
    source.train_one_update()
    state = copy.deepcopy(source.update_fn.optimizer.state_dict())
    for group in state["param_groups"]:
        group.update(capturable=True, lr=torch.tensor(group["lr"]))
    target = _trainer(tmp_path)
    target.update_fn.load_optimizer_state(state)
    groups = target.update_fn.optimizer.param_groups
    assert [g["capturable"] for g in groups] == [False] * len(groups)
    result = target.train_one_update()
    assert all(np.isfinite(v) for v in result.values())
    assert all(isinstance(g["lr"], float) for g in groups)
