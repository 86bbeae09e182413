"""Fused launches under a mesh (``updates_per_launch`` at ``num_devices >
1``) in etmppo_tpu_torch, on the CPU:

* ``PPOUpdate.rank_parts`` (a rank's part of each global minibatch at the
  fixed size C = min(M, W/N * T), padded and masked, with no host read)
  against ``rank_parts_oracle.rank_minibatches`` (the variable-size part,
  sized on the host);
* the padded part's loss, stats and gradients against the variable part's
  on the four loss paths (the per-sample and grouped kernel pairs' plain
  versions, the gathered-window loss, the raw-window loss), and an all-pad
  part's exact zeros;
* the graph route on two real gloo ranks (``parallel.mesh.spawn``, the
  ranks run ``parallel.probe.fused_against_eager``) on a stand-in for
  ``torch.cuda.graph`` (``probe.StandInGraphs``: a capture runs the segment
  and puts back what it changed, a replay runs it again): a launch of 3
  equals three eager mesh updates to the bit, each segment is captured once
  and replayed as often as it runs, the launch and traffic counts equal the
  eager twin's, a resume forgets the graphs, and a rank perturbed between
  two updates of a launch makes the launch's end raise naming the update;
* the ranks' launch against JAX's ``num_devices: 2`` fused chunk on the
  conftest mesh, with JAX's parameters, reset draws, actions and
  permutations.

Tolerances:

* ``PART_RTOL``: a padded part sums its real rows with pad rows of exact
  zeros, in other blocks than the variable part, so the loss, stats and
  gradients agree to float32 summation order: 1e-6 relative, and 1e-6 of
  the largest gradient of a tensor absolute.
* Against JAX (``tests/test_torch_data_parallel.py``'s): the stats, the
  value and advantage means to 1e-3 relative and 1e-6 absolute; every
  parameter within ``2 * lr`` per AdamW step and 99% of them within 1e-5.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax

from etmppo_tpu.config import ScheduleConfig
from etmppo_tpu.config import load_config as jax_load_config
from etmppo_tpu.training.trainer import PPOTrainer as JaxTrainer
from etmppo_tpu_torch.config import config_from_dict
from etmppo_tpu_torch.envs.factory import create_env
from etmppo_tpu_torch.envs.poc_memory import PocMemoryResetDraws
from etmppo_tpu_torch.interop import flax_to_state_dict
from etmppo_tpu_torch.parallel import probe
from etmppo_tpu_torch.parallel.mesh import DataMesh, spawn
from etmppo_tpu_torch.training.ppo import STAT_NAMES, PPOUpdate
from etmppo_tpu_torch.training.rollout import RolloutBatch
from etmppo_tpu_torch.training.trainer import PPOTrainer
from rank_parts_oracle import rank_minibatches

torch.set_num_threads(1)

PART_RTOL = 1e-6
STATS_RTOL = 1e-3
LR, CLIP, BETA = 3e-4, 0.1, 0.001
SPAWN = dict(device="cpu", timeout=300, collective_timeout=120)


# --- rank_parts against rank_minibatches ------------------------------------

PARTS_W, PARTS_T = 12, 5


def _minibatches(case: str, n: int, M: int) -> torch.Tensor:
    """Rows of global minibatches of M samples: slices of permutations of
    all samples, or of all but the last rank's (which then holds none)."""
    g = torch.Generator().manual_seed(10 * n + M)
    span = PARTS_W * PARTS_T
    if case == "a rank without":
        span -= PARTS_W // n * PARTS_T
    return torch.stack([torch.randperm(span, generator=g)[:M]
                        for _ in range(6)])


def _update(mesh, **raw):
    """A PPOUpdate of a tiny PocMemory config under ``mesh``."""
    cfg = config_from_dict(dict(
        environment={"type": "PocMemoryEnv"}, n_workers=PARTS_W,
        worker_steps=PARTS_T, n_mini_batch=1, hidden_layer_size=8,
        transformer={"num_blocks": 1, "embed_dim": 8, "num_heads": 1,
                     "memory_length": 4}, **raw))
    trainer = PPOTrainer(dataclasses.replace(cfg, num_devices=1),
                         device="cpu", enable_metrics=False)
    return PPOUpdate(cfg, trainer.model, trainer.max_episode_steps, None,
                     mesh=mesh)


@pytest.mark.parametrize("case", ["all ranks", "a rank without"])
@pytest.mark.parametrize("M", [13, 41])
@pytest.mark.parametrize("n", [2, 3, 4])
def test_rank_parts_hold_the_variable_parts(n, M, case):
    """M % N != 0; with M = 41 a part's capacity W/N * T is below M (with
    two ranks and one without, the minibatch is the other's 30 samples)."""
    mb = _minibatches(case, n, M)
    M = mb.shape[1]
    per_rank = PARTS_W // n * PARTS_T
    total = torch.zeros(len(mb), dtype=torch.int64)
    for r in range(n):
        upd = _update(DataMesh(r, n, "cpu", "gloo"))
        parts = upd.rank_parts(mb)
        C = min(M, per_rank)
        assert parts.local.shape == parts.mask.shape == (len(mb), C)
        assert parts.local.dtype == torch.int64
        assert parts.mask.dtype == torch.float32
        for j, want in enumerate(rank_minibatches(upd, mb)):
            count = int(parts.counts[j])
            assert count == len(want)
            assert torch.equal(parts.local[j, :count], want)
            assert torch.equal(parts.mask[j],
                               (torch.arange(C) < count).float())
            pads = parts.local[j, count:]
            expect = (want[torch.arange(count, C) % count] if count
                      else torch.zeros(C, dtype=torch.int64))
            assert torch.equal(pads, expect)      # real samples, repeated
        assert ((parts.local >= 0) & (parts.local < per_rank)).all()
        total += parts.counts
    assert (total == M).all()
    if case == "a rank without":
        upd = _update(DataMesh(n - 1, n, "cpu", "gloo"))
        parts = upd.rank_parts(mb)
        assert (parts.counts == 0).all() and not parts.mask.any()


# --- the padded loss against the variable part -------------------------------

W, T = 6, 8


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A tiny MiniGrid trainer (CNN, TrXL, relative PE) and a batch whose
    snapshot holds memory carried in from an earlier rollout."""
    tmp = tmp_path_factory.mktemp("fused_mesh")
    cfg = config_from_dict(dict(
        environment={"type": "Minigrid", "name": "MiniGrid-MemoryS9-v0"},
        epochs=1, n_workers=W, worker_steps=T, n_mini_batch=1,
        hidden_layer_size=16,
        transformer={"num_blocks": 2, "embed_dim": 16, "num_heads": 2,
                     "memory_length": 4, "positional_encoding": "relative",
                     "layer_norm": "post"},
        use_pallas_attention=True, pallas_backward=True,
        summary_dir=str(tmp), checkpoint_dir=str(tmp)))
    trainer = PPOTrainer(cfg, device="cpu", enable_metrics=False)
    state, _ = trainer.rollout_fn(trainer.rollout_state)
    _, batch = trainer.rollout_fn(state)
    assert batch.snapshot.any()
    return trainer, batch


def _rank_batch(batch: RolloutBatch, rows: slice) -> RolloutBatch:
    return RolloutBatch(*(
        {k: v[rows] for k, v in f.items()} if isinstance(f, dict) else f[rows]
        for f in batch))


def _loss_grads(upd, path, batch, idx, global_adv, mask=None):
    """The loss, stats and gradients of the samples ``idx`` of ``batch``
    (a rank's rows) on loss ``path``, ``mask`` its padding."""
    prep = (upd.prepare_timeline if path == "timeline"
            else upd.prepare_gathered)
    memory, slots, fields = prep(batch)
    loss_fn = dict(timeline=upd.loss_timeline, gathered=upd.loss_gathered,
                   window=upd.loss_window)[path]
    mb = upd.minibatch(fields, idx, global_adv, mask)
    upd.model.zero_grad(set_to_none=True)
    loss, stats = loss_fn(mb, memory, slots, 0.1, 0.001)
    loss.backward()
    return loss.detach(), stats, [p.grad.clone()
                                  for p in upd.model.parameters()]


@pytest.mark.parametrize("case", ["all ranks", "a rank without"])
@pytest.mark.parametrize("path", ["timeline", "grouped", "gathered",
                                  "window"])
def test_padded_part_equals_the_variable_part(trained, path, case):
    """Two ranks, a global minibatch of 13 samples; with ``a rank
    without`` rank 1 holds none and its all-pad part gives exact zeros."""
    trainer, batch = trained
    g = torch.Generator().manual_seed(3)
    span = W * T if case == "all ranks" else W // 2 * T
    idx = torch.randperm(span, generator=g)[:13]
    adv = batch.advantages.reshape(-1)[idx]
    loss_path = "timeline" if path == "grouped" else path
    for r in range(2):
        mesh = DataMesh(r, 2, "cpu", "gloo")
        config = dataclasses.replace(trainer.config,
                                     grouped_attention=path == "grouped")
        upd = PPOUpdate(config, trainer.model, trainer.max_episode_steps,
                        None, mesh=mesh)
        part = _rank_batch(batch, mesh.worker_rows(W))
        parts = upd.rank_parts(idx[None])
        loss, stats, grads = _loss_grads(upd, loss_path, part,
                                         parts.local[0], adv, parts.mask[0])
        (mine,) = rank_minibatches(upd, idx[None])
        if len(mine) == 0:
            assert case == "a rank without" and r == 1
            assert float(loss) == 0.0 and not stats.any()
            assert not any(g.any() for g in grads)
            continue
        want_loss, want_stats, want_grads = _loss_grads(upd, loss_path, part,
                                                        mine, adv)
        np.testing.assert_allclose(float(loss), float(want_loss),
                                   rtol=PART_RTOL)
        np.testing.assert_allclose(stats.numpy(), want_stats.numpy(),
                                   rtol=PART_RTOL, atol=1e-7)
        for (name, _), a, b in zip(trainer.model.named_parameters(), grads,
                                   want_grads):
            np.testing.assert_allclose(
                a.numpy(), b.numpy(), rtol=PART_RTOL,
                atol=PART_RTOL * float(b.abs().max()), err_msg=name)


# --- the graph route on two ranks, on a stand-in ----------------------------


def _tiny(tmp_path, **overrides):
    """PocMemory at 4 workers x 8 steps on the timeline loss and its kernel
    pair (plain versions on the CPU); minibatches of 8 samples, some of
    which a rank holds none of."""
    raw = dict(
        environment={"type": "PocMemoryEnv"}, updates=8, epochs=2,
        n_workers=4, worker_steps=8, n_mini_batch=4, hidden_layer_size=16,
        transformer={"num_blocks": 2, "embed_dim": 16, "num_heads": 2,
                     "memory_length": 4, "layer_norm": "pre", "gtrxl": True},
        use_pallas_attention=True, pallas_backward=True, num_devices=2,
        summary_dir=str(tmp_path / "summaries"),
        checkpoint_dir=str(tmp_path / "models"))
    raw.update(overrides)
    return config_from_dict(raw)


CHUNK = 3


@pytest.fixture(scope="module")
def graph_ranks(tmp_path_factory):
    """Each rank's ``fused_against_eager``: a launch of CHUNK on the
    stand-in graph route against one on the eager route, a resume and one
    more launch of each, then a launch in which rank 1 flips a bit of a
    parameter after update 1."""
    tmp = tmp_path_factory.mktemp("graph_ranks")
    cfg = _tiny(tmp)
    ranks = spawn(probe.fused_against_eager, 2, (cfg, CHUNK), kwargs=dict(
        stand_in=True, resume=True, perturb=(1, 1), threads=1), **SPAWN)
    return cfg, ranks


def test_graph_launch_equals_eager_updates_bit_for_bit(graph_ranks):
    _, ranks = graph_ranks
    for r in ranks:
        assert r["route"] == "graph"
        assert r["mismatches"] == []
        assert len(r["results"]) == CHUNK
        assert all(np.isfinite(v) for res in r["results"]
                   for v in res.values())
    assert ranks[0]["results"] == ranks[1]["results"]
    for a, b in zip(ranks[0]["digests"], ranks[1]["digests"]):
        assert torch.equal(a, b)


def test_each_segment_is_captured_once_and_replayed(graph_ranks):
    """Update 1 warms up, the capture follows it, updates 2-3 replay:
    ``part`` and ``step`` once a minibatch, the others once an update."""
    cfg, ranks = graph_ranks
    per_update = cfg.epochs * cfg.n_mini_batch
    replayed = CHUNK - 1
    for r in ranks:
        assert r["graphs"] == {
            "rollout": (1, replayed), "prepare": (1, replayed),
            "part": (1, replayed * per_update),
            "step": (1, replayed * per_update),
            "result": (1, replayed), "outputs": (1, replayed)}
        assert set(r["capture"]["segments"]) == set(r["graphs"])


def test_launch_and_traffic_counts_equal_the_eager_twin(graph_ranks):
    cfg, ranks = graph_ranks
    per_update = cfg.epochs * cfg.n_mini_batch
    for r in ranks:
        launches = r["launches"]
        assert launches["fused"] == launches["eager"]
        # forward and backward: 2 blocks a minibatch, a rank with no sample
        # of one launches all the same
        assert launches["fused"] == [[2 * per_update * CHUNK] * 2]
        traffic = r["traffic"]
        assert traffic["fused"] == traffic["eager"]
        assert traffic["fused"]["gradients"]["calls"] == per_update * CHUNK
        assert traffic["fused"]["advantages"]["calls"] == CHUNK
        assert traffic["fused"]["replica check"]["calls"] == 1


def test_a_resume_forgets_the_graphs(graph_ranks):
    _, ranks = graph_ranks
    for r in ranks:
        assert r["forgot"]
        again = r["after_resume"]
        assert again["mismatches"] == []
        assert {name: c for name, (c, _) in again["graphs"].items()} == {
            name: 1 for name in r["graphs"]}


def test_a_perturbed_rank_fails_the_launch_naming_the_update(graph_ranks):
    _, ranks = graph_ranks
    for r in ranks:
        assert r["raised"] is not None
        assert f"after update 2 of {CHUNK} in this launch" in r["raised"]


# --- against the JAX package's num_devices: 2 fused chunk ------------------


def _jax_cfg(tmp_path, **overrides):
    cfg = jax_load_config("etmppo_tpu/configs/poc_memory_env.yaml")
    fields = dict(
        n_workers=4, worker_steps=16, n_mini_batch=2, epochs=2,
        hidden_layer_size=16, num_devices=2,
        transformer=dataclasses.replace(
            cfg.transformer, num_blocks=2, embed_dim=16, num_heads=2,
            memory_length=8),
        learning_rate_schedule=ScheduleConfig(LR, LR, 1.0, 1),
        beta_schedule=ScheduleConfig(BETA, BETA, 1.0, 1),
        clip_range_schedule=ScheduleConfig(CLIP, CLIP, 1.0, 1),
        summary_dir=str(tmp_path / "summaries"),
        checkpoint_dir=str(tmp_path / "models"))
    fields.update(overrides)
    return dataclasses.replace(cfg, **fields)


def _jax_reset_draws(jcfg, env_config, steps):
    """The reset draws of JAX's trainer (seed 0): init_state's, then per
    rollout step split(rng, 4) -> (rng, action, step, reset), read back from
    the states they make."""
    from etmppo_tpu.envs.factory import create_env as jax_create_env
    jenv = jax_create_env(jcfg.environment)
    env = create_env(env_config, jcfg.n_workers, "cpu")
    reset = jax.jit(jax.vmap(jenv.reset))
    _, _, state_rng, _ = jax.random.split(jax.random.PRNGKey(jcfg.seed), 4)
    rng, reset_rng = jax.random.split(state_rng)
    keys = [reset_rng]
    for _ in range(steps):
        rng, _, _, reset_rng = jax.random.split(rng, 4)
        keys.append(reset_rng)
    out = []
    for key in keys:
        states = reset(jax.random.split(key, jcfg.n_workers))[0]
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


def test_two_rank_launch_matches_jax_num_devices_2_fused_chunk(tmp_path):
    """JAX's fused chunk of 2 on a 2-device mesh; the port's two ranks run
    one launch of 2 with JAX's parameters, reset draws, actions (from a
    JAX run of 2 eager updates on the same mesh, which tests/test_fused.py
    holds to the fused chunk) and permutations, each rank its rows."""
    assert len(jax.devices()) >= 2
    K = 2
    eager = JaxTrainer(_jax_cfg(tmp_path, updates_per_launch=1),
                       run_id="e", enable_metrics=False)
    assert eager.mesh is not None
    actions = []
    rollout = eager.rollout_fn

    def recording(params, state):
        state, batch = rollout(params, state)
        actions.append(torch.as_tensor(np.array(batch.actions)).long())
        return state, batch
    eager.rollout_fn = recording
    for _ in range(K):
        eager.train_one_update()

    jcfg = _jax_cfg(tmp_path, updates_per_launch=K)
    jax_fused = JaxTrainer(jcfg, run_id="f", enable_metrics=False)
    params = jax.tree.map(np.asarray, jax_fused.params)
    (j_params, _, _, _, jax_outs) = jax_fused.fused_loop(
        jax_fused.params, jax_fused.opt_state, jax_fused.rollout_state,
        jax_fused._update_rng, *jax_fused._schedule_values(K))

    cfg = config_from_dict(dataclasses.asdict(jcfg))
    replay = probe.Replay(
        reset=_jax_reset_draws(jcfg, cfg.environment, K * jcfg.worker_steps),
        actions=torch.cat(actions, dim=1), perms=_jax_perms(jcfg, K))
    ranks = spawn(probe.train, 2, (cfg,), kwargs=dict(
        updates=K, chunk=K, replay=replay,
        state_dict=flax_to_state_dict(params), threads=1), **SPAWN)
    assert torch.equal(ranks[0]["digests"][0], ranks[1]["digests"][0])
    assert ranks[0]["results"] == ranks[1]["results"]
    scalars = np.asarray(jax_outs.scalars)
    n, G = len(STAT_NAMES), len(jax_outs.grad_keys)
    for k, got in enumerate(ranks[0]["results"]):
        want = dict(zip(STAT_NAMES, scalars[k, :n]),
                    value_mean=scalars[k, n + G],
                    advantage_mean=scalars[k, n + G + 1])
        for key, value in want.items():
            np.testing.assert_allclose(got[key], value, rtol=STATS_RTOL,
                                       atol=1e-6, err_msg=f"{k} {key}")
    got, want = ranks[0]["params"][0], flax_to_state_dict(j_params)
    diffs = np.concatenate([(got[name] - torch.as_tensor(np.asarray(w)))
                            .abs().numpy().ravel()
                            for name, w in want.items()])
    assert diffs.max() <= 2 * LR * K * jcfg.epochs * jcfg.n_mini_batch
    assert np.quantile(diffs, 0.99) <= 1e-5
