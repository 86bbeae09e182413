"""etmppo_tpu_torch.parallel on the CPU: the mesh (counterpart of
tests/test_sharding.py's mesh tests), the multi-host helpers (counterpart
of tests/test_multihost.py, a real 2-process gloo group), and the
data-parallel loss in one process: each rank's part of a global minibatch,
with the global advantage statistics and denominator, summed over the
ranks, is the whole minibatch's loss.

Every spawned group meets at a rendezvous of its own and is bounded by
``spawn``'s timeouts; ``spawn`` kills what survives.
"""
import dataclasses
import socket
from typing import NamedTuple

import numpy as np
import pytest
import torch
import torch.distributed as dist

from etmppo_tpu_torch.config import config_from_dict
from etmppo_tpu_torch.parallel import multihost, probe
from etmppo_tpu_torch.parallel.mesh import (DATA_AXIS, DataMesh,
                                            flat_views,
                                            gather_worker_tree, make_mesh,
                                            replica_digest, replicate_tree,
                                            shard_worker_tree, spawn)
from etmppo_tpu_torch.training.ppo import STAT_NAMES, PPOUpdate
from etmppo_tpu_torch.training.rollout import RolloutBatch
from etmppo_tpu_torch.training.trainer import PPOTrainer
from rank_parts_oracle import rank_minibatches

torch.set_num_threads(1)

# Summed over the ranks, the ranks' gradients and stats equal the whole
# minibatch's up to float32 summation order.
GRAD_RTOL = 1e-5


@pytest.fixture
def one_rank_group(tmp_path):
    """A gloo group of one rank in this process, destroyed afterwards."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_make_mesh_and_data_mesh(one_rank_group):
    mesh = make_mesh(1, "cpu")
    assert (mesh.rank, mesh.size, mesh.backend) == (0, 1, "gloo")
    assert mesh.device == torch.device("cpu") and DATA_AXIS == "data"
    assert mesh.is_primary
    assert mesh.worker_rows(6) == slice(0, 6)
    x = torch.arange(6.0).reshape(3, 2)
    assert torch.equal(mesh.gather_workers(x), x)
    assert torch.equal(mesh.all_reduce_(x.clone()), x)
    assert mesh.traffic["gather"] == dict(calls=1, bytes=24, seconds=
                                          mesh.traffic["gather"]["seconds"])
    with pytest.raises(ValueError, match="holds 1 ranks"):
        make_mesh(2, "cpu")
    with pytest.raises(ValueError, match="runs gloo, not nccl"):
        make_mesh(1, "cpu", backend="nccl")
    rank1 = DataMesh(1, 2, "cpu", "gloo")
    assert rank1.worker_rows(8) == slice(4, 8) and not rank1.is_primary
    with pytest.raises(ValueError, match="divisible by num_devices"):
        rank1.worker_rows(7)


def test_make_mesh_needs_a_group():
    with pytest.raises(RuntimeError, match="spawn"):
        make_mesh(2, "cpu")


class _Draws(NamedTuple):
    start: torch.Tensor
    swapped: torch.Tensor


def test_shard_worker_tree_placement():
    """Counterpart of test_shard_worker_tree_placement: worker-leading
    leaves keep this rank's rows, everything else stays whole."""
    mesh = DataMesh(1, 2, "cpu", "gloo")
    n = 4
    gen_state = torch.Generator().manual_seed(0).get_state()
    tree = dict(workers=torch.arange(n * 5).reshape(n, 5),
                key=gen_state, scalar=torch.tensor(1.0),
                obs=np.arange(n * 3).reshape(n, 3),
                draws=_Draws(torch.arange(n), torch.arange(n) % 2 == 0),
                counter=7)
    placed = shard_worker_tree(tree, mesh, n)
    assert torch.equal(placed["workers"], tree["workers"][2:])
    assert torch.equal(placed["key"], gen_state)
    assert torch.equal(placed["scalar"], tree["scalar"])
    assert np.array_equal(placed["obs"], tree["obs"][2:])
    assert isinstance(placed["draws"], _Draws)
    assert torch.equal(placed["draws"].start, torch.tensor([2, 3]))
    assert placed["counter"] == 7
    assert shard_worker_tree(tree, None, n) is tree
    assert gather_worker_tree(tree, None) is tree
    assert replicate_tree(tree, None) is tree


def test_replica_digest_sees_one_bit():
    a = [torch.randn(5, 3), torch.randn(7)]
    b = [t.clone() for t in a]
    assert torch.equal(replica_digest(a), replica_digest(b))
    b[1].view(torch.int32)[3] ^= 1
    assert not torch.equal(replica_digest(a), replica_digest(b))


def test_local_worker_range_and_its_assert(monkeypatch):
    assert list(multihost.local_worker_range(16)) == list(range(16))
    assert multihost.is_primary_host()
    monkeypatch.setattr(multihost, "process_count", lambda: 3)
    monkeypatch.setattr(multihost, "process_index", lambda: 1)
    assert multihost.local_worker_range(12) == range(4, 8)
    with pytest.raises(AssertionError) as info:
        multihost.local_worker_range(16)
    assert str(info.value) == (
        "n_workers=16 must be divisible by the number of hosts (3); "
        "otherwise the trailing 1 workers would never be fed and the "
        "assembled global array would be smaller than n_workers.")


def test_initialize_multihost_needs_a_coordinator(monkeypatch):
    for key in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        multihost.initialize_multihost(backend="gloo")
    with pytest.raises(ValueError, match="together"):
        multihost.initialize_multihost("localhost:1", num_processes=2)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_initialize_multihost():
    """Counterpart of tests/test_multihost.py: two processes meet at a tcp
    coordinator, each feeds its own worker block, and both see the same
    global sum and mean of squares; only process 0 is primary."""
    n_workers = 8
    out = spawn(probe.check_global_moments, 2,
                (2, f"localhost:{_free_port()}", n_workers), device="cpu",
                join_group=False, timeout=120, collective_timeout=60)
    assert [o["process"] for o in out] == [0, 1]
    assert [o["primary"] for o in out] == [True, False]
    assert out[0]["rows"] == [0, 1, 2, 3] and out[1]["rows"] == [4, 5, 6, 7]
    expect = np.repeat(np.arange(n_workers, dtype=np.float32)[:, None], 4, 1)
    for o in out:
        assert o["shape"] == (n_workers, 4)
        assert o["total"] == float(expect.sum())
        assert o["mean_sq"] == pytest.approx(float((expect ** 2).mean()),
                                             rel=1e-7)
    assert out[0]["mean_sq"] == out[1]["mean_sq"]


# --- the data-parallel loss, in one process ---------------------------------

W, T = 6, 8


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A tiny MiniGrid trainer (CNN, TrXL, relative PE) and a batch whose
    snapshot holds memory carried in from an earlier rollout."""
    tmp = tmp_path_factory.mktemp("parallel")
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


def _loss_grads(upd, path, batch, idx, global_adv=None):
    """The loss, stats and gradients of the samples ``idx`` of ``batch`` on
    loss ``path``; ``global_adv`` the global minibatch's advantages (a
    rank's part) or None (the whole minibatch)."""
    prep = (upd.prepare_timeline if path == "timeline"
            else upd.prepare_gathered)
    memory, slots, fields = prep(batch)
    loss_fn = dict(timeline=upd.loss_timeline, gathered=upd.loss_gathered,
                   window=upd.loss_window)[path]
    mb = upd.minibatch(fields, idx, global_adv)
    upd.model.zero_grad(set_to_none=True)
    loss, stats = loss_fn(mb, memory, slots, 0.1, 0.001)
    loss.backward()
    return loss.detach(), stats, [p.grad.clone()
                                  for p in upd.model.parameters()]


# A global minibatch of 13 samples (13 % N != 0) of all workers, or of
# all but the last rank's workers, which leaves that rank without a sample.
CASES = {"all ranks": lambda g, n: torch.randperm(W * T, generator=g)[:13],
         "a rank without": lambda g, n: torch.randperm(
             (W - W // n) * T, generator=g)[:13]}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("path", ["timeline", "grouped", "gathered",
                                  "window"])
def test_rank_losses_sum_to_the_global_minibatch(trained, path, n, case):
    """On the plain versions of the per-sample and grouped kernel pairs
    (the CPU's), the gathered-window loss and the raw-window loss."""
    trainer, batch = trained
    config = dataclasses.replace(trainer.config,
                                 grouped_attention=path == "grouped")
    upd = PPOUpdate(config, trainer.model, trainer.max_episode_steps, None)
    loss_path = "timeline" if path == "grouped" else path
    idx = CASES[case](torch.Generator().manual_seed(n), n)
    loss, stats, grads = _loss_grads(upd, loss_path, batch, idx)

    adv = batch.advantages.reshape(-1)[idx]
    total_loss, total_stats = 0.0, torch.zeros(len(STAT_NAMES))
    total_grads = [torch.zeros_like(g) for g in grads]
    sizes = []
    for r in range(n):
        mesh = DataMesh(r, n, "cpu", "gloo")
        local = PPOUpdate(config, trainer.model, trainer.max_episode_steps,
                          None, mesh=mesh)
        (mine,) = rank_minibatches(local, idx[None])
        sizes.append(len(mine))
        if len(mine) == 0:
            continue
        rows = mesh.worker_rows(W)
        # in permutation order, as rank-local indices
        expect = idx[(idx >= rows.start * T) & (idx < rows.stop * T)]
        assert torch.equal(mine, expect - rows.start * T)
        l_r, s_r, g_r = _loss_grads(local, loss_path,
                                    _rank_batch(batch, rows), mine, adv)
        total_loss += l_r
        total_stats += s_r
        total_grads = [a + b for a, b in zip(total_grads, g_r)]
    assert sum(sizes) == len(idx)
    assert (0 in sizes) == (case == "a rank without")
    np.testing.assert_allclose(float(total_loss), float(loss),
                               rtol=GRAD_RTOL)
    np.testing.assert_allclose(total_stats.numpy(), stats.numpy(),
                               rtol=GRAD_RTOL, atol=1e-7)
    for (name, _), a, b in zip(trainer.model.named_parameters(),
                               total_grads, grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=GRAD_RTOL,
                                   atol=GRAD_RTOL * float(b.abs().max()),
                                   err_msg=name)


@pytest.mark.parametrize("wrong", ["local statistics", "no all-reduce"])
@pytest.mark.parametrize("path", ["timeline", "gathered"])
def test_a_wrong_rank_loss_misses_the_global_minibatch(trained, path, wrong):
    """The sum above has teeth: the ranks' parts with each rank's own
    advantage statistics and count (a per-shard approximation, averaged
    over the ranks), or rank 0's part alone (no all-reduce), miss the whole
    minibatch's gradients by far more than GRAD_RTOL of the largest."""
    trainer, batch = trained
    upd = PPOUpdate(trainer.config, trainer.model, trainer.max_episode_steps,
                    None)
    idx = CASES["all ranks"](torch.Generator().manual_seed(2), 2)
    _, _, grads = _loss_grads(upd, path, batch, idx)
    adv = batch.advantages.reshape(-1)[idx]
    total = [torch.zeros_like(g) for g in grads]
    for r in range(2 if wrong == "local statistics" else 1):
        mesh = DataMesh(r, 2, "cpu", "gloo")
        local = PPOUpdate(trainer.config, trainer.model,
                          trainer.max_episode_steps, None, mesh=mesh)
        (mine,) = rank_minibatches(local, idx[None])
        rows = mesh.worker_rows(W)
        part = _rank_batch(batch, rows)
        if wrong == "local statistics":
            _, _, g_r = _loss_grads(local, path, part, mine)
            g_r = [g / 2 for g in g_r]
        else:
            _, _, g_r = _loss_grads(local, path, part, mine, adv)
        total = [a + b for a, b in zip(total, g_r)]
    err = max(float((a - b).abs().max()) for a, b in zip(total, grads))
    largest = max(float(g.abs().max()) for g in grads)
    assert err > 100 * GRAD_RTOL * largest, (err, largest)


def test_all_reduce_flat_in_one_rank(one_rank_group):
    """Tensors that live in ``flat_views``' views are summed by one
    all-reduce of the buffer, which keeps its address."""
    mesh = make_mesh(1, "cpu")
    a, b = torch.randn(3, 2), torch.randn(4)
    flat, (va, vb) = flat_views([a, b], extra=2)
    assert flat.shape == (12,) and not flat.any()
    va.copy_(a)
    vb.copy_(b)
    address = flat.data_ptr()
    mesh.all_reduce_(flat, "sum")
    assert torch.equal(va, a) and torch.equal(vb, b)
    assert va.shape == (3, 2) and flat.data_ptr() == address
    assert mesh.traffic["sum"]["calls"] == 1
