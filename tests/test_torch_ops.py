"""etmppo_tpu_torch ops (memory_index, gae, distributions) vs the JAX package
on the same numpy-seeded inputs.

Index tables and window sources are integers and must match exactly; float
results are float32 on both sides and agree to 1e-5 / 1e-6.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from etmppo_tpu.ops import distributions as jd
from etmppo_tpu.ops import gae as jgae
from etmppo_tpu.ops import memory_index as jmi
from etmppo_tpu_torch.ops import distributions as td
from etmppo_tpu_torch.ops import gae as tgae
from etmppo_tpu_torch.ops import memory_index as tmi

torch.set_num_threads(1)


def _episodes(W, T, max_ep, seed, p_done=0.08):
    """Random (episode_steps, dones) that follow the rollout's bookkeeping:
    episodes end on done or at max_ep, workers start mid-episode."""
    rng = np.random.default_rng(seed)
    steps = np.zeros((W, T), np.int32)
    dones = np.zeros((W, T), bool)
    for w in range(W):
        e = int(rng.integers(0, max_ep // 2))
        for t in range(T):
            steps[w, t] = e
            if rng.random() < p_done or e + 1 >= max_ep:
                dones[w, t] = True
                e = 0
            else:
                e += 1
    return steps, dones


@pytest.mark.parametrize("max_ep,L", [(32, 8), (96, 64), (16, 16)])
def test_tables_match(max_ep, L):
    np.testing.assert_array_equal(tmi.build_memory_mask(L),
                                  jmi.build_memory_mask(L))
    np.testing.assert_array_equal(tmi.build_memory_indices(max_ep, L),
                                  jmi.build_memory_indices(max_ep, L))


def test_indices_reject_short_episodes():
    with pytest.raises(ValueError):
        tmi.build_memory_indices(4, 8)


@pytest.mark.parametrize("seed,W,T,max_ep,L", [
    (0, 4, 64, 32, 8), (1, 3, 200, 96, 64), (2, 2, 40, 16, 16)])
def test_timeline_sources_match(seed, W, T, max_ep, L):
    steps, dones = _episodes(W, T, max_ep, seed)
    table = jmi.build_memory_indices(max_ep, L)
    j = jmi.compute_timeline_sources(jnp.asarray(steps), jnp.asarray(dones),
                                     jnp.asarray(table), L)
    t = tmi.compute_timeline_sources(torch.as_tensor(steps),
                                     torch.as_tensor(dones),
                                     torch.as_tensor(table), L)
    for name in ("start", "n_valid", "s_lo"):
        got = getattr(t, name)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(getattr(j, name)),
                                      err_msg=name)


@pytest.mark.parametrize("seed,W,T,max_ep,L", [
    (0, 4, 64, 32, 8), (3, 3, 120, 96, 64)])
def test_timeline_and_slots_match(seed, W, T, max_ep, L):
    steps, dones = _episodes(W, T, max_ep, seed)
    rng = np.random.default_rng(seed)
    snapshot = rng.normal(size=(W, max_ep, 2, 5)).astype(np.float32)
    tape = rng.normal(size=(W, T, 2, 5)).astype(np.float32)
    j = jmi.build_timeline(jnp.asarray(snapshot), jnp.asarray(tape),
                           jnp.asarray(steps[:, 0]), pad=L)
    t = tmi.build_timeline(torch.as_tensor(snapshot), torch.as_tensor(tape),
                           torch.as_tensor(steps[:, 0]), pad=L)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    js = jmi.build_timeline_slots(jnp.asarray(steps), max_ep, pad=L)
    ts = tmi.build_timeline_slots(torch.as_tensor(steps), max_ep, pad=L)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_timeline_windows_address_the_reference_window():
    """Window rows from the timeline sources equal the slots the reference's
    window gather reads (compute_window_sources): every valid slot of sample
    (w, t) is timeline row start + j, holding the same memory item."""
    W, T, max_ep, L = 3, 80, 32, 8
    steps, dones = _episodes(W, T, max_ep, 5)
    table = jmi.build_memory_indices(max_ep, L)
    rng = np.random.default_rng(5)
    snapshot = rng.normal(size=(W, max_ep, 1, 3)).astype(np.float32)
    tape = rng.normal(size=(W, T, 1, 3)).astype(np.float32)
    ws = jmi.compute_window_sources(jnp.asarray(steps), jnp.asarray(dones),
                                    jnp.asarray(table), max_ep)
    src = np.concatenate([snapshot, tape, np.zeros_like(snapshot)], axis=1)
    tl = tmi.compute_timeline_sources(torch.as_tensor(steps),
                                      torch.as_tensor(dones),
                                      torch.as_tensor(table), L)
    timeline = tmi.build_timeline(torch.as_tensor(snapshot),
                                  torch.as_tensor(tape),
                                  torch.as_tensor(steps[:, 0]), pad=L).numpy()
    flat_index = np.asarray(ws.flat_index)
    valid = np.asarray(ws.valid)
    for w in range(W):
        for t in range(T):
            n = int(tl.n_valid[w, t])
            st = int(tl.start[w, t])
            assert valid[w, t, :n].all() and not valid[w, t, n:].any()
            np.testing.assert_array_equal(
                timeline[w, st:st + n], src[w, flat_index[w, t, :n]])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gae_matches(seed):
    rng = np.random.default_rng(seed)
    W, T = 4, 50
    rewards = rng.normal(size=(W, T)).astype(np.float32)
    values = rng.normal(size=(W, T)).astype(np.float32)
    dones = rng.random((W, T)) < 0.1
    last = rng.normal(size=(W,)).astype(np.float32)
    j = jgae.calc_advantages(jnp.asarray(rewards), jnp.asarray(values),
                             jnp.asarray(dones), jnp.asarray(last), 0.99, 0.95)
    t = tgae.calc_advantages(torch.as_tensor(rewards), torch.as_tensor(values),
                             torch.as_tensor(dones), torch.as_tensor(last),
                             0.99, 0.95)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arities", [(3,), (4, 2, 5)])
def test_distributions_match(arities):
    rng = np.random.default_rng(len(arities))
    B = 64
    logits = [rng.normal(size=(B, a)).astype(np.float32) * 3 for a in arities]
    actions = np.stack([rng.integers(0, a, B) for a in arities],
                       axis=-1).astype(np.int32)
    jlp, jent = jd.log_probs_and_entropies([jnp.asarray(l) for l in logits],
                                           jnp.asarray(actions))
    tlp, tent = td.log_probs_and_entropies([torch.as_tensor(l) for l in logits],
                                           torch.as_tensor(actions))
    np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(tent.numpy(), np.asarray(jent), rtol=1e-5,
                               atol=1e-6)
    for i, l in enumerate(logits):
        np.testing.assert_allclose(
            td.entropy(torch.as_tensor(l)).numpy(),
            np.asarray(jd.entropy(jnp.asarray(l))), rtol=1e-5, atol=1e-6)


def test_sampling_follows_the_distribution():
    """JAX and torch draw different bits by design; the sampler must match
    the categorical distribution and report the log-probs of its draws."""
    logits = torch.tensor([[0.0, 1.0, -1.0, 2.0]]).expand(40000, -1)
    gen = torch.Generator().manual_seed(0)
    actions, log_probs = td.sample_multi([logits], gen)
    assert actions.shape == (40000, 1) and actions.dtype == torch.int32
    freq = torch.bincount(actions[:, 0].long(), minlength=4).float() / 40000
    expected = torch.softmax(logits[0], -1)
    # 4 sigma of a binomial proportion at n=40000 is < 0.01
    np.testing.assert_allclose(freq.numpy(), expected.numpy(), atol=0.01)
    np.testing.assert_allclose(
        log_probs[:, 0].numpy(),
        torch.log_softmax(logits, -1).gather(
            1, actions.long()).squeeze(1).numpy(), rtol=1e-6)


@pytest.mark.parametrize("args", [(3e-4, 1e-4, 250, 1.0, 0),
                                  (3e-4, 1e-4, 250, 1.0, 100),
                                  (3e-4, 1e-4, 250, 2.0, 251),
                                  (0.2, 0.2, 10, 1.0, 5)])
def test_polynomial_decay_matches(args):
    from etmppo_tpu.utils.schedules import polynomial_decay as jdecay
    from etmppo_tpu_torch.utils.schedules import polynomial_decay
    assert polynomial_decay(*args) == jdecay(*args)
