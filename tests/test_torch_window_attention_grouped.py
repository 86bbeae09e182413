"""The grouped window-attention pair of etmppo_tpu_torch vs the JAX package's
grouped Pallas kernels ``_pallas_forward_grouped`` and
``_pallas_backward_grouped`` (interpret mode on the CPU, as
tests/test_pallas_attention.py runs them).

* ``window_attention_grouped_plain`` (the minibatch sorted by worker, the
  output scattered back) must give the grouped forward's output, and
  ``window_attention_grouped_bwd_plain`` (the timeline and PE gradients
  accumulated in the sorted order) its five gradients. Both sides compute in
  float32 from the same numpy inputs and differ only in summation order:
  1e-5 for the forward, 1e-4 relative / 1e-5 absolute for the gradients, the
  tolerances of the JAX package's own grouped tests.
* The cases: the JAX tests' shapes; a memory length (13) that is not a
  multiple of 8; all-masked rows; n_valid in {1, L}; a worker with no
  samples; a minibatch that is all one worker; w_idx in descending order.
* The autograd op takes the grouped plain versions for CPU tensors when the
  grouped kernels are passed, and never builds or launches them; the CUDA
  wrappers refuse CPU tensors.
* One PPO update with ``grouped_attention`` (and ``pallas_backward``)
  on a tiny Mortar Mayhem Grid model against the JAX package's update with
  ``GROUPED_MODE = True`` and ``BACKWARD_MODE = "pallas"`` (monkeypatched and
  restored): the loss, the stats and every clipped gradient agree to 1e-4
  relative.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from etmppo_tpu.config import load_config as jax_load_config
from etmppo_tpu.envs.factory import create_env as jax_create_env
from etmppo_tpu.models.actor_critic import ActorCriticModel as JModel
from etmppo_tpu.ops import memory_index as jmi
from etmppo_tpu.ops import pallas_window_attention as pwa
from etmppo_tpu.training import ppo as jppo
from etmppo_tpu.training.rollout import RolloutFn as JRolloutFn
from etmppo_tpu_torch.config import config_from_dict
from etmppo_tpu_torch.interop import flax_to_state_dict, load_flax_params
from etmppo_tpu_torch.models.actor_critic import ActorCriticModel
from etmppo_tpu_torch.ops.window_attention import (
    WindowAttentionBackwardGrouped, WindowAttentionForwardGrouped,
    _sorted_by_worker, window_attention,
    window_attention_bwd_grouped, window_attention_bwd_plain,
    window_attention_fwd_grouped, window_attention_grouped_bwd_plain,
    window_attention_grouped_plain)
from etmppo_tpu_torch.training.ppo import PPOUpdate
from etmppo_tpu_torch.training.rollout import RolloutBatch

torch.set_num_threads(1)

FWD_TOL = 1e-5
RTOL, ATOL = 1e-4, 1e-5
NAMES = ("dq", "dtk", "dtv", "dpk", "dpv")


def _case(B=16, W=4, S=40, P=12, L=8, D=32, H=4, seed=0):
    """The inputs of tests/test_pallas_attention.py::_case (row 0 of the mask
    all False), and an output gradient."""
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.normal(size=shape).astype(np.float32)
    args = [f(B, D), f(W, S, D), f(W, S, D), f(P, D), f(P, D),
            rng.integers(0, W, B).astype(np.int32),
            rng.integers(0, S - L, B).astype(np.int32),
            rng.integers(1, L + 1, B).astype(np.int32),
            rng.integers(0, P - L + 1, B).astype(np.int32),
            rng.random((B, L)) < 0.7]
    args[9][0] = False
    return args, f(B, D), H


def _edge(kind):
    args, g, H = _case(B=24, W=4, S=40, P=12, L=8, D=32, seed=23)
    B, L = args[9].shape
    if kind == "all_masked":
        args[9][::3] = False
    elif kind == "n_valid_1_and_L":
        args[7][0::2] = 1
        args[7][1::2] = L
    elif kind == "worker_without_samples":
        args[5][args[5] == 2] = 1
    elif kind == "one_worker":
        args[5][:] = 3
    elif kind == "descending_workers":
        args[5] = np.sort(args[5])[::-1].copy()
    return args, g, H


CASES = {
    # the shapes of the JAX package's grouped tests
    "fwd_shape": lambda: _case(B=32, W=4, S=40, P=12, L=8, D=32, seed=11),
    "bwd_shape": lambda: _case(B=24, W=3, S=30, P=12, L=8, D=32, seed=13),
    "end_to_end_shape": lambda: _case(B=16, W=3, S=30, P=12, L=8, D=32,
                                      seed=17),
    "memory_13_head_12": lambda: _case(B=16, W=3, S=60, P=30, L=13, D=48,
                                       seed=19),
    "all_masked": lambda: _edge("all_masked"),
    "n_valid_1_and_L": lambda: _edge("n_valid_1_and_L"),
    "worker_without_samples": lambda: _edge("worker_without_samples"),
    "one_worker": lambda: _edge("one_worker"),
    "descending_workers": lambda: _edge("descending_workers"),
}


@functools.partial(jax.jit, static_argnums=(10,))
def _pallas_fwd(q, tk, tv, pk, pv, w_idx, start, n_valid, s_lo, mask, H):
    return pwa._pallas_forward_grouped(q, tk, tv, pk, pv, w_idx, start,
                                       n_valid, s_lo, mask, H)


@functools.partial(jax.jit, static_argnums=(11,))
def _pallas_bwd(q, tk, tv, pk, pv, w_idx, start, n_valid, s_lo, mask, g, H):
    return pwa._pallas_backward_grouped(q, tk, tv, pk, pv, w_idx, start,
                                        n_valid, s_lo, mask, g, H)


@functools.lru_cache(maxsize=None)
def _pallas_out(name):
    args, _, H = CASES[name]()
    return np.asarray(_pallas_fwd(*map(jnp.asarray, args), H))


@functools.lru_cache(maxsize=None)
def _pallas_grads(name):
    args, g, H = CASES[name]()
    out = _pallas_bwd(*map(jnp.asarray, args), jnp.asarray(g), H)
    return [np.asarray(x) for x in out]


def _torch(name):
    args, g, H = CASES[name]()
    return [torch.as_tensor(a) for a in args], torch.as_tensor(g), H


def _check_grads(grads, name):
    for label, got, want in zip(NAMES, grads, _pallas_grads(name)):
        assert got.shape == want.shape, label
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                   err_msg=label)


def test_cases_cover_the_edges():
    w = {name: CASES[name]()[0][5] for name in CASES}
    assert 2 not in w["worker_without_samples"]
    assert len(set(w["one_worker"])) == 1
    assert (np.diff(w["descending_workers"]) <= 0).all()
    assert (np.diff(w["descending_workers"]) < 0).any()
    assert CASES["memory_13_head_12"]()[0][9].shape[1] % 8 != 0


@pytest.mark.parametrize("name", list(CASES))
def test_grouped_plain_forward_matches_pallas_forward_grouped(name):
    t, _, H = _torch(name)
    out = window_attention_grouped_plain(*t, H)
    np.testing.assert_allclose(out.numpy(), _pallas_out(name), rtol=FWD_TOL,
                               atol=FWD_TOL)


@pytest.mark.parametrize("name", list(CASES))
def test_grouped_plain_backward_matches_pallas_backward_grouped(name):
    t, g, H = _torch(name)
    grads = window_attention_grouped_bwd_plain(*t, g, H)
    _check_grads([x.numpy() for x in grads], name)


@pytest.mark.parametrize("name", ["bwd_shape", "memory_13_head_12",
                                  "one_worker"])
def test_grouped_plain_backward_is_repeatable_and_is_the_vjp(name):
    """Two calls give the same bits; the plain VJP (autograd's accumulation
    order) agrees to the tolerances above."""
    t, g, H = _torch(name)
    first = window_attention_grouped_bwd_plain(*t, g, H)
    second = window_attention_grouped_bwd_plain(*t, g, H)
    vjp = window_attention_bwd_plain(*t, g, H)
    for label, a, b, c in zip(NAMES, first, second, vjp):
        assert torch.equal(a, b), label
        np.testing.assert_allclose(a.numpy(), c.numpy(), rtol=RTOL,
                                   atol=ATOL, err_msg=label)


def test_sorted_by_worker_is_stable():
    w = torch.tensor([2, 0, 1, 0, 2, 1, 0], dtype=torch.int32)
    order, (w_s,) = _sorted_by_worker(w, w)
    assert order.tolist() == [1, 3, 6, 2, 5, 0, 4]
    assert w_s.tolist() == [0, 0, 0, 1, 1, 2, 2]


@pytest.mark.parametrize("name", ["end_to_end_shape", "memory_13_head_12"])
def test_autograd_op_on_cpu_takes_the_grouped_plain_versions(name):
    """The op with the grouped kernels gives the grouped Pallas forward and
    backward for CPU tensors, and never reaches either kernel."""
    args, g, H = CASES[name]()
    fwd, bwd = WindowAttentionForwardGrouped(), WindowAttentionBackwardGrouped()
    diff = [torch.tensor(a, requires_grad=True) for a in args[:5]]
    rest = [torch.as_tensor(a) for a in args[5:]]
    out = window_attention(*diff, *rest, H, kernel=fwd, backward_kernel=bwd)
    np.testing.assert_allclose(out.detach().numpy(), _pallas_out(name),
                               rtol=FWD_TOL, atol=FWD_TOL)
    out.backward(torch.as_tensor(g))
    _check_grads([x.grad.numpy() for x in diff], name)
    for k in (fwd, bwd):
        assert k.launches == 0 and k._lib is None


def test_grouped_backward_plain_returns_only_the_needed_gradients():
    t, g, H = _torch("bwd_shape")
    grads = window_attention_grouped_bwd_plain(
        *t, g, H, needs_grad=(False, True, False, False, True))
    assert [x is None for x in grads] == [True, False, True, True, False]
    want = _pallas_grads("bwd_shape")
    for i in (1, 4):
        np.testing.assert_allclose(grads[i].numpy(), want[i], rtol=RTOL,
                                   atol=ATOL, err_msg=NAMES[i])


@pytest.mark.parametrize("cls", [WindowAttentionForwardGrouped,
                                 WindowAttentionBackwardGrouped])
def test_grouped_wrappers_reject_cpu_tensors(cls):
    """The CUDA wrappers raise on anything but CUDA inputs rather than fall
    back to their plain versions."""
    kernel = cls()
    t, g, H = _torch("fwd_shape")
    extra = (g,) if cls is WindowAttentionBackwardGrouped else ()
    with pytest.raises(ValueError, match="CUDA"):
        kernel(*t, *extra, H)
    assert kernel.launches == 0 and kernel._lib is None
    assert cls.plain in (window_attention_grouped_plain,
                         window_attention_grouped_bwd_plain)


# --- one PPO update with the grouped pair --------------------------------

LR, CLIP, BETA = 3e-4, 0.1, 0.001


def _jax_config():
    cfg = jax_load_config("etmppo_tpu/configs/mortar_mayhem_grid.yaml")
    assert cfg.pallas_backward and cfg.use_pallas_attention
    trx = dataclasses.replace(cfg.transformer, num_blocks=2, embed_dim=32,
                              num_heads=4, memory_length=10)
    return dataclasses.replace(cfg, n_workers=3, worker_steps=16,
                               n_mini_batch=1, epochs=1, hidden_layer_size=32,
                               transformer=trx)


def _torch_batch(batch) -> RolloutBatch:
    t = lambda x: torch.tensor(np.asarray(x))
    return RolloutBatch(
        obs=t(batch.obs), actions=t(batch.actions).long(),
        log_probs=t(batch.log_probs), values=t(batch.values),
        advantages=t(batch.advantages),
        episode_steps=t(batch.episode_steps).long(), dones=t(batch.dones),
        tape=t(batch.tape), snapshot=t(batch.snapshot),
        episode_infos={k: t(v) for k, v in batch.episode_infos.items()})


def _jax_minibatch(jcfg, update_fn, batch, idx):
    """The minibatch, timeline and slots PPOUpdateFn._update builds."""
    L = jcfg.transformer.memory_length
    T, B = jcfg.worker_steps, jcfg.batch_size
    timeline = jmi.build_timeline(batch.snapshot, batch.tape,
                                  batch.episode_steps[:, 0], pad=L)
    slots = jmi.build_timeline_slots(batch.episode_steps, update_fn.max_ep,
                                     pad=L)
    tl = jmi.compute_timeline_sources(batch.episode_steps, batch.dones,
                                      update_fn.index_table, L)
    flat = lambda x: x.reshape((B,) + x.shape[2:])[idx]
    mb = dict(obs=flat(batch.obs), actions=flat(batch.actions),
              log_probs=flat(batch.log_probs), values=flat(batch.values),
              advantages=flat(batch.advantages), w_idx=idx // T,
              memory_mask=update_fn.mask_table[
                  jnp.clip(flat(batch.episode_steps), 0, L - 1)],
              tl_start=flat(tl.start), tl_n_valid=flat(tl.n_valid),
              tl_s_lo=flat(tl.s_lo))
    return mb, timeline, slots


@pytest.fixture(scope="module")
def grouped_step():
    jcfg = _jax_config()
    env = jax_create_env(jcfg.environment)
    jmodel = JModel(config=jcfg, obs_shape=env.observation_shape,
                    action_branches=env.action_branches,
                    max_episode_steps=env.max_episode_steps)
    params = jmodel.init_params(jax.random.PRNGKey(0))
    rollout_fn = JRolloutFn(jcfg, env, jmodel)
    state = rollout_fn.init_state(jax.random.PRNGKey(1))
    for _ in range(2):      # the second batch carries memory in
        state, batch = rollout_fn(params, state)
    jupdate = jppo.PPOUpdateFn(jcfg, jmodel, env.max_episode_steps)
    perm = np.asarray(jax.random.permutation(jax.random.PRNGKey(3),
                                             jcfg.batch_size))
    mb, timeline, slots = _jax_minibatch(jcfg, jupdate, batch,
                                         jnp.asarray(perm))

    calls = {"fwd": 0, "bwd": 0}
    mp = pytest.MonkeyPatch()
    mp.setattr(pwa, "GROUPED_MODE", True)
    mp.setattr(pwa, "BACKWARD_MODE", "pallas")
    for key, name in (("fwd", "_pallas_forward_grouped"),
                      ("bwd", "_pallas_backward_grouped")):
        real = getattr(pwa, name)

        def counted(*a, _real=real, _key=key, **k):
            calls[_key] += 1
            return _real(*a, **k)
        mp.setattr(pwa, name, counted)
    try:
        (j_loss, j_stats), j_grads = jax.value_and_grad(
            jupdate._loss_pallas, has_aux=True)(params, mb, timeline, slots,
                                                CLIP, BETA)
    finally:
        mp.undo()
    assert not pwa.GROUPED_MODE and pwa.BACKWARD_MODE == "xla"
    assert calls["fwd"] >= jcfg.transformer.num_blocks and calls["bwd"]
    j_grads, _ = jppo.clip_grads_torch(j_grads, jcfg.max_grad_norm)

    tcfg = dataclasses.replace(config_from_dict(dataclasses.asdict(jcfg)),
                               grouped_attention=True)
    model = ActorCriticModel(tcfg, env.observation_shape, env.action_branches,
                             env.max_episode_steps, device="cpu")
    load_flax_params(model, params)
    update = PPOUpdate(tcfg, model, env.max_episode_steps, generator=None)
    assert update.kernel is window_attention_fwd_grouped
    assert update.backward_kernel is window_attention_bwd_grouped
    launches = (window_attention_fwd_grouped.launches,
                window_attention_bwd_grouped.launches)
    t_stats, _ = update(_torch_batch(batch), LR, CLIP, BETA,
                        perms=torch.tensor(perm)[None])
    assert (window_attention_fwd_grouped.launches,
            window_attention_bwd_grouped.launches) == launches
    return dict(j_loss=float(j_loss), j_stats=np.asarray(j_stats),
                j_grads=j_grads, t_stats=t_stats, model=model)


def test_grouped_update_loss_and_stats_match(grouped_step):
    loss = float(grouped_step["t_stats"][2])      # STAT_NAMES[2] == "loss"
    np.testing.assert_allclose(loss, grouped_step["j_loss"], rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(grouped_step["t_stats"].numpy(),
                               grouped_step["j_stats"], rtol=1e-4, atol=1e-6)


def test_grouped_update_clipped_gradients_match(grouped_step):
    j_grads = flax_to_state_dict(grouped_step["j_grads"])
    for name, p in grouped_step["model"].named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), j_grads[name].numpy(),
                                   rtol=1e-4, atol=1e-7, err_msg=name)


def test_grouped_without_pallas_backward_takes_the_plain_vjp():
    """GROUPED_MODE with BACKWARD_MODE = "xla": the grouped forward and the
    plain VJP."""
    tcfg = dataclasses.replace(config_from_dict(dataclasses.asdict(
        _jax_config())), pallas_backward=False, grouped_attention=True)
    model = ActorCriticModel(tcfg, (84, 84, 3), (5,), 120, device="cpu")
    update = PPOUpdate(tcfg, model, 120, generator=None)
    assert update.kernel is window_attention_fwd_grouped
    assert update.backward_kernel is None
