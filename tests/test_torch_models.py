"""etmppo_tpu_torch.models vs the JAX package's Flax model, with the same
parameters converted through etmppo_tpu_torch.interop.

Both sides run float32 with full-precision matmuls and convolutions; the
outputs pass through up to three conv layers and three transformer blocks,
so they agree to 1e-4 (relative and absolute).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from etmppo_tpu.config import TrainConfig as JTrainConfig
from etmppo_tpu.config import TransformerConfig as JTransformerConfig
from etmppo_tpu.models.actor_critic import ActorCriticModel as JModel
from etmppo_tpu.ops.pallas_window_attention import fused_window_attention
from etmppo_tpu_torch.config import TrainConfig, TransformerConfig
from etmppo_tpu_torch.interop import flax_to_state_dict, load_flax_params
from etmppo_tpu_torch.models.actor_critic import ActorCriticModel
from etmppo_tpu_torch.models.transformer import sinusoidal_position_table
from etmppo_tpu_torch.ops.window_attention import window_attention

torch.set_num_threads(1)
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

TOL = dict(rtol=1e-4, atol=1e-4)
MAX_EP = 32
IMAGE = (84, 84, 3)

VARIANTS = {
    # the flagship's architecture (CNN, post-LN, relative PE) at small width
    "flagship": dict(obs=IMAGE, ln="post", pe="relative", gtrxl=False,
                     D=32, H=4, blocks=2, L=8, branches=(3,)),
    "pre_gtrxl_learned": dict(obs=(7,), ln="pre", pe="learned", gtrxl=True,
                              D=16, H=2, blocks=2, L=8, branches=(3, 2)),
    "no_ln_no_pe": dict(obs=(5,), ln="", pe="", gtrxl=False,
                        D=16, H=1, blocks=3, L=6, branches=(4,)),
}


def _models(v, seed=0):
    trx = dict(num_blocks=v["blocks"], embed_dim=v["D"], num_heads=v["H"],
               memory_length=v["L"], positional_encoding=v["pe"],
               layer_norm=v["ln"], gtrxl=v["gtrxl"], gtrxl_bias=0.5)
    jcfg = JTrainConfig(hidden_layer_size=24,
                        transformer=JTransformerConfig(**trx))
    jmodel = JModel(config=jcfg, obs_shape=v["obs"],
                    action_branches=v["branches"], max_episode_steps=MAX_EP)
    params = jmodel.init_params(jax.random.PRNGKey(seed))
    tcfg = TrainConfig(hidden_layer_size=24, transformer=TransformerConfig(**trx))
    tmodel = ActorCriticModel(tcfg, v["obs"], v["branches"], MAX_EP,
                              device="cpu")
    load_flax_params(tmodel, params)
    return jmodel, params, tmodel


def _inputs(v, B=6, seed=1):
    rng = np.random.default_rng(seed)
    obs = rng.random((B,) + v["obs"]).astype(np.float32)
    memory = rng.normal(size=(B, v["L"], v["blocks"], v["D"])).astype(np.float32)
    mask = rng.random((B, v["L"])) < 0.6
    mask[0] = False
    indices = rng.integers(0, MAX_EP, (B, v["L"])).astype(np.int32)
    return obs, memory, mask, indices


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _compare(t_out, ref_out):
    """(logits, value, new_memory) of the port against a reference's."""
    t_logits, t_value, t_mem = t_out
    r_logits, r_value, r_mem = ref_out
    assert len(t_logits) == len(r_logits)
    for tl, rl in zip(t_logits, r_logits):
        np.testing.assert_allclose(_np(tl), _np(rl), **TOL)
    np.testing.assert_allclose(_np(t_value), _np(r_value), **TOL)
    np.testing.assert_allclose(_np(t_mem), _np(r_mem), **TOL)


@pytest.mark.parametrize("name", list(VARIANTS))
def test_state_dict_covers_every_parameter(name):
    jmodel, params, tmodel = _models(VARIANTS[name])
    converted = flax_to_state_dict(params)
    assert set(converted) == set(tmodel.state_dict())
    for k, v in tmodel.state_dict().items():
        assert converted[k].shape == v.shape, k


@pytest.mark.parametrize("name", list(VARIANTS))
def test_forward_matches(name):
    v = VARIANTS[name]
    jmodel, params, tmodel = _models(v)
    obs, memory, mask, indices = _inputs(v)
    j_out = jmodel.apply(params, *map(jnp.asarray, (obs, memory, mask, indices)))
    t_out = tmodel(*map(torch.as_tensor, (obs, memory, mask, indices)))
    _compare(t_out, j_out)


@pytest.mark.parametrize("name", list(VARIANTS))
def test_forward_with_kv_and_projections_match(name):
    v = VARIANTS[name]
    jmodel, params, tmodel = _models(v)
    obs, memory, mask, indices = _inputs(v)
    j_k, j_v = jmodel.apply(params, jnp.asarray(memory), jnp.asarray(indices),
                            method=JModel.project_memory)
    t_k, t_v = tmodel.project_memory(torch.as_tensor(memory),
                                     torch.as_tensor(indices))
    np.testing.assert_allclose(t_k.detach().numpy(), np.asarray(j_k), **TOL)
    np.testing.assert_allclose(t_v.detach().numpy(), np.asarray(j_v), **TOL)
    j_pk, j_pv = jmodel.apply(params, method=JModel.pe_kv)
    t_pk, t_pv = tmodel.pe_kv()
    np.testing.assert_allclose(t_pk.detach().numpy(), np.asarray(j_pk), **TOL)
    np.testing.assert_allclose(t_pv.detach().numpy(), np.asarray(j_pv), **TOL)
    j_out = jmodel.apply(params, jnp.asarray(obs), j_k, j_v, jnp.asarray(mask),
                         method=JModel.forward_with_kv)
    t_out = tmodel.forward_with_kv(torch.as_tensor(obs), t_k, t_v,
                                   torch.as_tensor(mask))
    _compare(t_out, j_out)
    # the projected-KV path equals the raw-window path (same math)
    _compare(t_out, tmodel(*map(torch.as_tensor,
                                (obs, memory, mask, indices))))


@pytest.mark.parametrize("name", list(VARIANTS))
def test_forward_with_window_attention_ops_matches(name):
    """forward_with_ops with each block's attention read from projected
    timelines: the JAX model through fused_window_attention (Pallas,
    interpret mode), the port through its window-attention op."""
    v = VARIANTS[name]
    jmodel, params, tmodel = _models(v)
    B, W, L, blocks = 6, 2, v["L"], v["blocks"]
    S = MAX_EP + 20 + L
    rng = np.random.default_rng(4)
    obs = rng.random((B,) + v["obs"]).astype(np.float32)
    timeline = rng.normal(size=(W, S, blocks, v["D"])).astype(np.float32)
    slots = rng.integers(0, MAX_EP, (W, S)).astype(np.int32)
    w_idx = rng.integers(0, W, B).astype(np.int32)
    start = rng.integers(0, S - L, B).astype(np.int32)
    n_valid = rng.integers(1, L + 1, B).astype(np.int32)
    s_lo = rng.integers(0, MAX_EP - L + 1, B).astype(np.int32)
    mask = rng.random((B, L)) < 0.6
    mask[0] = False
    idx = (w_idx, start, n_valid, s_lo, mask)

    j_tk, j_tv = jmodel.apply(params, jnp.asarray(timeline), jnp.asarray(slots),
                              method=JModel.project_memory)
    j_pk, j_pv = jmodel.apply(params, method=JModel.pe_kv)
    jidx = [jnp.asarray(a) for a in idx]
    j_ops = [lambda q, i=i: fused_window_attention(
        q, j_tk[:, :, i], j_tv[:, :, i], j_pk[:, i], j_pv[:, i], *jidx,
        v["H"]) for i in range(blocks)]
    j_out = jmodel.apply(params, jnp.asarray(obs), j_ops,
                         method=JModel.forward_with_ops)

    kv = tmodel.project_memory_blocks(torch.as_tensor(timeline),
                                      torch.as_tensor(slots))
    pe = tmodel.pe_kv_blocks()
    tidx = [torch.as_tensor(a) for a in idx]
    t_ops = [lambda q, i=i: window_attention(
        q, *kv[i], *pe[i], *tidx, v["H"]) for i in range(blocks)]
    t_out = tmodel.forward_with_ops(torch.as_tensor(obs), t_ops)
    _compare(t_out, j_out)


def test_memory_items_are_detached():
    v = VARIANTS["flagship"]
    _, _, tmodel = _models(v)
    obs, memory, mask, indices = _inputs(v)
    _, _, new_memory = tmodel(*map(torch.as_tensor,
                                   (obs, memory, mask, indices)))
    assert not new_memory.requires_grad


def test_lin_hidden_sees_hwc_ordered_features():
    """With lin_hidden's weights taken over unchanged, the encoder only
    agrees with JAX if the CNN features are flattened in HWC order."""
    v = VARIANTS["flagship"]
    jmodel, params, tmodel = _models(v)
    obs = np.random.default_rng(2).random((2,) + IMAGE).astype(np.float32)
    j_h = jmodel.apply(params, jnp.asarray(obs), method=JModel.encode)
    t_h = tmodel.encode(torch.as_tensor(obs))
    np.testing.assert_allclose(t_h.detach().numpy(), np.asarray(j_h), **TOL)


def test_sinusoid_table_is_reversed():
    table = sinusoidal_position_table(10, 8)
    assert table.shape == (10, 8)
    np.testing.assert_allclose(table[-1, :4], 0.0)   # slot 9 is position 0
    np.testing.assert_allclose(table[-1, 4:], 1.0)


def test_init_is_a_function_of_the_seed():
    v = VARIANTS["pre_gtrxl_learned"]
    cfg = TrainConfig(hidden_layer_size=24, transformer=TransformerConfig(
        num_blocks=2, embed_dim=16, num_heads=2, memory_length=8,
        positional_encoding="learned", layer_norm="pre", gtrxl=True))
    make = lambda s: ActorCriticModel(cfg, v["obs"], v["branches"], MAX_EP,
                                      device="cpu",
                                      generator=torch.Generator().manual_seed(s))
    a, b, c = make(0).state_dict(), make(0).state_dict(), make(1).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not all(torch.equal(a[k], c[k]) for k in a)
    # orthogonal init: lin_hidden rows are orthogonal with gain sqrt(2)
    w = make(0).lin_hidden.weight.detach().double()
    np.testing.assert_allclose((w.T @ w).numpy() if w.shape[0] > w.shape[1]
                               else (w @ w.T).numpy(),
                               2 * np.eye(min(w.shape)), atol=1e-5)
