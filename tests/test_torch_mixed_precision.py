"""``compute_dtype: bfloat16`` in etmppo_tpu_torch against the JAX package's
bfloat16 (flax ``dtype=bfloat16``), with the same float32 parameters
(through ``interop.py``) and the same inputs.

The two packages round in bfloat16 at the same points, but XLA and PyTorch
need not round every product and sum alike, and one different rounding
moves everything after it by about the width of bfloat16 noise. So each
value is held to the criterion

    max|port_bf16 - jax_bf16| <= 2 * max|jax_bf16 - jax_fp32| + atol,

the port's distance from JAX's bfloat16 at most twice bfloat16's own
distance from float32, where ``atol`` is one bfloat16 ulp (2^-7) of the
float32 value's largest magnitude: a single value rounded the other way.
The float32 path is held to 1e-4 by tests/test_torch_models.py and the
other parity tests, unchanged.

* The pieces: the CNN encoder, the attention, the GRU gate, pre- and
  post-LN blocks, and the whole model's three forwards (raw memory,
  ``forward_with_kv``, ``forward_with_ops`` with the window-attention op
  between float32 casts, as JAX's ``_loss_pallas`` has it).
* One minibatch's loss, stats and clipped gradients: ``loss_gathered``
  against ``_loss_fast`` at POC_MEMORY's full width, ``loss_timeline``
  against ``_loss_pallas`` (its Pallas kernel in interpret mode) on a small
  MiniGrid flagship; the window-attention op must see float32 only.
* A PocMemory rollout handed JAX's actions and reset draws.
* Training: bfloat16 trains with finite stats and float32 parameters on
  the gathered and the kernel loss, and on the host rollout over
  ``PocMemoryEnv-native`` (the counterparts of tests/test_fused.py:55-89);
  a bfloat16 device run resumes bit for bit; a bfloat16 ``.nn`` is served
  by both packages' ``PolicyServer``; a bfloat16 run's ``.nn`` holds
  float32 arrays that the JAX package loads, and the port evaluates and
  watches it in bfloat16.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from etmppo_tpu.config import TrainConfig as JTrainConfig
from etmppo_tpu.config import TransformerConfig as JTransformerConfig
from etmppo_tpu.config import load_config as jax_load_config
from etmppo_tpu.envs.factory import create_env as jax_create_env
from etmppo_tpu.models.actor_critic import ActorCriticModel as JModel
from etmppo_tpu.ops import memory_index as jmi
from etmppo_tpu.ops.pallas_window_attention import fused_window_attention
from etmppo_tpu.serve import PolicyServer as JServer
from etmppo_tpu.training import ppo as jppo
from etmppo_tpu.training.checkpoint import save_model as jax_save_model
from etmppo_tpu.training.rollout import RolloutFn as JRolloutFn
from etmppo_tpu_torch.config import (POC_MEMORY, TrainConfig,
                                     TransformerConfig, config_from_dict)
from etmppo_tpu_torch.envs.poc_memory import (PocMemoryEnv,
                                              PocMemoryResetDraws)
from etmppo_tpu_torch.interop import flax_to_state_dict, load_flax_params
from etmppo_tpu_torch.models.actor_critic import ActorCriticModel
from etmppo_tpu_torch.ops import distributions
from etmppo_tpu_torch.ops.window_attention import window_attention
from etmppo_tpu_torch.serve import PolicyServer
from etmppo_tpu_torch.training import ppo as ppo_lib
from etmppo_tpu_torch.training.ppo import PPOUpdate
from etmppo_tpu_torch.training.rollout import RolloutBatch, RolloutFn
from etmppo_tpu_torch.training.trainer import PPOTrainer
from etmppo_tpu_torch.utils.runtime import compute_dtype

torch.set_num_threads(1)

BF16_ULP = 2.0 ** -7
MAX_EP = 32
LR, CLIP, BETA = 3e-4, 0.2, 0.001
VARIANTS = {
    # the flagship's architecture (CNN, post-LN, relative PE) at small width
    "flagship": dict(obs=(84, 84, 3), ln="post", pe="relative", gtrxl=False,
                     D=32, H=4, blocks=2, L=8, branches=(3,)),
    "pre_gtrxl_learned": dict(obs=(7,), ln="pre", pe="learned", gtrxl=True,
                              D=16, H=2, blocks=2, L=8, branches=(3, 2)),
}


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _distance(a, b) -> float:
    return float(np.abs(_f32(a) - _f32(b)).max()) if np.size(_f32(a)) else 0.0


def assert_bf16_close(port, j16, j32, what: str) -> None:
    """The module docstring's criterion."""
    port, j16, j32 = _f32(port), _f32(j16), _f32(j32)
    assert port.shape == j16.shape == j32.shape, what
    bound = 2 * _distance(j16, j32) + BF16_ULP * float(np.abs(j32).max())
    got = _distance(port, j16)
    assert got <= bound, f"{what}: {got} > {bound}"


def assert_outputs_close(port, j16, j32, what: str) -> None:
    """(logits, value, new_memory) of a forward."""
    for i, (p, a, b) in enumerate(zip(port[0], j16[0], j32[0])):
        assert_bf16_close(p, a, b, f"{what} logits {i}")
    assert_bf16_close(port[1], j16[1], j32[1], f"{what} value")
    assert port[2].dtype == torch.float32
    assert_bf16_close(port[2], j16[2], j32[2], f"{what} new_memory")


def test_compute_dtype_is_checked():
    assert compute_dtype(TrainConfig()) == torch.float32
    assert compute_dtype(TrainConfig(compute_dtype="bfloat16")) == \
        torch.bfloat16
    with pytest.raises(ValueError, match="compute_dtype"):
        compute_dtype(TrainConfig(compute_dtype="float16"))


# --- the model's pieces --------------------------------------------------


def _models(v, seed=0):
    """JAX's float32 and bfloat16 models, their (float32) parameters, and
    the port's bfloat16 model with those parameters."""
    trx = dict(num_blocks=v["blocks"], embed_dim=v["D"], num_heads=v["H"],
               memory_length=v["L"], positional_encoding=v["pe"],
               layer_norm=v["ln"], gtrxl=v["gtrxl"], gtrxl_bias=0.5)
    jmodels = [JModel(config=JTrainConfig(
        hidden_layer_size=24, compute_dtype=dt,
        transformer=JTransformerConfig(**trx)), obs_shape=v["obs"],
        action_branches=v["branches"], max_episode_steps=MAX_EP)
        for dt in ("float32", "bfloat16")]
    params = jmodels[0].init_params(jax.random.PRNGKey(seed))
    tmodel = ActorCriticModel(
        TrainConfig(hidden_layer_size=24, compute_dtype="bfloat16",
                    transformer=TransformerConfig(**trx)),
        v["obs"], v["branches"], MAX_EP, device="cpu")
    load_flax_params(tmodel, params)
    assert {p.dtype for p in tmodel.parameters()} == {torch.float32}
    return jmodels, params, tmodel


def _inputs(v, B=6, seed=1):
    rng = np.random.default_rng(seed)
    obs = rng.random((B,) + v["obs"]).astype(np.float32)
    memory = rng.normal(size=(B, v["L"], v["blocks"], v["D"])).astype(
        np.float32)
    mask = rng.random((B, v["L"])) < 0.6
    mask[0] = False                       # an all-masked row
    indices = rng.integers(0, MAX_EP, (B, v["L"])).astype(np.int32)
    return obs, memory, mask, indices


def _apply(jmodels, params, fn, *args):
    """``fn(module, *args)`` on JAX's float32 and bfloat16 models."""
    args = [jnp.asarray(a) for a in args]
    return [m.apply(params, *args, method=fn) for m in jmodels]


def _bf16(rng, *shape):
    """Random normal values rounded to bfloat16, as (torch, jax) bfloat16
    arrays of the same values."""
    x = torch.as_tensor(rng.normal(size=shape).astype(np.float32)).to(
        torch.bfloat16)
    return x, jnp.asarray(x.float().numpy(), jnp.bfloat16)


def test_encoder_matches():
    v = VARIANTS["flagship"]
    jmodels, params, tmodel = _models(v)
    obs = _inputs(v)[0]
    j32, j16 = _apply(jmodels, params, JModel.encode, obs)
    port = tmodel.encode(torch.as_tensor(obs))
    assert port.dtype == torch.bfloat16 and j16.dtype == jnp.bfloat16
    assert_bf16_close(port, j16, j32, "encoder")


@pytest.mark.parametrize("name", list(VARIANTS))
def test_attention_matches(name):
    """One block's attention on bfloat16 K/V and queries, with an
    all-masked row."""
    v = VARIANTS[name]
    jmodels, params, tmodel = _models(v)
    rng = np.random.default_rng(2)
    B, L, D = 6, v["L"], v["D"]
    (k, jk), (val, jv), (q, jq) = (_bf16(rng, B, L, D), _bf16(rng, B, L, D),
                                   _bf16(rng, B, D))
    mask = _inputs(v)[2]

    def attend(m, k, v_, q, mask):
        return m.transformer.blocks[0].attention.attend(
            k, v_, q[:, None], mask)[:, 0]
    j32 = jmodels[0].apply(params, jk.astype(jnp.float32),
                           jv.astype(jnp.float32), jq.astype(jnp.float32),
                           jnp.asarray(mask), method=attend)
    j16 = jmodels[1].apply(params, jk, jv, jq, jnp.asarray(mask),
                           method=attend)
    port = tmodel.transformer.blocks[0].attention.attend(
        k, val, q, torch.as_tensor(mask))
    assert port.dtype == torch.bfloat16
    assert_bf16_close(port, j16, j32, "attention")


def test_gru_gate_matches():
    v = VARIANTS["pre_gtrxl_learned"]
    jmodels, params, tmodel = _models(v)
    rng = np.random.default_rng(3)
    (x, jx), (y, jy) = _bf16(rng, 6, v["D"]), _bf16(rng, 6, v["D"])

    def gate(m, x, y):
        return m.transformer.blocks[1].gate2(x, y)
    j32 = jmodels[0].apply(params, jx.astype(jnp.float32),
                           jy.astype(jnp.float32), method=gate)
    j16 = jmodels[1].apply(params, jx, jy, method=gate)
    port = tmodel.transformer.blocks[1].gate2(x, y)
    assert port.dtype == torch.bfloat16
    assert_bf16_close(port, j16, j32, "GRU gate")


@pytest.mark.parametrize("name", list(VARIANTS), ids=["post_ln", "pre_ln"])
def test_block_matches(name):
    """A block on PE-added float32 memory entries (K == V) and a bfloat16
    query: LayerNorm statistics in float32, its output in bfloat16."""
    v = VARIANTS[name]
    jmodels, params, tmodel = _models(v)
    rng = np.random.default_rng(4)
    memory = rng.normal(size=(6, v["L"], v["D"])).astype(np.float32)
    q, jq = _bf16(rng, 6, v["D"])
    mask = _inputs(v)[2]

    def block(m, memory, q, mask):
        return m.transformer.blocks[0](memory, memory, q[:, None], mask)[:, 0]
    j32 = jmodels[0].apply(params, jnp.asarray(memory),
                           jq.astype(jnp.float32), jnp.asarray(mask),
                           method=block)
    j16 = jmodels[1].apply(params, jnp.asarray(memory), jq, jnp.asarray(mask),
                           method=block)
    port = tmodel.transformer.blocks[0](torch.as_tensor(memory), q,
                                        torch.as_tensor(mask))
    assert port.dtype == torch.bfloat16
    assert_bf16_close(port, j16, j32, f"{name} block")


@pytest.mark.parametrize("name", list(VARIANTS))
def test_raw_memory_forward_matches(name):
    v = VARIANTS[name]
    jmodels, params, tmodel = _models(v)
    inputs = _inputs(v)
    j32, j16 = (m.apply(params, *map(jnp.asarray, inputs)) for m in jmodels)
    port = tmodel(*map(torch.as_tensor, inputs))
    assert_outputs_close(port, j16, j32, "forward")


@pytest.mark.parametrize("name", list(VARIANTS))
def test_forward_with_kv_matches(name):
    """``project_memory`` and ``pe_kv`` return bfloat16 K/V, as JAX's do;
    then ``forward_with_kv`` on them."""
    v = VARIANTS[name]
    jmodels, params, tmodel = _models(v)
    obs, memory, mask, indices = _inputs(v)
    jkv = _apply(jmodels, params, JModel.project_memory, memory, indices)
    kv = tmodel.project_memory(torch.as_tensor(memory),
                               torch.as_tensor(indices))
    pe = tmodel.pe_kv()
    jpe = _apply(jmodels, params, JModel.pe_kv)
    for i in range(2):
        assert kv[i].dtype == pe[i].dtype == torch.bfloat16
        assert jkv[1][i].dtype == jnp.bfloat16
        assert_bf16_close(kv[i], jkv[1][i], jkv[0][i], f"projection {i}")
        assert_bf16_close(pe[i], jpe[1][i], jpe[0][i], f"PE projection {i}")
    j32, j16 = (m.apply(params, jnp.asarray(obs), *jkv[n], jnp.asarray(mask),
                        method=JModel.forward_with_kv)
                for n, m in enumerate(jmodels))
    port = tmodel.forward_with_kv(torch.as_tensor(obs), *kv,
                                  torch.as_tensor(mask))
    assert_outputs_close(port, j16, j32, "forward_with_kv")


@pytest.mark.parametrize("name", list(VARIANTS))
def test_forward_with_ops_matches(name):
    """Each block's attention read from projected timelines through the
    window-attention op, cast to float32 at its boundary and back, as JAX's
    ``_loss_pallas`` does around ``fused_window_attention``."""
    v = VARIANTS[name]
    jmodels, params, tmodel = _models(v)
    B, W, L, blocks = 6, 2, v["L"], v["blocks"]
    S = MAX_EP + 20 + L
    rng = np.random.default_rng(5)
    obs = rng.random((B,) + v["obs"]).astype(np.float32)
    timeline = rng.normal(size=(W, S, blocks, v["D"])).astype(np.float32)
    slots = rng.integers(0, MAX_EP, (W, S)).astype(np.int32)
    idx = (rng.integers(0, W, B).astype(np.int32),
           rng.integers(0, S - L, B).astype(np.int32),
           rng.integers(1, L + 1, B).astype(np.int32),
           rng.integers(0, MAX_EP - L + 1, B).astype(np.int32),
           _inputs(v)[2])

    outs = []
    for m in jmodels:
        tk, tv = m.apply(params, jnp.asarray(timeline), jnp.asarray(slots),
                         method=JModel.project_memory)
        pk, pv = m.apply(params, method=JModel.pe_kv)
        f32 = lambda x: x.astype(jnp.float32)
        ops = [lambda q, i=i, tk=tk, tv=tv, pk=pk, pv=pv:
               fused_window_attention(
                   f32(q), f32(tk[:, :, i]), f32(tv[:, :, i]), f32(pk[:, i]),
                   f32(pv[:, i]), *map(jnp.asarray, idx), v["H"]
               ).astype(q.dtype) for i in range(blocks)]
        outs.append(m.apply(params, jnp.asarray(obs), ops,
                            method=JModel.forward_with_ops))

    kv = tmodel.project_memory_blocks(torch.as_tensor(timeline),
                                      torch.as_tensor(slots))
    pe = tmodel.pe_kv_blocks()
    tidx = [torch.as_tensor(a) for a in idx]
    ops = [lambda q, i=i: window_attention(
        q.float(), *(t.float() for t in kv[i] + pe[i]), *tidx,
        v["H"]).to(q.dtype) for i in range(blocks)]
    port = tmodel.forward_with_ops(torch.as_tensor(obs), ops)
    assert_outputs_close(port, outs[1], outs[0], "forward_with_ops")


# --- one minibatch's loss and gradients ------------------------------------


def _torch_batch(batch) -> RolloutBatch:
    t = lambda x: torch.tensor(np.asarray(x))
    return RolloutBatch(
        obs=t(batch.obs), actions=t(batch.actions).long(),
        log_probs=t(batch.log_probs), values=t(batch.values),
        advantages=t(batch.advantages),
        episode_steps=t(batch.episode_steps).long(), dones=t(batch.dones),
        tape=t(batch.tape), snapshot=t(batch.snapshot),
        episode_infos={k: t(v) for k, v in batch.episode_infos.items()})


def _jax_setup(jcfg):
    """JAX's float32 and bfloat16 models of ``jcfg``'s architecture, its
    parameters and a bfloat16 rollout batch (the second, which carries
    memory in)."""
    env = jax_create_env(jcfg.environment)
    jmodels = [JModel(config=dataclasses.replace(jcfg, compute_dtype=dt),
                      obs_shape=env.observation_shape,
                      action_branches=env.action_branches,
                      max_episode_steps=env.max_episode_steps)
               for dt in ("float32", "bfloat16")]
    params = jmodels[0].init_params(jax.random.PRNGKey(0))
    rollout_fn = JRolloutFn(jmodels[1].config, env, jmodels[1])
    state = rollout_fn.init_state(jax.random.PRNGKey(1))
    for _ in range(2):
        state, batch = rollout_fn(params, state)
    return env, jmodels, params, batch


def _jax_minibatch(update_fn, batch, idx, timeline: bool):
    """The minibatch and memory arguments of JAX's ``_loss_pallas`` (with
    ``timeline``) or ``_loss_fast``, built as PPOUpdateFn._update builds
    them."""
    cfg = update_fn.config
    W, T = cfg.n_workers, cfg.worker_steps
    L = cfg.transformer.memory_length
    flat = lambda x: x.reshape((W * T,) + x.shape[2:])[idx]
    mb = dict(obs=flat(batch.obs), actions=flat(batch.actions),
              log_probs=flat(batch.log_probs), values=flat(batch.values),
              advantages=flat(batch.advantages), w_idx=idx // T,
              memory_mask=update_fn.mask_table[
                  jnp.clip(flat(batch.episode_steps), 0, L - 1)])
    if timeline:
        tl = jmi.compute_timeline_sources(batch.episode_steps, batch.dones,
                                          update_fn.index_table, L)
        mb.update(tl_start=flat(tl.start), tl_n_valid=flat(tl.n_valid),
                  tl_s_lo=flat(tl.s_lo))
        return mb, (jmi.build_timeline(batch.snapshot, batch.tape,
                                       batch.episode_steps[:, 0], pad=L),
                    jmi.build_timeline_slots(batch.episode_steps,
                                             update_fn.max_ep, pad=L))
    max_ep = update_fn.max_ep
    sources = jmi.compute_window_sources(batch.episode_steps, batch.dones,
                                         update_fn.index_table, max_ep)
    mb["flat_index"] = flat(sources.flat_index)
    src = jnp.concatenate([batch.snapshot, batch.tape,
                           jnp.zeros_like(batch.snapshot)], axis=1)
    slot_range = jnp.tile(jnp.arange(max_ep, dtype=jnp.int32)[None], (W, 1))
    return mb, (src, jnp.concatenate(
        [slot_range, batch.episode_steps.astype(jnp.int32), slot_range], 1))


def _mini_kernel_config():
    cfg = jax_load_config("etmppo_tpu/configs/minigrid.yaml")
    return dataclasses.replace(
        cfg, n_workers=2, worker_steps=16, n_mini_batch=1, epochs=1,
        hidden_layer_size=32, transformer=dataclasses.replace(
            cfg.transformer, num_blocks=2, embed_dim=32, num_heads=4,
            memory_length=8))


@pytest.mark.parametrize("path", ["gathered", "timeline"])
def test_minibatch_loss_and_gradients_match(path, monkeypatch):
    """``loss_gathered`` against ``_loss_fast`` at POC_MEMORY's width
    (minibatch of 256); ``loss_timeline`` against ``_loss_pallas`` on the
    MiniGrid flagship's architecture at width 32 (one minibatch of 32),
    its window-attention op handed float32 only and returning bfloat16."""
    timeline = path == "timeline"
    jcfg = (_mini_kernel_config() if timeline
            else jax_load_config("etmppo_tpu/configs/poc_memory_env.yaml"))
    env, jmodels, params, batch = _jax_setup(jcfg)
    idx = np.random.default_rng(3).permutation(jcfg.batch_size)[
        :jcfg.mini_batch_size]
    j_stats, j_grads = [], []
    for m in jmodels:
        fn = jppo.PPOUpdateFn(m.config, m, env.max_episode_steps)
        mb, memory = _jax_minibatch(fn, batch, jnp.asarray(idx), timeline)
        loss = fn._loss_pallas if timeline else fn._loss_fast
        (_, stats), grads = jax.value_and_grad(loss, has_aux=True)(
            params, mb, *memory, CLIP, BETA)
        grads, _ = jppo.clip_grads_torch(grads, jcfg.max_grad_norm)
        j_stats.append(np.asarray(stats))
        j_grads.append(flax_to_state_dict(grads))

    tcfg = config_from_dict(dataclasses.asdict(jmodels[1].config))
    assert tcfg.compute_dtype == "bfloat16"
    model = ActorCriticModel(tcfg, env.observation_shape, env.action_branches,
                             env.max_episode_steps, device="cpu")
    load_flax_params(model, params)
    update = PPOUpdate(tcfg, model, env.max_episode_steps, generator=None)
    seen = []

    def op(q, *args, **kwargs):
        seen.extend(t.dtype for t in (q,) + args[:4])
        return window_attention(q, *args, **kwargs)
    monkeypatch.setattr(ppo_lib, "window_attention", op)
    memory, slots, fields = (update.prepare_timeline if timeline
                             else update.prepare_gathered)(
        _torch_batch(batch))
    loss_fn = update.loss_timeline if timeline else update.loss_gathered
    loss, stats = loss_fn(update.minibatch(fields, torch.as_tensor(idx)),
                          memory, slots, CLIP, BETA)
    loss.backward()
    torch.nn.utils.clip_grad_norm_(model.parameters(), jcfg.max_grad_norm)
    assert set(seen) == ({torch.float32} if timeline else set())
    assert len(seen) == (5 * jcfg.transformer.num_blocks if timeline else 0)
    # The loss alone, and the six stats as one vector (the KL and the clip
    # fraction lie near 0, where a bound of their own is below any noise).
    assert_bf16_close(loss.detach()[None], j_stats[1][2:3], j_stats[0][2:3],
                      "loss")
    assert_bf16_close(stats, j_stats[1], j_stats[0], "stats")
    # The clipped gradient as one vector, as AdamW takes it: a parameter
    # whose gradient is all cancellation (a key projection's, say) has
    # bfloat16 noise of the size of its own largest entry.
    names = [name for name, _ in model.named_parameters()]
    assert all(p.grad.dtype == torch.float32 for p in model.parameters())
    assert_bf16_close(torch.cat([p.grad.ravel() for p in model.parameters()]),
                      *(np.concatenate([g[n].numpy().ravel() for n in names])
                        for g in (j_grads[1], j_grads[0])), "gradients")


# --- a rollout ------------------------------------------------------------


def _jax_reset_keys(n, steps):
    """The reset keys of JAX's RolloutFn from ``init_state(PRNGKey(1))``."""
    rng, reset_rng = jax.random.split(jax.random.PRNGKey(1))
    resets = [jax.random.split(reset_rng, n)]
    for _ in range(steps):
        rng, _, _, reset_rng = jax.random.split(rng, 4)
        resets.append(jax.random.split(reset_rng, n))
    return resets


class _InjectedRollout(RolloutFn):
    """The port's rollout with JAX's actions and reset draws (PocMemory's
    steps draw nothing)."""

    def __init__(self, *args, actions, reset_draws):
        super().__init__(*args, generator=None)
        self.actions = actions
        self._resets = iter(reset_draws)

    def reset_draws(self):
        return next(self._resets)

    def sample_actions(self, logits, step):
        a = self.actions[:, step]
        return a, torch.stack([distributions.log_prob(l, a[:, i])
                               for i, l in enumerate(logits)], dim=-1)


def test_rollout_matches():
    """A PocMemory rollout of 64 steps at POC_MEMORY's width (4 workers),
    bfloat16 in both packages, the port handed JAX's actions and reset
    draws. JAX's float32 rollout from the same keys takes the same actions
    here, so it is the float32 reference along the same trajectory."""
    T, n = 64, 4
    jcfg = dataclasses.replace(
        jax_load_config("etmppo_tpu/configs/poc_memory_env.yaml"),
        n_workers=n, worker_steps=T)
    jenv = jax_create_env(jcfg.environment)
    jbatches = []
    for dt in ("float32", "bfloat16"):
        m = JModel(config=dataclasses.replace(jcfg, compute_dtype=dt),
                   obs_shape=jenv.observation_shape,
                   action_branches=jenv.action_branches,
                   max_episode_steps=jenv.max_episode_steps)
        if dt == "float32":
            params = m.init_params(jax.random.PRNGKey(0))
        fn = JRolloutFn(m.config, jenv, m)
        jbatches.append(fn(params, fn.init_state(jax.random.PRNGKey(1)))[1])
    j32, j16 = jbatches
    np.testing.assert_array_equal(np.asarray(j32.actions),
                                  np.asarray(j16.actions))

    tcfg = config_from_dict(dataclasses.asdict(
        dataclasses.replace(jcfg, compute_dtype="bfloat16")))
    env = PocMemoryEnv(glob=False, freeze=True, max_episode_steps=32,
                       n_workers=n, device="cpu")
    model = ActorCriticModel(tcfg, env.observation_shape, env.action_branches,
                             env.max_episode_steps, device="cpu")
    load_flax_params(model, params)
    reset = jax.jit(jax.vmap(jenv.reset))
    draws = []
    for keys in _jax_reset_keys(n, T):
        states = reset(keys)[0]
        start = np.searchsorted(env.start_ticks.numpy(),
                                np.asarray(states.ticks))
        draws.append(PocMemoryResetDraws(
            torch.as_tensor(start).long(),
            torch.as_tensor(np.asarray(states.goals)[:, 0] == 1.0)))
    fn = _InjectedRollout(tcfg, env, model,
                          actions=torch.as_tensor(np.asarray(j16.actions)
                                                  ).long(),
                          reset_draws=draws)
    _, tb = fn(fn.init_state())
    for name in ("obs", "episode_steps", "dones"):
        np.testing.assert_array_equal(getattr(tb, name).numpy(),
                                      np.asarray(getattr(j16, name)),
                                      err_msg=name)
    assert np.asarray(j16.dones).sum() >= 4
    for name in ("values", "log_probs", "tape", "advantages"):
        assert getattr(tb, name).dtype == torch.float32
        assert_bf16_close(getattr(tb, name), getattr(j16, name),
                          getattr(j32, name), name)


# --- training, resume and serving -------------------------------------------


def _tiny(tmp_path, **overrides):
    """The JAX package's tests/test_fused.py config, on the port."""
    raw = dict(POC_MEMORY, n_workers=4, worker_steps=16, n_mini_batch=2,
               epochs=2, hidden_layer_size=16, compute_dtype="bfloat16",
               transformer=dict(POC_MEMORY["transformer"], num_blocks=2,
                                embed_dim=16, num_heads=2, memory_length=8),
               summary_dir=str(tmp_path), checkpoint_dir=str(tmp_path))
    raw.update(overrides)
    return raw


def _mini_minigrid(tmp_path, **overrides):
    cfg = dataclasses.asdict(_mini_kernel_config())
    cfg.update(summary_dir=str(tmp_path), checkpoint_dir=str(tmp_path),
               compute_dtype="bfloat16", n_mini_batch=2, epochs=2, updates=2)
    cfg.update(overrides)
    return cfg


@pytest.mark.parametrize("case", ["gathered", "kernel", "native"])
def test_bfloat16_trains(tmp_path, case):
    """Two updates with finite stats; every parameter float32."""
    raw = {"gathered": _tiny(tmp_path),
           "kernel": _mini_minigrid(tmp_path, pallas_backward=True),
           "native": _tiny(tmp_path, environment={
               "type": "PocMemoryEnv-native"})}[case]
    trainer = PPOTrainer(config_from_dict(raw), device="cpu",
                         enable_metrics=False)
    try:
        assert trainer.config.use_pallas_attention == (case == "kernel")
        assert trainer.is_host_env == (case == "native")
        for _ in range(2):
            result = trainer.train_one_update()
            assert all(math.isfinite(v) for v in result.values()), result
    finally:
        trainer.close()
    assert trainer.model.compute_dtype == torch.bfloat16
    assert {p.dtype for p in trainer.model.parameters()} == {torch.float32}
    state = trainer.update_fn.optimizer.state_dict()["state"]
    assert {t.dtype for s in state.values() for k, t in s.items()
            if k != "step"} == {torch.float32}


def test_bfloat16_run_resumes_bit_for_bit(tmp_path):
    """A run cut after its first update and resumed from the checkpoint
    ends with the same bits as the run straight through."""
    raw = _tiny(tmp_path, updates=2, checkpoint_interval=1)
    straight = PPOTrainer(config_from_dict(raw), run_id="straight",
                          device="cpu", enable_metrics=False)
    straight.run_training(print_every=0)
    first = PPOTrainer(config_from_dict(dict(raw, updates=1)), run_id="cut",
                       device="cpu", enable_metrics=False)
    first.run_training(print_every=0)
    resumed = PPOTrainer(config_from_dict(raw), run_id="cut", device="cpu",
                         enable_metrics=False)
    assert resumed.resume_from_checkpoint() and resumed.update == 1
    resumed.run_training(print_every=0)
    a, b = straight.model.state_dict(), resumed.model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert torch.equal(straight.rollout_state.memory,
                       resumed.rollout_state.memory)


def test_bfloat16_artifact_serves_like_jax(tmp_path):
    """A bfloat16 ``.nn`` that the JAX package saved, served by both
    ``PolicyServer``s (greedy) on the same observations: values and the
    raw-memory logits within the criterion's bound against the float32
    server, and actions equal wherever JAX's top-2 logit gap exceeds twice
    that bound."""
    jcfg = dataclasses.replace(
        jax_load_config("etmppo_tpu/configs/poc_memory_env.yaml"),
        compute_dtype="bfloat16", hidden_layer_size=16,
        transformer=dataclasses.replace(
            jax_load_config("etmppo_tpu/configs/poc_memory_env.yaml"
                            ).transformer, num_blocks=2, embed_dim=16,
            num_heads=2, memory_length=6, positional_encoding="relative"))
    env = jax_create_env(jcfg.environment)
    jmodel = JModel(config=jcfg, obs_shape=env.observation_shape,
                    action_branches=env.action_branches,
                    max_episode_steps=env.max_episode_steps)
    params = jmodel.init_params(jax.random.PRNGKey(0))
    path16, path32 = str(tmp_path / "bf16.nn"), str(tmp_path / "fp32.nn")
    jax_save_model(path16, params, jcfg)
    jax_save_model(path32, params,
                   dataclasses.replace(jcfg, compute_dtype="float32"))
    M, steps = 8, 12
    servers = [JServer(path16, max_streams=M, greedy=True),
               JServer(path32, max_streams=M, greedy=True),
               PolicyServer(path16, max_streams=M, greedy=True, device="cpu")]
    assert servers[2].model.compute_dtype == torch.bfloat16
    for s in servers:
        s.reset(range(M))
    obs = np.random.default_rng(0).choice(
        [-1.0, 0.0, 1.0], size=(steps, M) + env.observation_shape
    ).astype(np.float32)
    raw = _RawLogits(servers[0], servers[2])
    compared = 0
    for t in range(steps):
        (a16, v16), (_, v32), (ta, tv) = (s.step(obs[t]) for s in servers)
        assert_bf16_close(tv, v16, v32, f"values at step {t}")
        # the logits of each server's step, from the raw-memory path
        l16, l32, lt = raw.logits(obs[t])
        assert_bf16_close(lt, l16, l32, f"logits at step {t}")
        bound = 2 * _distance(l16, l32) + BF16_ULP * np.abs(l32).max()
        top2 = np.sort(l16, axis=-1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > 2 * bound
        np.testing.assert_array_equal(np.asarray(ta)[clear, 0],
                                      np.asarray(a16)[clear, 0])
        compared += int(clear.sum())
    assert compared >= M * steps // 2
    np.testing.assert_array_equal(servers[2].steps, servers[0].steps)


class _RawLogits:
    """Each package's logits for a server's steps by the raw-memory
    formulation (``model.forward`` over ``memory[index_table[t]]``), all
    streams active from a reset: JAX bfloat16, JAX float32, port bfloat16."""

    def __init__(self, jserver, tserver):
        from etmppo_tpu_torch.ops.memory_index import (build_memory_indices,
                                                       build_memory_mask)
        jmodel, self.params = jserver.model, jserver.params
        self.jmodels = [jmodel, JModel(
            config=dataclasses.replace(jmodel.config, compute_dtype="float32"),
            obs_shape=jmodel.obs_shape, action_branches=jmodel.action_branches,
            max_episode_steps=jmodel.max_episode_steps)]
        self.tmodel = tserver.model
        trx = jmodel.config.transformer
        self.L = trx.memory_length
        self.index = build_memory_indices(jmodel.max_episode_steps, self.L)
        self.mask = build_memory_mask(self.L)
        self.shape = (jmodel.max_episode_steps, trx.num_blocks,
                      trx.embed_dim)
        self.memory = None
        self.t = 0

    def logits(self, obs):
        M = obs.shape[0]
        if self.memory is None:
            self.memory = [np.zeros((M,) + self.shape, np.float32)
                           for _ in range(3)]
        idx = np.tile(self.index[self.t][None], (M, 1))
        mask = np.tile(self.mask[min(self.t, self.L - 1)][None], (M, 1))
        out = []
        for n, mem in enumerate(self.memory):
            args = (obs, mem[:, self.index[self.t]], mask, idx)
            if n < 2:
                logits, _, new = self.jmodels[n].apply(
                    self.params, *map(jnp.asarray, args))
            else:
                with torch.no_grad():
                    logits, _, new = self.tmodel(*map(torch.as_tensor, args))
            mem[:, self.t] = _f32(new)
            out.append(_f32(logits[0]))
        self.t += 1
        return out


def test_bfloat16_run_saves_what_the_jax_package_loads(tmp_path,
                                                       monkeypatch):
    """A bfloat16 run's ``.nn``: float32 arrays and its config in the JAX
    package's format, which the JAX package loads; the port loads it back
    as a bfloat16 model, which ``evaluate_model`` and ``run_episodes`` run
    in bfloat16."""
    from etmppo_tpu.training.checkpoint import load_model as jax_load_model
    from etmppo_tpu_torch.enjoy import run_episodes
    from etmppo_tpu_torch.evaluate import evaluate_model
    from etmppo_tpu_torch.training.checkpoint import load_model
    trainer = PPOTrainer(config_from_dict(_tiny(tmp_path, updates=1)),
                         run_id="bf16", device="cpu", enable_metrics=False)
    trainer.run_training(print_every=0)
    path = str(tmp_path / "bf16.nn")
    params, jcfg = jax_load_model(path)
    assert jcfg.compute_dtype == "bfloat16"
    leaves = jax.tree.leaves(params)
    assert leaves and {leaf.dtype for leaf in leaves} == {np.dtype("float32")}
    state = flax_to_state_dict(params)
    for name, p in trainer.model.state_dict().items():
        assert torch.equal(state[name], p), name
    model, config = load_model(path, device="cpu")
    assert model.compute_dtype == torch.bfloat16
    dtypes, encode = [], ActorCriticModel.encode

    def recording_encode(self, obs):
        dtypes.append(self.compute_dtype)
        return encode(self, obs)
    monkeypatch.setattr(ActorCriticModel, "encode", recording_encode)
    summary = evaluate_model(path, episodes=2, device="cpu")
    assert math.isfinite(summary["reward_mean"])
    assert len(run_episodes(path, episodes=1, render=False,
                            device="cpu")) == 1
    assert dtypes and set(dtypes) == {torch.bfloat16}
