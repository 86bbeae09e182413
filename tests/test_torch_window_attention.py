"""etmppo_tpu_torch window attention vs the JAX package's
``fused_window_attention`` (Pallas kernel in interpret mode on the CPU, its
backward through the XLA formulation).

Both sides compute in float32 from the same numpy inputs; the only difference
is summation order, so forward outputs agree to 1e-5 and gradients (which
scatter-add over overlapping windows) to 1e-5 absolute / 1e-4 relative, the
tolerances the JAX package's own Pallas tests use.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from etmppo_tpu.ops.pallas_window_attention import fused_window_attention
from etmppo_tpu_torch.ops.window_attention import (
    WindowAttentionForward, window_attention, window_attention_plain)

torch.set_num_threads(1)


def _case(B=16, W=4, S=40, P=12, L=8, D=32, H=4, seed=0):
    """The inputs of tests/test_pallas_attention.py::_case, with row 0 of the
    mask all False (uniform attention)."""
    np_rng = np.random.default_rng(seed)
    q = np_rng.normal(size=(B, D)).astype(np.float32)
    tk = np_rng.normal(size=(W, S, D)).astype(np.float32)
    tv = np_rng.normal(size=(W, S, D)).astype(np.float32)
    pe_k = np_rng.normal(size=(P, D)).astype(np.float32)
    pe_v = np_rng.normal(size=(P, D)).astype(np.float32)
    w_idx = np_rng.integers(0, W, B).astype(np.int32)
    start = np_rng.integers(0, S - L, B).astype(np.int32)
    n_valid = np_rng.integers(1, L + 1, B).astype(np.int32)
    s_lo = np_rng.integers(0, P - L + 1, B).astype(np.int32)
    mask = np_rng.random((B, L)) < 0.7
    mask[0, :] = False
    return [q, tk, tv, pe_k, pe_v, w_idx, start, n_valid, s_lo, mask], H


def _edge(kind):
    args, H = _case(B=12, D=32, seed=3)
    L = args[9].shape[1]
    if kind == "all_masked":
        args[9][:] = False
    elif kind == "n_valid_1":
        args[7][:] = 1
    elif kind == "n_valid_L":
        args[7][:] = L
    elif kind == "single_head":
        H = 1
    return args, H


CASES = {
    "default": lambda: _case(),
    "odd_batch": lambda: _case(B=12, H=2, D=16, seed=1),
    "all_masked": lambda: _edge("all_masked"),
    "n_valid_1": lambda: _edge("n_valid_1"),
    "n_valid_L": lambda: _edge("n_valid_L"),
    "single_head": lambda: _edge("single_head"),
}


def _jax_grads(args, H):
    jargs = [jnp.asarray(a) for a in args]

    def loss(q, tk, tv, pk, pv):
        out = fused_window_attention(q, tk, tv, pk, pv, *jargs[5:], H)
        return jnp.sum(jnp.sin(out)), out

    (_, out), grads = jax.value_and_grad(
        loss, argnums=(0, 1, 2, 3, 4), has_aux=True)(*jargs[:5])
    return np.asarray(out), [np.asarray(g) for g in grads]


def _torch_grads(fn, args, H):
    diff = [torch.tensor(a, requires_grad=True) for a in args[:5]]
    rest = [torch.as_tensor(a) for a in args[5:]]
    out = fn(*diff, *rest, H)
    torch.sin(out).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in diff]


@pytest.mark.parametrize("name", list(CASES))
def test_plain_matches_jax_forward_and_gradients(name):
    args, H = CASES[name]()
    out_j, grads_j = _jax_grads(args, H)
    out_t, grads_t = _torch_grads(window_attention_plain, args, H)
    np.testing.assert_allclose(out_t, out_j, rtol=1e-5, atol=1e-5)
    for label, gt, gj in zip(("dq", "dtk", "dtv", "dpk", "dpv"), grads_t,
                             grads_j):
        np.testing.assert_allclose(gt, gj, rtol=1e-4, atol=1e-5,
                                   err_msg=label)


@pytest.mark.parametrize("name", list(CASES))
def test_autograd_op_on_cpu_matches_jax(name):
    """The differentiable op takes the plain path for CPU tensors and derives
    its gradients through it."""
    args, H = CASES[name]()
    out_j, grads_j = _jax_grads(args, H)
    out_t, grads_t = _torch_grads(window_attention, args, H)
    np.testing.assert_allclose(out_t, out_j, rtol=1e-5, atol=1e-5)
    for gt, gj in zip(grads_t, grads_j):
        np.testing.assert_allclose(gt, gj, rtol=1e-4, atol=1e-5)


def test_all_masked_row_is_uniform_over_window():
    args, H = _edge("all_masked")
    t = [torch.as_tensor(a) for a in args]
    out = window_attention_plain(*t, H)
    # uniform attention: each head's output is the mean of its window rows
    q, tk, tv, pk, pv, w, st, nv, slo, mask = t
    L = mask.shape[1]
    for b in range(3):
        rows = [tv[w[b], st[b] + l] if l < nv[b] else pv[slo[b] + l]
                for l in range(L)]
        np.testing.assert_allclose(out[b].numpy(),
                                   torch.stack(rows).mean(0).numpy(),
                                   rtol=1e-5, atol=1e-6)


def test_cpu_op_does_not_launch_the_kernel():
    """On the CPU the op never reaches the CUDA wrapper, so its launch count
    stays 0 and nothing is built."""
    kernel = WindowAttentionForward()
    args, H = _case(B=4)
    t = [torch.as_tensor(a) for a in args]
    window_attention(*t, H, kernel=kernel)
    assert kernel.launches == 0 and kernel._lib is None


def test_kernel_wrapper_rejects_cpu_tensors():
    """The CUDA wrapper itself raises on anything but CUDA inputs rather than
    falling back."""
    kernel = WindowAttentionForward()
    args, H = _case(B=4)
    t = [torch.as_tensor(a) for a in args]
    with pytest.raises(ValueError, match="CUDA"):
        kernel(*t, H)
    assert kernel.launches == 0
