"""The window-attention backward of etmppo_tpu_torch vs the JAX package's
fused Pallas backward ``_pallas_backward`` (interpret mode on the CPU, as
tests/test_pallas_attention.py runs it).

``window_attention_bwd_plain`` (and the autograd op, which takes it for CPU
tensors even when a backward kernel is passed) must give the Pallas kernel's
five gradients: dq, the timeline gradients dtk/dtv (scatter-added over
overlapping windows) and the PE-table gradients dpk/dpv. Both sides compute
in float32 from the same numpy inputs and differ only in summation order:
1e-4 relative / 1e-5 absolute, the tolerances of the JAX package's own
Pallas backward tests.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from etmppo_tpu.ops import pallas_window_attention as pwa
from etmppo_tpu_torch.ops.window_attention import (
    WindowAttentionBackward, window_attention, window_attention_bwd_plain)

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5
NAMES = ("dq", "dtk", "dtv", "dpk", "dpv")


def _case(B=8, W=3, S=30, P=12, L=8, D=32, H=4, seed=0):
    """Inputs and an output gradient; windows of one worker overlap."""
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.normal(size=shape).astype(np.float32)
    args = [f(B, D), f(W, S, D), f(W, S, D), f(P, D), f(P, D),
            rng.integers(0, W, B).astype(np.int32),
            rng.integers(0, S - L, B).astype(np.int32),
            rng.integers(1, L + 1, B).astype(np.int32),
            rng.integers(0, P - L + 1, B).astype(np.int32),
            rng.random((B, L)) < 0.7]
    args[9][0] = False            # an all-masked row
    return args, f(B, D), H


def _edge(kind):
    args, g, H = _case(B=8, seed=3)
    L = args[9].shape[1]
    if kind == "all_masked":
        args[9][:] = False
    elif kind == "n_valid_1":
        args[7][:] = 1
    elif kind == "n_valid_L":
        args[7][:] = L
    return args, g, H


CASES = {
    "default": lambda: _case(),
    "long_memory_head_64": lambda: _case(B=8, W=2, S=120, P=100, L=96, D=256,
                                         H=4, seed=1),
    "all_masked": lambda: _edge("all_masked"),
    "n_valid_1": lambda: _edge("n_valid_1"),
    "n_valid_L": lambda: _edge("n_valid_L"),
}


@functools.partial(jax.jit, static_argnums=(11,))
def _pallas_bwd(q, tk, tv, pk, pv, w_idx, start, n_valid, s_lo, mask, g, H):
    return pwa._pallas_backward(q, tk, tv, pk, pv, w_idx, start, n_valid,
                                s_lo, mask, g, H)


@functools.lru_cache(maxsize=None)
def _pallas_grads(name):
    args, g, H = CASES[name]()
    out = _pallas_bwd(*map(jnp.asarray, args), jnp.asarray(g), H)
    return [np.asarray(x) for x in out]


def _check(grads, name):
    for label, got, want in zip(NAMES, grads, _pallas_grads(name)):
        assert got.shape == want.shape, label
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                   err_msg=label)


@pytest.mark.parametrize("name", list(CASES))
def test_plain_backward_matches_pallas_backward(name):
    args, g, H = CASES[name]()
    t = [torch.as_tensor(a) for a in args]
    grads = window_attention_bwd_plain(*t, torch.as_tensor(g), H)
    _check([x.numpy() for x in grads], name)


@pytest.mark.parametrize("name", list(CASES))
def test_autograd_op_on_cpu_matches_pallas_backward(name):
    """The op takes the plain VJP for CPU tensors although a backward kernel
    is passed, and never reaches the kernel."""
    args, g, H = CASES[name]()
    kernel = WindowAttentionBackward()
    diff = [torch.tensor(a, requires_grad=True) for a in args[:5]]
    rest = [torch.as_tensor(a) for a in args[5:]]
    out = window_attention(*diff, *rest, H, backward_kernel=kernel)
    out.backward(torch.as_tensor(g))
    _check([x.grad.numpy() for x in diff], name)
    assert kernel.launches == 0 and kernel._lib is None


def test_all_masked_row_has_zero_dq_and_nonzero_dv():
    """Uniform p, zero ds: dq is 0, dV = p * g is not."""
    args, g, H = _edge("all_masked")
    t = [torch.as_tensor(a) for a in args]
    dq, dtk, dtv, dpk, dpv = window_attention_bwd_plain(
        *t, torch.as_tensor(g), H)
    assert torch.count_nonzero(dq) == 0
    assert torch.count_nonzero(dtk) == 0 and torch.count_nonzero(dpk) == 0
    assert torch.count_nonzero(dtv) + torch.count_nonzero(dpv) > 0


def test_only_the_needed_gradients_are_returned():
    args, g, H = _case()
    diff = [torch.tensor(a, requires_grad=(i == 2))
            for i, a in enumerate(args[:5])]
    rest = [torch.as_tensor(a) for a in args[5:]]
    out = window_attention(*diff, *rest, H,
                           backward_kernel=WindowAttentionBackward())
    out.backward(torch.as_tensor(g))
    assert [x.grad is None for x in diff] == [True, True, False, True, True]
    np.testing.assert_allclose(diff[2].grad.numpy(),
                               _pallas_grads("default")[2], rtol=RTOL,
                               atol=ATOL)
    grads = window_attention_bwd_plain(
        *[torch.as_tensor(a) for a in args], torch.as_tensor(g), H,
        needs_grad=(False, True, False, False, False))
    assert [x is None for x in grads] == [True, False, True, True, True]


def test_backward_wrapper_rejects_cpu_tensors():
    """The CUDA wrapper raises on anything but CUDA inputs rather than
    falling back to the plain version."""
    kernel = WindowAttentionBackward()
    args, g, H = _case(B=4)
    t = [torch.as_tensor(a) for a in args]
    with pytest.raises(ValueError, match="CUDA"):
        kernel(*t, torch.as_tensor(g), H)
    assert kernel.launches == 0 and kernel._lib is None
