"""Episodic window attention over per-worker K/V timelines.

Counterpart of ``etmppo_tpu/ops/pallas_window_attention.py``. For sample b the
window is ``timeline[w_idx[b], start[b] : start[b] + n_valid[b]]`` followed by
``pe[s_lo[b] + n_valid[b] : s_lo[b] + L]``; per head the output is
``softmax(where(mask, q . K^T, -1e20) / sqrt(D)) . V``.

* ``window_attention_plain`` is the plain PyTorch formulation (the semantics of
  ``xla_window_attention``). The CPU path and the backward use it.
* ``WindowAttentionForward`` wraps the hand-written CUDA forward kernel
  (``csrc/window_attention_fwd.cu``). nvcc builds it at first use into a
  shared library with a plain C interface, loaded with ctypes; it keeps a count
  of its launches.
* ``window_attention`` is the autograd op: its forward launches the kernel for
  CUDA tensors (the plain version for CPU tensors), its backward re-derives
  the gradients through the plain version.
"""
from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

MASK_FILL = -1e20

_PACKAGE_DIR = Path(__file__).resolve().parent.parent
KERNEL_SOURCE = _PACKAGE_DIR / "csrc" / "window_attention_fwd.cu"
BUILD_DIR = _PACKAGE_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC")


def window_attention_plain(q, timeline_k, timeline_v, pe_k, pe_v, w_idx, start,
                           n_valid, s_lo, mask, num_heads: int):
    """q: (B, D); timeline_k/v: (W, S, D); pe_k/v: (P, D); w_idx, start,
    n_valid, s_lo: (B,) int; mask: (B, L) bool. Returns (B, D)."""
    B, D = q.shape
    L = mask.shape[1]
    head = D // num_heads
    offs = torch.arange(L, device=q.device)
    rows = start.long()[:, None] + offs[None, :]
    w = w_idx.long()[:, None]
    pe_rows = s_lo.long()[:, None] + offs[None, :]
    valid = (offs[None, :] < n_valid.long()[:, None])[:, :, None]
    k = torch.where(valid, timeline_k[w, rows], pe_k[pe_rows])
    v = torch.where(valid, timeline_v[w, rows], pe_v[pe_rows])
    energy = torch.einsum("bhd,blhd->bhl", q.reshape(B, num_heads, head),
                          k.reshape(B, L, num_heads, head))
    energy = energy.masked_fill(~mask.bool()[:, None, :], MASK_FILL)
    attention = torch.softmax(energy / math.sqrt(D), dim=-1)
    out = torch.einsum("bhl,blhd->bhd", attention,
                       v.reshape(B, L, num_heads, head))
    return out.reshape(B, D)


class WindowAttentionForward:
    """The CUDA forward kernel: built on first use, launched on the current
    stream, counted in ``launches``."""

    def __init__(self, source: Path = KERNEL_SOURCE,
                 build_dir: Path = BUILD_DIR):
        self.source = Path(source)
        self.build_dir = Path(build_dir)
        self.launches = 0
        self._lib = None

    def library_path(self) -> Path:
        digest = hashlib.sha256(
            self.source.read_bytes() + " ".join(NVCC_FLAGS).encode()
        ).hexdigest()[:16]
        return self.build_dir / f"window_attention_fwd_{digest}.so"

    def build(self) -> Path:
        """Compiles the source with nvcc unless a library built from the same
        source and flags is already there. Returns the library's path."""
        out = self.library_path()
        if out.exists():
            return out
        nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
        if not os.path.exists(nvcc):
            raise RuntimeError("nvcc not found: the CUDA window-attention "
                               "kernel cannot be built")
        self.build_dir.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=self.build_dir)
        os.close(fd)
        try:
            proc = subprocess.run(
                [nvcc, *NVCC_FLAGS, "-o", tmp, str(self.source)],
                capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        return out

    def _library(self):
        if self._lib is None:
            lib = ctypes.CDLL(str(self.build()))
            fn = lib.window_attention_fwd
            fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 7 + [
                ctypes.c_void_p]
            fn.restype = ctypes.c_int
            self._lib = lib
        return self._lib

    def __call__(self, q, timeline_k, timeline_v, pe_k, pe_v, w_idx, start,
                 n_valid, s_lo, mask, num_heads: int) -> torch.Tensor:
        B, D = _check_inputs(q, timeline_k, timeline_v, pe_k, pe_v, w_idx,
                             start, n_valid, s_lo, mask, num_heads)
        W, S, _ = timeline_k.shape
        P = pe_k.shape[0]
        L = mask.shape[1]
        lib = self._library()
        out = torch.empty_like(q)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.window_attention_fwd(
            q.data_ptr(), timeline_k.data_ptr(), timeline_v.data_ptr(),
            pe_k.data_ptr(), pe_v.data_ptr(), w_idx.data_ptr(),
            start.data_ptr(), n_valid.data_ptr(), s_lo.data_ptr(),
            mask.data_ptr(), out.data_ptr(), B, W, S, P, L, D, num_heads,
            stream)
        if err != 0:
            raise RuntimeError(
                f"window_attention_fwd launch failed: CUDA error {err}")
        self.launches += 1
        return out


def _check_inputs(q, timeline_k, timeline_v, pe_k, pe_v, w_idx, start,
                  n_valid, s_lo, mask, num_heads: int):
    """Raises unless the inputs are what the CUDA kernel takes."""
    tensors = dict(q=q, timeline_k=timeline_k, timeline_v=timeline_v,
                   pe_k=pe_k, pe_v=pe_v, w_idx=w_idx, start=start,
                   n_valid=n_valid, s_lo=s_lo, mask=mask)
    for name, t in tensors.items():
        if t.device != q.device or t.device.type != "cuda":
            raise ValueError(f"{name} must be on q's CUDA device, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name in ("q", "timeline_k", "timeline_v", "pe_k", "pe_v"):
        if tensors[name].dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {tensors[name].dtype}")
    for name in ("w_idx", "start", "n_valid", "s_lo"):
        if tensors[name].dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {tensors[name].dtype}")
    if mask.dtype not in (torch.bool, torch.uint8):
        raise ValueError(f"mask must be bool or uint8, got {mask.dtype}")
    if q.dim() != 2:
        raise ValueError(f"q must be (B, D), got {tuple(q.shape)}")
    B, D = q.shape
    if D % num_heads != 0:
        raise ValueError(f"D={D} is not divisible by num_heads={num_heads}")
    if (timeline_k.dim() != 3 or timeline_k.shape[2] != D
            or timeline_v.shape != timeline_k.shape):
        raise ValueError("timeline_k/v must both be (W, S, D)")
    if pe_k.dim() != 2 or pe_k.shape[1] != D or pe_v.shape != pe_k.shape:
        raise ValueError("pe_k/v must both be (P, D)")
    for name in ("w_idx", "start", "n_valid", "s_lo"):
        if tensors[name].shape != (B,):
            raise ValueError(f"{name} must be ({B},)")
    if mask.dim() != 2 or mask.shape[0] != B:
        raise ValueError(f"mask must be ({B}, L)")
    return B, D


window_attention_fwd = WindowAttentionForward()


class _WindowAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, timeline_k, timeline_v, pe_k, pe_v, w_idx, start,
                n_valid, s_lo, mask, num_heads, kernel):
        ctx.save_for_backward(q, timeline_k, timeline_v, pe_k, pe_v, w_idx,
                              start, n_valid, s_lo, mask)
        ctx.num_heads = num_heads
        args = (q, timeline_k, timeline_v, pe_k, pe_v, w_idx, start, n_valid,
                s_lo, mask, num_heads)
        if q.device.type == "cpu":
            return window_attention_plain(*args)
        return kernel(*args)

    @staticmethod
    def backward(ctx, grad_out):
        q, tk, tv, pk, pv, w_idx, start, n_valid, s_lo, mask = ctx.saved_tensors
        diff = [t.detach().requires_grad_(True) for t in (q, tk, tv, pk, pv)]
        with torch.enable_grad():
            out = window_attention_plain(*diff, w_idx, start, n_valid, s_lo,
                                         mask, ctx.num_heads)
            grads = torch.autograd.grad(out, diff, grad_out)
        return (*grads, None, None, None, None, None, None, None)


def window_attention(q, timeline_k, timeline_v, pe_k, pe_v, w_idx, start,
                     n_valid, s_lo, mask, num_heads: int,
                     kernel: WindowAttentionForward = window_attention_fwd):
    """Differentiable window attention (counterpart of
    ``fused_window_attention`` with its XLA-derived backward). CUDA inputs go
    through ``kernel``; CPU inputs through ``window_attention_plain``."""
    return _WindowAttention.apply(q, timeline_k, timeline_v, pe_k, pe_v,
                                  w_idx, start, n_valid, s_lo, mask,
                                  num_heads, kernel)
