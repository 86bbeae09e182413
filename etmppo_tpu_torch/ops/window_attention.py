"""Episodic window attention over per-worker K/V timelines.

Counterpart of ``etmppo_tpu/ops/pallas_window_attention.py``. For sample b the
window is ``timeline[w_idx[b], start[b] : start[b] + n_valid[b]]`` followed by
``pe[s_lo[b] + n_valid[b] : s_lo[b] + L]``; per head the output is
``softmax(where(mask, q . K^T, -1e20) / sqrt(D)) . V``.

* ``window_attention_plain`` is the plain PyTorch formulation (the semantics of
  ``xla_window_attention``) and ``window_attention_bwd_plain`` its VJP. CPU
  tensors take them.
* ``WindowAttentionForward`` and ``WindowAttentionBackward`` wrap the
  hand-written CUDA kernels (``csrc/window_attention_fwd.cu`` and
  ``csrc/window_attention_bwd.cu``). nvcc builds each at first use into a
  shared library with a plain C interface, loaded with ctypes; each keeps a
  count of its launches.
* ``window_attention`` is the autograd op. Its forward launches the forward
  kernel for CUDA tensors. Its backward launches the backward kernel when the
  caller passes one (``pallas_backward: true``), else it re-derives the
  gradients through the plain version (the JAX package's
  ``BACKWARD_MODE = "xla"``). The choice is the caller's, per call.
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
from typing import Optional, Sequence

import torch

MASK_FILL = -1e20

_PACKAGE_DIR = Path(__file__).resolve().parent.parent
FWD_SOURCE = _PACKAGE_DIR / "csrc" / "window_attention_fwd.cu"
BWD_SOURCE = _PACKAGE_DIR / "csrc" / "window_attention_bwd.cu"
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


def window_attention_bwd_plain(q, timeline_k, timeline_v, pe_k, pe_v, w_idx,
                              start, n_valid, s_lo, mask, g, num_heads: int,
                              needs_grad: Sequence[bool] = (True,) * 5):
    """VJP of ``window_attention_plain`` for the output gradient g (B, D).
    Returns (dq, dtk, dtv, dpk, dpv), shaped like (q, timeline_k, timeline_v,
    pe_k, pe_v); an entry whose ``needs_grad`` is False is None."""
    diff = [t.detach().requires_grad_(bool(need)) for t, need in
            zip((q, timeline_k, timeline_v, pe_k, pe_v), needs_grad)]
    wanted = [t for t in diff if t.requires_grad]
    grads = iter(())
    if wanted:
        with torch.enable_grad():
            out = window_attention_plain(*diff, w_idx, start, n_valid, s_lo,
                                         mask, num_heads)
            grads = iter(torch.autograd.grad(out, wanted, g))
    return tuple(next(grads) if t.requires_grad else None for t in diff)


class _CudaKernel:
    """A CUDA source built by nvcc on first use into a shared library with a
    plain C interface, loaded with ctypes. Subclasses launch it on the current
    stream and count each launch in ``launches``."""

    symbol = ""
    n_pointers = 0

    def __init__(self, source: Path, build_dir: Path = BUILD_DIR):
        self.source = Path(source)
        self.build_dir = Path(build_dir)
        self.launches = 0
        self._lib = None

    def library_path(self) -> Path:
        digest = hashlib.sha256(
            self.source.read_bytes() + " ".join(NVCC_FLAGS).encode()
        ).hexdigest()[:16]
        return self.build_dir / f"{self.source.stem}_{digest}.so"

    def build(self) -> Path:
        """Compiles the source with nvcc unless a library built from the same
        source and flags is already there. Returns the library's path."""
        out = self.library_path()
        if out.exists():
            return out
        nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
        if not os.path.exists(nvcc):
            raise RuntimeError(f"nvcc not found: {self.source.name} cannot "
                               "be built")
        self.build_dir.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=self.build_dir)
        os.close(fd)
        try:
            proc = subprocess.run(
                [nvcc, *NVCC_FLAGS, "-o", tmp, str(self.source)],
                capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed on {self.source.name} ({proc.returncode}):"
                    f"\n{proc.stdout}{proc.stderr}")
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        return out

    def _function(self):
        if self._lib is None:
            lib = ctypes.CDLL(str(self.build()))
            fn = getattr(lib, self.symbol)
            fn.argtypes = [ctypes.c_void_p] * self.n_pointers + [
                ctypes.c_int] * 7 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            self._lib = lib
        return getattr(self._lib, self.symbol)

    def _launch(self, pointers, ints, device) -> None:
        stream = torch.cuda.current_stream(device).cuda_stream
        err = self._function()(*pointers, *ints, stream)
        if err != 0:
            raise RuntimeError(
                f"{self.symbol} launch failed: CUDA error {err}")
        self.launches += 1


class WindowAttentionForward(_CudaKernel):
    """The CUDA forward kernel: out (B, D)."""

    symbol = "window_attention_fwd"
    n_pointers = 11

    def __init__(self, source: Path = FWD_SOURCE,
                 build_dir: Path = BUILD_DIR):
        super().__init__(source, build_dir)

    def __call__(self, q, timeline_k, timeline_v, pe_k, pe_v, w_idx, start,
                 n_valid, s_lo, mask, num_heads: int) -> torch.Tensor:
        inputs = (q, timeline_k, timeline_v, pe_k, pe_v, w_idx, start,
                  n_valid, s_lo, mask)
        B, D = _check_inputs(*inputs, num_heads)
        W, S, _ = timeline_k.shape
        out = torch.empty_like(q)
        self._launch([t.data_ptr() for t in inputs + (out,)],
                     (B, W, S, pe_k.shape[0], mask.shape[1], D, num_heads),
                     q.device)
        return out


class WindowAttentionBackward(_CudaKernel):
    """The CUDA backward kernel: (dq, dtk, dtv, dpk, dpv) for the output
    gradient g. The gradient tables are zeroed on the current stream, then
    the kernel adds into them with fp32 atomics, so their last bits vary from
    run to run."""

    symbol = "window_attention_bwd"
    n_pointers = 16

    def __init__(self, source: Path = BWD_SOURCE,
                 build_dir: Path = BUILD_DIR):
        super().__init__(source, build_dir)

    def __call__(self, q, timeline_k, timeline_v, pe_k, pe_v, w_idx, start,
                 n_valid, s_lo, mask, g, num_heads: int):
        inputs = (q, timeline_k, timeline_v, pe_k, pe_v, w_idx, start,
                  n_valid, s_lo, mask)
        B, D = _check_inputs(*inputs, num_heads)
        if (g.device != q.device or g.dtype != torch.float32
                or g.shape != q.shape or not g.is_contiguous()):
            raise ValueError("g must be a contiguous float32 tensor shaped "
                             "and placed like q")
        W, S, _ = timeline_k.shape
        dq = torch.empty_like(q)
        grads = [torch.zeros_like(t) for t in
                 (timeline_k, timeline_v, pe_k, pe_v)]
        self._launch([t.data_ptr() for t in inputs + (g, dq, *grads)],
                     (B, W, S, pe_k.shape[0], mask.shape[1], D, num_heads),
                     q.device)
        return (dq, *grads)


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
window_attention_bwd = WindowAttentionBackward()


class _WindowAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, timeline_k, timeline_v, pe_k, pe_v, w_idx, start,
                n_valid, s_lo, mask, num_heads, kernel, backward_kernel):
        ctx.save_for_backward(q, timeline_k, timeline_v, pe_k, pe_v, w_idx,
                              start, n_valid, s_lo, mask)
        ctx.num_heads = num_heads
        ctx.backward_kernel = backward_kernel
        args = (q, timeline_k, timeline_v, pe_k, pe_v, w_idx, start, n_valid,
                s_lo, mask, num_heads)
        if q.device.type == "cpu":
            return window_attention_plain(*args)
        return kernel(*args)

    @staticmethod
    def backward(ctx, grad_out):
        saved = ctx.saved_tensors
        needs = ctx.needs_input_grad[:5]
        if not any(needs):
            grads = (None,) * 5
        elif saved[0].device.type == "cpu" or ctx.backward_kernel is None:
            grads = window_attention_bwd_plain(*saved, grad_out,
                                               ctx.num_heads, needs)
        else:
            grads = ctx.backward_kernel(*saved, grad_out.contiguous(),
                                        ctx.num_heads)
            grads = tuple(t if need else None for t, need in zip(grads, needs))
        return (*grads, None, None, None, None, None, None, None, None)


def window_attention(q, timeline_k, timeline_v, pe_k, pe_v, w_idx, start,
                     n_valid, s_lo, mask, num_heads: int,
                     kernel: WindowAttentionForward = window_attention_fwd,
                     backward_kernel: Optional[WindowAttentionBackward] = None):
    """Differentiable window attention (counterpart of
    ``fused_window_attention``). CUDA inputs go forward through ``kernel``
    and backward through ``backward_kernel``, or through the plain VJP when
    it is None; CPU inputs go through the plain versions both ways."""
    return _WindowAttention.apply(q, timeline_k, timeline_v, pe_k, pe_v,
                                  w_idx, start, n_valid, s_lo, mask,
                                  num_heads, kernel, backward_kernel)
