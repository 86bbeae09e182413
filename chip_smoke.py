#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (etmppo_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one line with its seconds:

1. device:      requires a CUDA device; prints the card's name and power limit
                (nvidia-smi) and turns TF32 off for matmuls and convolutions.
2. build:       compiles the four window-attention kernels from
                etmppo_tpu_torch/csrc/ (the per-sample forward and backward,
                the grouped forward and backward), one nvcc process each,
                started together (a library built from the same source is
                reused).
3. kernel:      prints each kernel's registers, spills and static shared
                memory (nvcc's -Xptxas -v report) and the per-sample
                kernels' launch plans. Holds each kernel against its plain
                PyTorch version, the grouped forward against the per-sample
                one and the grouped backward against the per-sample one, at
                the MiniGrid flagship shape (B=1024, W=16, S=672, P=96, L=64,
                D=384, H=4), the Mystery Path Grid shape (B=2048, W=32,
                S=736, P=128, L=96, D=256, H=4) and the Mortar Mayhem Grid
                shape (B=2048, W=32, S=750, P=120, L=118, D=384, H=4), with
                windows from the port's own index math, and on the small
                cases of EDGE_CASES: all-masked rows, n_valid in {1, L} and a
                worker with no samples, at the flagship's width, at
                headroom_768.yaml's (L=96, D=768, H=6), at a head width
                that is not a multiple of 4 (D=40, H=4, L=13), at a width
                that is not (D=30, H=3) and with tables that are not
                16-byte aligned (the last two take the per-sample kernels'
                4-byte copies and scalar atomics); and a
                minibatch all of one worker. Two calls of the grouped
                backward must give the same bits. Times kernel, plain
                version, a library yardstick (gather +
                scaled_dot_product_attention, and for the backward autograd
                through that graph) and the bound.
4. trainer:     two PPO updates of the MiniGrid-Memory flagship exactly as its
                YAML says (pallas_backward: true) at full width (16 workers x
                512 steps, TrXL 3 x 384, 5 epochs x 8 minibatches); each kernel
                must launch exactly 120 times per update (3 blocks x 40
                minibatches) and every stat must be finite. Then, on one more
                rollout, the loss and gradients of one minibatch through both
                kernels must match those through both plain versions; and one
                more rollout and PPO update are timed apart, the update with
                the plain and the kernel backward in turns.
5. mysterypath: two PPO updates of the Mystery Path Grid flagship at full
                width (32 workers x 512 steps, TrXL 2 x 256, memory 96, 3
                epochs x 8 minibatches) through run_training, checkpointing
                every update; each kernel must launch exactly 48 times per
                update and every logged stat must be finite. A fresh trainer
                resumes from the checkpoint bit for bit and takes one more
                finite update; the saved .nn loads back to the same weights.
                Then one more rollout and PPO update are timed apart, the
                update with the plain and the kernel backward in turns.
6. mortarmayhem: two PPO updates of the Mortar Mayhem Grid flagship exactly
                as its YAML says (32 workers x 512 steps, TrXL 3 x 384,
                memory 118, 3 epochs x 8 minibatches) with the grouped
                kernels (PPOTrainer(..., grouped=True)); each grouped kernel
                must launch exactly 72 times per update (3 blocks x 24
                minibatches), the per-sample ones never, every stat must be
                finite, and the saved .nn must load back to the same weights.
                Prints the kernel shape the trainer gives. Then one more
                rollout, and the PPO update on its batch in turns with the
                plain backward, the per-sample pair and the grouped pair
                (mortarmayhem-split); and, from one state and batch, two
                updates with each pair (determinism): the largest parameter
                difference between the two, reported, not gated (cuDNN and
                the timeline-gather backward may still differ in the last
                bits), then again with PyTorch's deterministic algorithms
                and cuDNN's deterministic mode on.

Then it prints the kernel table as one JSON line and, last, the result line.
Any failure raises: the script exits non-zero and prints no result line.
"""
from __future__ import annotations

import copy
import csv
import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import torch

REPLACES = {
    "window_attention_fwd": "etmppo_tpu/ops/pallas_window_attention.py:151",
    "window_attention_bwd": "etmppo_tpu/ops/pallas_window_attention.py:250",
    "window_attention_fwd_grouped":
        "etmppo_tpu/ops/pallas_window_attention.py:449",
    "window_attention_bwd_grouped":
        "etmppo_tpu/ops/pallas_window_attention.py:503",
}
# Forward: fp32 outputs of magnitude ~1, summed in another order than the
# plain version: agreement to 1e-4 absolute leaves two orders of margin.
FWD_ATOL = 1e-4
# Backward: each gradient is compared relative to its own largest entry. The
# per-sample kernel adds into the timeline and PE tables with fp32 atomics, in
# an order that changes from run to run; the grouped kernel sums in the
# sorted order; both sum dq in another order than the plain VJP: 1e-5 of the
# largest entry leaves an order of margin over fp32 rounding of the few
# hundred terms that meet in one entry.
BWD_RTOL = 1e-5
# Loss and gradients of one minibatch, kernels vs plain versions: the
# difference enters through the attention outputs and their gradients only
# (relative to the loss and to the largest gradient entry).
LOSS_RTOL = 1e-4
GRAD_RTOL = 1e-4
H100_BYTES_PER_S = 3.35e12     # HBM3, H100 SXM data sheet
H100_FP32_FLOPS = 67e12        # fp32 outside the tensor cores
UPDATES = 2
FLAGSHIP_LAUNCHES = 120        # per update: 3 blocks x 5 epochs x 8 minibatches
MYSTERY_LAUNCHES = 48          # per update: 2 blocks x 3 epochs x 8 minibatches
MORTAR_LAUNCHES = 72           # per update: 3 blocks x 3 epochs x 8 minibatches
# (W, T, max_episode_steps, L, D, B) of the three configurations' minibatches.
SHAPES = {"flagship": (16, 512, 96, 64, 384, 1024),
          "mysterypath": (32, 512, 128, 96, 256, 2048),
          "mortarmayhem": (32, 512, 120, 118, 384, 2048)}
# The kernels, and the configuration whose path launches each.
NAMES = ("window_attention_fwd", "window_attention_bwd",
         "window_attention_fwd_grouped", "window_attention_bwd_grouped")
MAIN_SHAPE = {"window_attention_fwd": "flagship",
              "window_attention_bwd": "flagship",
              "window_attention_fwd_grouped": "mortarmayhem",
              "window_attention_bwd_grouped": "mortarmayhem"}


def phase(name: str, start: float, detail: str = "") -> None:
    print(f"[{name}] {time.perf_counter() - start:.2f}s {detail}".rstrip(),
          flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    begin = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    begin.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return begin.elapsed_time(end) / iters


def window_inputs(gen: torch.Generator, device, shape: str):
    """Kernel inputs at a configuration's shape, with window sources from the
    port's index math over synthetic episodes of W workers x T steps."""
    from etmppo_tpu_torch.ops.memory_index import (build_memory_indices,
                                                   build_memory_mask,
                                                   compute_timeline_sources)
    W, T, max_ep, L, D, B = SHAPES[shape]
    S = max_ep + T + L
    # Episodes of 10..max_ep steps; each worker starts mid-episode.
    steps = torch.empty(W, T, dtype=torch.int64)
    dones = torch.zeros(W, T, dtype=torch.bool)
    for w in range(W):
        e = int(torch.randint(0, max_ep // 2, (1,), generator=gen))
        length = int(torch.randint(e + 1, max_ep + 1, (1,), generator=gen))
        for t in range(T):
            steps[w, t] = e
            if e + 1 >= length:
                dones[w, t] = True
                e = 0
                length = int(torch.randint(10, max_ep + 1, (1,), generator=gen))
            else:
                e += 1
    index_table = torch.as_tensor(build_memory_indices(max_ep, L))
    tl = compute_timeline_sources(steps, dones, index_table, L)
    idx = torch.randperm(W * T, generator=gen)[:B]
    mask = torch.as_tensor(build_memory_mask(L))[
        steps.reshape(-1)[idx].clamp(0, L - 1)]
    floats = [torch.randn(shape, generator=gen) for shape in
              ((B, D), (W, S, D), (W, S, D), (max_ep, D), (max_ep, D))]
    ints = [(idx // T).int(), tl.start.reshape(-1)[idx],
            tl.n_valid.reshape(-1)[idx], tl.s_lo.reshape(-1)[idx]]
    args = [t.to(device).contiguous() for t in floats + ints + [mask]]
    return args, 4


# Small cases, (B, W, S, P, L, D, H, layout): the MiniGrid flagship's width
# on a short window; the same with every sample of worker 1 ("one worker");
# headroom_768.yaml's kernel shape (L=96, D=768, H=6, head width 128) at a
# small batch; a head width that is not a multiple of 4 (D=40, H=4: 10); a
# width that is not a multiple of 4 (D=30, H=3), where the per-sample kernels
# take their 4-byte copies and the backward its scalar atomics; and the
# flagship's width with the timeline and PE tables as contiguous views that
# start 4 bytes past a 16-byte boundary ("misaligned"), the same paths.
EDGE_CASES = {"edge case": (64, 4, 80, 24, 16, 384, 4, "mixed"),
              "one worker": (64, 4, 80, 24, 16, 384, 4, "one worker"),
              "headroom_768": (48, 4, 240, 120, 96, 768, 6, "mixed"),
              "narrow heads": (64, 4, 40, 20, 13, 40, 4, "mixed"),
              "odd width": (64, 4, 40, 20, 13, 30, 3, "mixed"),
              "misaligned tables": (64, 4, 80, 24, 16, 384, 4, "misaligned")}


def _misaligned(t: torch.Tensor, device) -> torch.Tensor:
    """A copy of t on the device: a contiguous view one element into a
    buffer, so that it starts 4 bytes past a 16-byte boundary."""
    view = torch.empty(t.numel() + 1, dtype=t.dtype, device=device)[1:]
    view = view.view(t.shape).copy_(t)
    if view.data_ptr() % 16 == 0:
        raise RuntimeError("a misaligned view came out 16-byte aligned")
    return view


def edge_inputs(gen: torch.Generator, device, case: str):
    """A case of EDGE_CASES. Each has all-masked rows, n_valid = 1 and
    n_valid = L, and a worker (the last) with no samples, except "one
    worker", where every sample is worker 1's."""
    B, W, S, P, L, D, heads, layout = EDGE_CASES[case]
    floats = [torch.randn(shape, generator=gen) for shape in
              ((B, D), (W, S, D), (W, S, D), (P, D), (P, D))]
    w_idx = torch.randint(0, W - 1, (B,), generator=gen, dtype=torch.int32)
    if layout == "one worker":
        w_idx[:] = 1
    start = torch.randint(0, S - L + 1, (B,), generator=gen, dtype=torch.int32)
    n_valid = torch.randint(1, L + 1, (B,), generator=gen, dtype=torch.int32)
    s_lo = torch.randint(0, P - L + 1, (B,), generator=gen, dtype=torch.int32)
    mask = torch.rand(B, L, generator=gen) < 0.7
    mask[:8] = False
    n_valid[0::3] = 1
    n_valid[1::3] = L
    args = [t.to(device).contiguous() for t in
            floats + [w_idx, start, n_valid, s_lo, mask]]
    if layout == "misaligned":
        args[1:5] = [_misaligned(t, device) for t in floats[1:]]
    return args, heads


def plan_shapes() -> dict:
    """(L, D, H) of the three configurations' and of the edge cases'
    windows."""
    shapes = {name: (L, D, 4) for name, (_, _, _, L, D, _) in SHAPES.items()}
    shapes.update({name: (L, D, heads) for name, (_, _, _, _, L, D, heads, _)
                   in EDGE_CASES.items()})
    return shapes


def bound_ms(args, backward: bool) -> tuple:
    """Least time for the work these inputs need. Bytes: each distinct
    timeline and PE row read once (K and V), q (and g) and the indices read;
    the forward writes out (B, D), the backward dq (B, D) and the gradient
    tables whole. Operations: 4*B*L*D flops forward (QK and PV), about
    8*B*L*D backward (recomputed QK, dp, dq, dK, dV)."""
    q, tk, _, pe_k, _, w_idx, start, n_valid, s_lo, mask = args
    B, D = q.shape
    W, S, _ = tk.shape
    P = pe_k.shape[0]
    L = mask.shape[1]
    offs = torch.arange(L, device=q.device)
    valid = offs[None] < n_valid[:, None]
    rows = (w_idx[:, None].long() * S + start[:, None] + offs[None])[valid]
    pe_rows = (s_lo[:, None] + offs[None])[~valid]
    n_rows = rows.unique().numel() + pe_rows.unique().numel()
    n_bytes = 2 * n_rows * D * 4 + 2 * B * D * 4 + 4 * B * 4 + B * L
    flops = 4 * B * L * D
    if backward:
        n_bytes += B * D * 4 + 2 * (W * S + P) * D * 4
        flops = 8 * B * L * D
    t_bytes = n_bytes / H100_BYTES_PER_S * 1e3
    t_flops = flops / H100_FP32_FLOPS * 1e3
    return max(t_bytes, t_flops), ("bytes" if t_bytes >= t_flops
                                   else "operations")


def sdpa_yardstick(args, num_heads: int):
    """Gather the windows, then one scaled_dot_product_attention call."""
    import torch.nn.functional as F
    q, tk, tv, pe_k, pe_v, w_idx, start, n_valid, s_lo, mask = args
    B, D = q.shape
    L = mask.shape[1]
    hd = D // num_heads
    offs = torch.arange(L, device=q.device)
    w = w_idx.long()[:, None]
    rows = start.long()[:, None] + offs
    pe_rows = s_lo.long()[:, None] + offs
    valid = (offs[None] < n_valid[:, None])[:, :, None]
    fill = torch.zeros(B, L, device=q.device).masked_fill(~mask, -1e20)
    bias = fill[:, None, None, :]

    def run():
        k = torch.where(valid, tk[w, rows], pe_k[pe_rows])
        v = torch.where(valid, tv[w, rows], pe_v[pe_rows])
        split = lambda x: x.reshape(B, -1, num_heads, hd).transpose(1, 2)
        return F.scaled_dot_product_attention(
            split(q[:, None]), split(k), split(v), attn_mask=bias,
            scale=1.0 / math.sqrt(D)).reshape(B, D)
    return run


def sdpa_backward_yardstick(args, g, num_heads: int):
    """Autograd through the gather + SDPA graph, built once outside the timed
    region: the five input gradients."""
    diff = [t.detach().requires_grad_(True) for t in args[:5]]
    out = sdpa_yardstick(diff + list(args[5:]), num_heads)()
    return lambda: torch.autograd.grad(out, diff, g, retain_graph=True)


def check_forward(kernel, plain, args, num_heads: int, label: str) -> float:
    out = kernel(*args, num_heads)
    torch.cuda.synchronize()
    ref = plain(*args, num_heads)
    if not torch.isfinite(out).all():
        raise RuntimeError(f"forward, {label}: kernel output is not finite")
    err = (out - ref).abs().max().item()
    if err > FWD_ATOL:
        raise RuntimeError(f"forward, {label}: kernel disagrees with the "
                           f"plain version: max_abs_err {err} > {FWD_ATOL}")
    return err


def check_backward(kernel, plain, args, g, num_heads: int, label: str):
    """Max abs error over the five gradients, and the largest ratio of an
    error to its tolerance."""
    grads = kernel(*args, g, num_heads)
    torch.cuda.synchronize()
    refs = plain(*args, g, num_heads)
    worst, share = 0.0, 0.0
    for name, got, ref in zip(("dq", "dtk", "dtv", "dpk", "dpv"), grads,
                              refs):
        if got.shape != ref.shape or not torch.isfinite(got).all():
            raise RuntimeError(f"backward, {label}: {name} is not finite or "
                               f"has shape {tuple(got.shape)}")
        err = (got - ref).abs().max().item()
        tol = BWD_RTOL * max(ref.abs().max().item(), 1e-30)
        if err > tol:
            raise RuntimeError(f"backward, {label}: {name} disagrees with the "
                               f"plain VJP: max_abs_err {err} > {tol}")
        worst, share = max(worst, err), max(share, err / tol)
    return worst, share


def check_repeatable(kernel, args, g, num_heads: int, label: str) -> None:
    """Two calls on one input must give the same bits in all five
    gradients."""
    first = kernel(*args, g, num_heads)
    second = kernel(*args, g, num_heads)
    torch.cuda.synchronize()
    for name, x, y in zip(("dq", "dtk", "dtv", "dpk", "dpv"), first, second):
        if not torch.equal(x, y):
            raise RuntimeError(f"backward, {label}: two calls of "
                               f"{kernel.symbol} differ in {name}")


def check_all(k, args, g, num_heads: int, label: str) -> dict:
    """Every kernel against its plain version; the grouped forward against
    the per-sample forward, the grouped backward against the per-sample
    backward, and the grouped backward against itself. Returns the largest
    error of each kernel, and each backward's largest share of its
    tolerance."""
    fwd, bwd, fwd_g, bwd_g = (k[n] for n in NAMES)
    errs, shares = {}, {}
    errs[fwd.symbol] = check_forward(fwd, fwd.plain, args, num_heads, label)
    errs[fwd_g.symbol] = max(
        check_forward(fwd_g, fwd_g.plain, args, num_heads, label),
        check_forward(fwd_g, fwd, args, num_heads,
                      label + ", grouped vs per-sample"))
    errs[bwd.symbol], shares[bwd.symbol] = check_backward(
        bwd, bwd.plain, args, g, num_heads, label)
    checks = [check_backward(bwd_g, bwd_g.plain, args, g, num_heads, label),
              check_backward(bwd_g, bwd.plain, args, g, num_heads,
                             label + ", grouped vs plain VJP"),
              check_backward(bwd_g, bwd, args, g, num_heads,
                             label + ", grouped vs per-sample")]
    errs[bwd_g.symbol] = max(c[0] for c in checks)
    shares[bwd_g.symbol] = max(c[1] for c in checks)
    check_repeatable(bwd_g, args, g, num_heads, label)
    return {name: dict(max_abs_err=errs[name],
                       **({"tol_share": shares[name]} if name in shares
                          else {})) for name in errs}


def measure_shape(k, gen, device, shape):
    """Checks and times the four kernels at one configuration's shape."""
    args, heads = window_inputs(gen, device, shape)
    g = torch.randn(args[0].shape, generator=gen).to(device)
    out = check_all(k, args, g, heads, shape)
    library = cuda_ms(sdpa_yardstick(args, heads))
    library_bwd = cuda_ms(sdpa_backward_yardstick(args, g, heads))
    bounds = {backward: bound_ms(args, backward) for backward in (False, True)}
    for name in NAMES:
        kernel = k[name]
        backward = "bwd" in name
        extra = (g,) if backward else ()
        m = out[name]
        m["ms"] = cuda_ms(lambda: kernel(*args, *extra, heads))
        m["plain_ms"] = cuda_ms(lambda: kernel.plain(*args, *extra, heads))
        m["library_ms"] = library_bwd if backward else library
        m["bound_ms"], m["bound_by"] = bounds[backward]
    return out


def describe(name: str, m: dict) -> str:
    share = (f" ({m['tol_share']:.2f} of tol)" if "tol_share" in m else "")
    return (f"{name}: err {m['max_abs_err']:.3e}{share} ms {m['ms']:.4f} plain "
            f"{m['plain_ms']:.4f} library {m['library_ms']:.4f} bound "
            f"{m['bound_ms']:.4f} ({m['bound_by']})")


def minibatch_agreement(trainer, batch) -> str:
    """Loss and gradients of one minibatch of ``batch`` through the trainer's
    kernels and through the plain versions."""
    upd = trainer.update_fn
    timeline, slots, fields = upd.prepare(batch)
    gen = torch.Generator(trainer.device).manual_seed(7)
    idx = torch.randperm(trainer.config.batch_size, generator=gen,
                         device=trainer.device)[:trainer.config.mini_batch_size]
    mb = upd.minibatch(fields, idx)
    results = []
    kernels = (upd.kernel, upd.backward_kernel)
    for fwd, bwd in (kernels, (None, None)):
        upd.kernel, upd.backward_kernel = fwd, bwd
        trainer.model.zero_grad(set_to_none=True)
        loss, _ = upd.loss(mb, timeline, slots, 0.1, 0.001)
        loss.backward()
        results.append((loss.detach(), [p.grad.detach().clone() for p in
                                        trainer.model.parameters()]))
    upd.kernel, upd.backward_kernel = kernels
    trainer.model.zero_grad(set_to_none=True)
    (loss_k, grads_k), (loss_p, grads_p) = results
    loss_err = abs(loss_k.item() - loss_p.item())
    grad_err = max((a - b).abs().max().item() for a, b in zip(grads_k, grads_p))
    grad_max = max(b.abs().max().item() for b in grads_p)
    if not math.isfinite(loss_k.item()):
        raise RuntimeError("minibatch loss is not finite")
    if (loss_err > LOSS_RTOL * max(1.0, abs(loss_p.item()))
            or grad_err > GRAD_RTOL * grad_max):
        raise RuntimeError(f"kernel path disagrees with the plain path: "
                           f"loss diff {loss_err}, grad diff {grad_err}")
    return (f"loss {loss_k.item():.6f} vs {loss_p.item():.6f}, max grad diff "
            f"{grad_err:.3e} of max grad {grad_max:.3e}")


def update_seconds(trainer, batch, pair) -> float:
    """Wall seconds of one PPO update on ``batch`` with the given (forward,
    backward) kernels (a backward of None: the plain VJP)."""
    upd = trainer.update_fn
    kept = upd.kernel, upd.backward_kernel
    upd.kernel, upd.backward_kernel = pair
    torch.cuda.synchronize()
    t = time.perf_counter()
    upd(batch, 1e-4, 0.1, 0.001)
    torch.cuda.synchronize()
    upd.kernel, upd.backward_kernel = kept
    return time.perf_counter() - t


def split_update(trainer, pairs: dict) -> tuple:
    """Times one more rollout, then one PPO update on its batch with each
    (forward, backward) pair of ``pairs`` in turns, forth and back (a, b, b,
    a). Returns (phase start, detail)."""
    t = time.perf_counter()
    _, batch = trainer.rollout_fn(trainer.rollout_state)
    torch.cuda.synchronize()
    rollout_s = time.perf_counter() - t
    turns = list(pairs) + list(pairs)[::-1]
    secs = [update_seconds(trainer, batch, pairs[name]) for name in turns]
    mean = {name: sum(s for n, s in zip(turns, secs) if n == name) / 2
            for name in pairs}
    return t, (f"rollout {rollout_s:.2f}s; ppo update in turns "
               + ", ".join(f"{n} {s:.3f}" for n, s in zip(turns, secs))
               + "s; mean " + ", ".join(f"{n} {m:.3f}s"
                                        for n, m in mean.items()))


def check_launches(kernels, expected: int, label: str) -> None:
    for k in kernels:
        if k.launches != expected:
            raise RuntimeError(f"{label}: {k.symbol} launched {k.launches} "
                               f"times, expected {expected}")


def run_flagship(device, k) -> list:
    """Phase 4: the MiniGrid flagship; returns the launches of the counted
    run, in the order of NAMES."""
    from etmppo_tpu_torch.config import MINIGRID_FLAGSHIP, config_from_dict
    from etmppo_tpu_torch.training.trainer import PPOTrainer
    t = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        config = dataclasses.replace(
            config_from_dict(MINIGRID_FLAGSHIP), updates=UPDATES,
            summary_dir=tmp, checkpoint_dir=tmp)
        if not config.pallas_backward:
            raise RuntimeError("the flagship config must use the backward "
                               "kernel")
        trainer = PPOTrainer(config, run_id="chip_smoke", device=device)
        fwd, bwd, fwd_g, bwd_g = (k[n] for n in NAMES)
        try:
            torch.cuda.synchronize()
            phase("trainer-setup", t)
            for kernel in k.values():
                kernel.launches = 0
            per_update = []
            for u in range(UPDATES):
                tu = time.perf_counter()
                stats = trainer.train_one_update()
                torch.cuda.synchronize()
                per_update.append(time.perf_counter() - tu)
                bad = {k: v for k, v in stats.items() if not math.isfinite(v)}
                if bad:
                    raise RuntimeError(f"update {u}: non-finite stats {bad}")
                check_launches((fwd, bwd), FLAGSHIP_LAUNCHES * (u + 1),
                               f"flagship update {u}")
                check_launches((fwd_g, bwd_g), 0, f"flagship update {u}")
                print(f"update {u}: {per_update[-1]:.2f}s "
                      f"loss {stats['loss']:.6f} entropy "
                      f"{stats['entropy']:.4f} value_loss "
                      f"{stats['value_loss']:.6f}", flush=True)
            launches = [k[n].launches for n in NAMES]
            steps = config.n_workers * config.worker_steps
            phase("trainer", t,
                  f"{UPDATES} updates, launches fwd {launches[0]} bwd "
                  f"{launches[1]}; s/update "
                  + " ".join(f"{s:.2f}" for s in per_update)
                  + f"; env-steps/s {steps / per_update[-1]:.0f} (update 2)")
            # After the counted run: the kernels against the plain versions
            # on one more rollout's data, and where an update's time goes.
            t = time.perf_counter()
            _, batch = trainer.rollout_fn(trainer.rollout_state)
            phase("trainer-check", t, minibatch_agreement(trainer, batch))
            phase("trainer-split", *split_update(trainer, {
                "plain backward": (fwd, None), "kernel backward": (fwd, bwd)}))
        finally:
            trainer.close()
    return launches


def _finite_csv(path: str) -> int:
    with open(path) as f:
        rows = list(csv.DictReader(f))
    for row in rows:
        bad = {k: v for k, v in row.items() if not math.isfinite(float(v))}
        if bad:
            raise RuntimeError(f"update {row['update']}: non-finite {bad}")
    return len(rows)


def _assert_same(a, b, where: str) -> None:
    """Bit-for-bit equality of nested dicts/lists of tensors and values."""
    if isinstance(a, torch.Tensor):
        if not torch.equal(a.cpu(), b.cpu()):
            raise RuntimeError(f"resume: {where} differs")
    elif isinstance(a, dict):
        if set(a) != set(b):
            raise RuntimeError(f"resume: {where} keys differ")
        for k in a:
            _assert_same(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (list, tuple)):
        for i, (x, y) in enumerate(zip(a, b, strict=True)):
            _assert_same(x, y, f"{where}/{i}")
    elif a != b:
        raise RuntimeError(f"resume: {where} differs ({a} vs {b})")


def run_mysterypath(device, k) -> list:
    """Phase 5: Mystery Path Grid through run_training with checkpoints,
    resume, and the saved model; returns the launches of the counted run, in
    the order of NAMES."""
    from etmppo_tpu_torch.config import MYSTERY_PATH_GRID, config_from_dict
    from etmppo_tpu_torch.training.checkpoint import load_model
    from etmppo_tpu_torch.training.trainer import PPOTrainer
    t = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        config = dataclasses.replace(
            config_from_dict(MYSTERY_PATH_GRID), updates=UPDATES,
            checkpoint_interval=1, summary_dir=tmp, checkpoint_dir=tmp)
        trainer = PPOTrainer(config, run_id="mpg", device=device)
        per_sample = (k[NAMES[0]], k[NAMES[1]])
        grouped = (k[NAMES[2]], k[NAMES[3]])
        torch.cuda.synchronize()
        phase("mysterypath-setup", t)
        t = time.perf_counter()
        for kernel in k.values():
            kernel.launches = 0
        result = trainer.run_training()
        launches = [k[n].launches for n in NAMES]
        check_launches(per_sample, MYSTERY_LAUNCHES * UPDATES, "mysterypath")
        check_launches(grouped, 0, "mysterypath")
        trainer.close()
        n_rows = _finite_csv(trainer.writer.csv_path)
        if n_rows != UPDATES:
            raise RuntimeError(f"mysterypath: {n_rows} logged updates")
        phase("mysterypath", t,
              f"{UPDATES} updates, launches fwd {launches[0]} bwd "
              f"{launches[1]}; env-steps/s {result['env_steps_per_second']:.0f}"
              f" (steady {result['env_steps_per_second_steady']:.0f})")

        t = time.perf_counter()
        resumed = PPOTrainer(config, run_id="mpg", device=device,
                             enable_metrics=False)
        if not resumed.resume_from_checkpoint() or resumed.update != UPDATES:
            raise RuntimeError(f"resume: at update {resumed.update}")
        _assert_same(resumed._training_state(), trainer._training_state(),
                     "state")
        for kernel in k.values():
            kernel.launches = 0
        stats = resumed.train_one_update()
        bad = {k: v for k, v in stats.items() if not math.isfinite(v)}
        if bad:
            raise RuntimeError(f"resumed update: non-finite stats {bad}")
        check_launches(per_sample, MYSTERY_LAUNCHES, "resumed update")
        model, _ = load_model(os.path.join(tmp, "mpg.nn"), device)
        _assert_same(model.state_dict(), trainer.model.state_dict(), "model")
        phase("mysterypath-resume", t,
              f"resumed at update {UPDATES} bit for bit; update {UPDATES} "
              f"loss {stats['loss']:.6f}; mpg.nn loads to the same weights")
        phase("mysterypath-split", *split_update(resumed, {
            "plain backward": (per_sample[0], None),
            "kernel backward": per_sample}))
    return launches


def update_drift(trainer, batch, pair, deterministic: bool = False) -> float:
    """Two PPO updates with the (forward, backward) ``pair`` from one state,
    on one batch and one set of permutations: the largest difference of a
    parameter between the two. With ``deterministic``, PyTorch's own
    operations run with ``torch.use_deterministic_algorithms`` (warn only)
    and ``cudnn.deterministic``, so that what is left comes from the
    window-attention kernels."""
    flags = (torch.are_deterministic_algorithms_enabled(),
             torch.backends.cudnn.deterministic)
    if deterministic:
        torch.use_deterministic_algorithms(True, warn_only=True)
        torch.backends.cudnn.deterministic = True
    upd = trainer.update_fn
    model_state = copy.deepcopy(trainer.model.state_dict())
    opt_state = copy.deepcopy(upd.optimizer.state_dict())
    cfg = trainer.config
    gen = torch.Generator(trainer.device).manual_seed(11)
    perms = torch.stack([torch.randperm(cfg.batch_size, generator=gen,
                                        device=trainer.device)
                         for _ in range(cfg.epochs)])
    kept = upd.kernel, upd.backward_kernel
    upd.kernel, upd.backward_kernel = pair
    after = []
    for _ in range(2):
        trainer.model.load_state_dict(model_state)
        upd.optimizer.load_state_dict(copy.deepcopy(opt_state))
        upd(batch, 1e-4, 0.1, 0.001, perms=perms)
        after.append([p.detach().clone() for p in trainer.model.parameters()])
    upd.kernel, upd.backward_kernel = kept
    trainer.model.load_state_dict(model_state)
    upd.optimizer.load_state_dict(opt_state)
    torch.use_deterministic_algorithms(flags[0], warn_only=True)
    torch.backends.cudnn.deterministic = flags[1]
    return max((a - b).abs().max().item() for a, b in zip(*after))


def run_mortarmayhem(device, k) -> list:
    """Phase 6: Mortar Mayhem Grid with the grouped kernels; returns the
    launches of the counted run, in the order of NAMES."""
    from etmppo_tpu_torch.config import MORTAR_MAYHEM_GRID, config_from_dict
    from etmppo_tpu_torch.training.checkpoint import load_model
    from etmppo_tpu_torch.training.trainer import PPOTrainer
    t = time.perf_counter()
    per_sample = (k[NAMES[0]], k[NAMES[1]])
    grouped = (k[NAMES[2]], k[NAMES[3]])
    with tempfile.TemporaryDirectory() as tmp:
        config = dataclasses.replace(
            config_from_dict(MORTAR_MAYHEM_GRID), updates=UPDATES,
            summary_dir=tmp, checkpoint_dir=tmp)
        trainer = PPOTrainer(config, run_id="mmg", device=device,
                             grouped=True)
        try:
            upd = trainer.update_fn
            if (upd.kernel, upd.backward_kernel) != grouped:
                raise RuntimeError("the Mortar Mayhem trainer must use the "
                                   "grouped kernels")
            trx = config.transformer
            max_ep = trainer.max_episode_steps
            shape = (config.n_workers, config.worker_steps, max_ep,
                     trx.memory_length, trx.embed_dim,
                     config.mini_batch_size)
            if shape != SHAPES["mortarmayhem"]:
                raise RuntimeError(f"mortarmayhem: kernel shape {shape}, "
                                   f"expected {SHAPES['mortarmayhem']}")
            torch.cuda.synchronize()
            phase("mortarmayhem-setup", t,
                  f"kernel shape B={config.mini_batch_size} "
                  f"W={config.n_workers} "
                  f"S={max_ep + config.worker_steps + trx.memory_length} "
                  f"P={max_ep} L={trx.memory_length} D={trx.embed_dim} "
                  f"H={trx.num_heads}")
            t = time.perf_counter()
            for kernel in k.values():
                kernel.launches = 0
            per_update = []
            for u in range(UPDATES):
                tu = time.perf_counter()
                stats = trainer.train_one_update()
                torch.cuda.synchronize()
                per_update.append(time.perf_counter() - tu)
                bad = {n: v for n, v in stats.items() if not math.isfinite(v)}
                if bad:
                    raise RuntimeError(f"update {u}: non-finite stats {bad}")
                check_launches(grouped, MORTAR_LAUNCHES * (u + 1),
                               f"mortarmayhem update {u}")
                check_launches(per_sample, 0, f"mortarmayhem update {u}")
                print(f"update {u}: {per_update[-1]:.2f}s "
                      f"loss {stats['loss']:.6f} entropy "
                      f"{stats['entropy']:.4f} value_loss "
                      f"{stats['value_loss']:.6f}", flush=True)
            launches = [k[n].launches for n in NAMES]
            trainer._save_model()
            model, _ = load_model(os.path.join(tmp, "mmg.nn"), device)
            _assert_same(model.state_dict(), trainer.model.state_dict(),
                         "model")
            steps = config.n_workers * config.worker_steps
            phase("mortarmayhem", t,
                  f"{UPDATES} updates, launches fwd_grouped {launches[2]} "
                  f"bwd_grouped {launches[3]}; s/update "
                  + " ".join(f"{s:.2f}" for s in per_update)
                  + f"; env-steps/s {steps / per_update[-1]:.0f} (update 2);"
                  " mmg.nn loads to the same weights")

            t = time.perf_counter()
            _, batch = trainer.rollout_fn(trainer.rollout_state)
            phase("mortarmayhem-check", t,
                  minibatch_agreement(trainer, batch))
            phase("mortarmayhem-split", *split_update(trainer, {
                "plain backward": (grouped[0], None),
                "per-sample pair": per_sample, "grouped pair": grouped}))
            t = time.perf_counter()
            drift = {(name, det): update_drift(trainer, batch, pair, det)
                     for det in (False, True) for name, pair in
                     (("per-sample pair", per_sample),
                      ("grouped pair", grouped))}
            phase("determinism", t,
                  "largest parameter difference between two PPO updates "
                  "from one state and batch: " + ", ".join(
                      f"{name} {d:.3e}" for (name, det), d in drift.items()
                      if not det) + "; with PyTorch's deterministic "
                  "algorithms: " + ", ".join(
                      f"{name} {d:.3e}" for (name, det), d in drift.items()
                      if det))
        finally:
            trainer.close()
    return launches


def main() -> int:
    start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    phase("device", start, f"{kind}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")

    from etmppo_tpu_torch.ops import window_attention as wa
    k = {name: getattr(wa, name) for name in NAMES}

    t = time.perf_counter()

    def timed_build(kernel):
        begin = time.perf_counter()
        existed = kernel.library_path().exists()
        path = kernel.build()
        return (f"{path.name} {time.perf_counter() - begin:.2f}s "
                f"({'reused' if existed else 'nvcc'})")
    with ThreadPoolExecutor(max_workers=len(k)) as pool:
        built = list(pool.map(timed_build, k.values()))
    phase("build", t, "; ".join(built))

    t = time.perf_counter()
    plans = {NAMES[0]: wa.forward_plan, NAMES[1]: wa.backward_plan}
    for name in NAMES:
        line = f"{name}: " + "; ".join(
            f"{r['function']} {r['registers']} registers, {r['spill_bytes']} "
            f"bytes spilled, {r['static_smem']} bytes static smem"
            for r in k[name].resources())
        if name in plans:
            planned = {shape: plans[name](*ldh)
                       for shape, ldh in plan_shapes().items()}
            fields = next(iter(planned.values()))._fields
            line += f"; plans ({', '.join(fields)}) " + ", ".join(
                f"{shape} {tuple(plan)}" for shape, plan in planned.items())
        print(line, flush=True)
    gen = torch.Generator().manual_seed(0)
    edge = {}
    for label in EDGE_CASES:
        args, heads = edge_inputs(gen, device, label)
        g = torch.randn(args[0].shape, generator=gen).to(device)
        edge[label] = check_all(k, args, g, heads, label)
        del args, g
    measured = {shape: measure_shape(k, gen, device, shape)
                for shape in SHAPES}
    phase("kernel", t, "; ".join(
        f"{label} err " + " ".join(f"{name} {m['max_abs_err']:.3e}"
                                   for name, m in errs.items())
        for label, errs in edge.items()) + "; " + "; ".join(
        f"{shape} {describe(name, m)}" for shape, by_name in measured.items()
        for name, m in by_name.items()))
    torch.cuda.empty_cache()

    launches = {"flagship": run_flagship(device, k)}
    torch.cuda.empty_cache()
    launches["mysterypath"] = run_mysterypath(device, k)
    torch.cuda.empty_cache()
    launches["mortarmayhem"] = run_mortarmayhem(device, k)

    entries = []
    for i, name in enumerate(NAMES):
        main_shape = measured[MAIN_SHAPE[name]][name]
        entries.append({
            "name": name, "route": "cuda",
            "source": os.path.relpath(k[name].source, os.getcwd()),
            "replaces": REPLACES[name],
            "launches": sum(v[i] for v in launches.values()),
            "launches_by_path": {p: v[i] for p, v in launches.items()},
            "max_abs_err": max(m[name]["max_abs_err"] for m in
                               list(edge.values()) + list(measured.values())),
            "ms": main_shape["ms"], "plain_ms": main_shape["plain_ms"],
            "bound_ms": main_shape["bound_ms"],
            "bound_by": main_shape["bound_by"],
            "library_ms": main_shape["library_ms"],
            "main_shape": MAIN_SHAPE[name],
            "by_shape": {shape: {key: m[name][key] for key in
                                 ("ms", "plain_ms", "bound_ms", "bound_by",
                                  "library_ms", "max_abs_err")}
                         for shape, m in measured.items()},
        })
    print(json.dumps({"kernels": entries}))
    phase("total", start)
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
