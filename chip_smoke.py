#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (etmppo_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one line with its seconds:

1. device:      requires a CUDA device; prints the card's name and power limit
                (nvidia-smi) and turns TF32 off for matmuls and convolutions.
2. build:       compiles the window-attention forward and backward kernels
                from etmppo_tpu_torch/csrc/, one nvcc process each, started
                together (a library built from the same source is reused).
3. kernel:      holds each kernel against its plain PyTorch version at the
                MiniGrid flagship shape (B=1024, W=16, S=672, P=96, L=64,
                D=384, H=4) and the Mystery Path Grid shape (B=2048, W=32,
                S=736, P=128, L=96, D=256, H=4), with windows from the port's
                own index math, and on a small case with all-masked rows and
                n_valid in {1, L}; times kernel, plain version, a library
                yardstick (gather + scaled_dot_product_attention, and for the
                backward autograd through that graph) and the bound.
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

Then it prints the kernel table as one JSON line and, last, the result line.
Any failure raises: the script exits non-zero and prints no result line.
"""
from __future__ import annotations

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
}
# Forward: fp32 outputs of magnitude ~1, summed in another order than the
# plain version: agreement to 1e-4 absolute leaves two orders of margin.
FWD_ATOL = 1e-4
# Backward: each gradient is compared relative to its own largest entry. The
# kernel adds into the timeline and PE tables with fp32 atomics, in an order
# that changes from run to run, and sums dq in another order than the plain
# VJP: 1e-5 of the largest entry leaves an order of margin over fp32 rounding
# of the few hundred terms that meet in one entry.
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
# (W, T, max_episode_steps, L, D, B) of the two configurations' minibatches.
SHAPES = {"flagship": (16, 512, 96, 64, 384, 1024),
          "mysterypath": (32, 512, 128, 96, 256, 2048)}


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


def edge_inputs(gen: torch.Generator, device):
    """Small case: all-masked rows, n_valid = 1 and n_valid = L."""
    B, W, S, P, L, D = 64, 4, 80, 24, 16, 384
    floats = [torch.randn(shape, generator=gen) for shape in
              ((B, D), (W, S, D), (W, S, D), (P, D), (P, D))]
    w_idx = torch.randint(0, W, (B,), generator=gen, dtype=torch.int32)
    start = torch.randint(0, S - L + 1, (B,), generator=gen, dtype=torch.int32)
    n_valid = torch.randint(1, L + 1, (B,), generator=gen, dtype=torch.int32)
    s_lo = torch.randint(0, P - L + 1, (B,), generator=gen, dtype=torch.int32)
    mask = torch.rand(B, L, generator=gen) < 0.7
    mask[:8] = False
    n_valid[0::3] = 1
    n_valid[1::3] = L
    args = [t.to(device).contiguous() for t in
            floats + [w_idx, start, n_valid, s_lo, mask]]
    return args, 4


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


def measure_shape(fwd, bwd, fwd_plain, bwd_plain, gen, device, shape):
    """Checks and times both kernels at one configuration's shape."""
    args, heads = window_inputs(gen, device, shape)
    g = torch.randn(args[0].shape, generator=gen).to(device)
    fwd_err = check_forward(fwd, fwd_plain, args, heads, shape)
    bwd_err, bwd_share = check_backward(bwd, bwd_plain, args, g, heads, shape)
    library = sdpa_yardstick(args, heads)
    library_bwd = sdpa_backward_yardstick(args, g, heads)
    out = {
        "window_attention_fwd": dict(
            max_abs_err=fwd_err,
            ms=cuda_ms(lambda: fwd(*args, heads)),
            plain_ms=cuda_ms(lambda: fwd_plain(*args, heads)),
            library_ms=cuda_ms(library)),
        "window_attention_bwd": dict(
            max_abs_err=bwd_err, tol_share=bwd_share,
            ms=cuda_ms(lambda: bwd(*args, g, heads)),
            plain_ms=cuda_ms(lambda: bwd_plain(*args, g, heads)),
            library_ms=cuda_ms(library_bwd))}
    for name, backward in (("window_attention_fwd", False),
                           ("window_attention_bwd", True)):
        out[name]["bound_ms"], out[name]["bound_by"] = bound_ms(args, backward)
    return out


def describe(name: str, m: dict) -> str:
    share = (f" ({m['tol_share']:.2f} of tol)" if "tol_share" in m else "")
    return (f"{name}: err {m['max_abs_err']:.3e}{share} ms {m['ms']:.4f} plain "
            f"{m['plain_ms']:.4f} library {m['library_ms']:.4f} bound "
            f"{m['bound_ms']:.4f} ({m['bound_by']})")


def minibatch_agreement(trainer, batch, fwd_plain) -> str:
    """Loss and gradients of one minibatch of ``batch`` through both kernels
    and through both plain versions."""
    upd = trainer.update_fn
    timeline, slots, fields = upd.prepare(batch)
    gen = torch.Generator(trainer.device).manual_seed(7)
    idx = torch.randperm(trainer.config.batch_size, generator=gen,
                         device=trainer.device)[:trainer.config.mini_batch_size]
    mb = upd.minibatch(fields, idx)
    results = []
    kernels = (upd.kernel, upd.backward_kernel)
    for fwd, bwd in (kernels, (fwd_plain, None)):
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


def update_seconds(trainer, batch, backward_kernel) -> float:
    """Wall seconds of one PPO update on ``batch`` with the given backward
    (None: the plain VJP)."""
    upd = trainer.update_fn
    kept = upd.backward_kernel
    upd.backward_kernel = backward_kernel
    torch.cuda.synchronize()
    t = time.perf_counter()
    upd(batch, 1e-4, 0.1, 0.001)
    torch.cuda.synchronize()
    upd.backward_kernel = kept
    return time.perf_counter() - t


def split_update(trainer, backward_kernel) -> tuple:
    """Times one more rollout, then one PPO update on its batch with the
    plain and the kernel backward in turns (plain, kernel, kernel, plain).
    Returns (phase start, detail)."""
    t = time.perf_counter()
    _, batch = trainer.rollout_fn(trainer.rollout_state)
    torch.cuda.synchronize()
    rollout_s = time.perf_counter() - t
    order = (None, backward_kernel, backward_kernel, None)
    secs = [update_seconds(trainer, batch, k) for k in order]
    return t, (f"rollout {rollout_s:.2f}s; ppo update (plain, kernel, kernel, "
               f"plain backward) " + " ".join(f"{s:.3f}" for s in secs)
               + f"s: plain {(secs[0] + secs[3]) / 2:.3f}s, kernel "
               f"{(secs[1] + secs[2]) / 2:.3f}s")


def check_launches(kernels, expected: int, label: str) -> None:
    for k in kernels:
        if k.launches != expected:
            raise RuntimeError(f"{label}: {k.symbol} launched {k.launches} "
                               f"times, expected {expected}")


def run_flagship(device, kernels, fwd_plain) -> tuple:
    """Phase 4: the MiniGrid flagship; returns (launches, phase detail)."""
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
        try:
            torch.cuda.synchronize()
            phase("trainer-setup", t)
            for k in kernels:
                k.launches = 0
            per_update = []
            for u in range(UPDATES):
                tu = time.perf_counter()
                stats = trainer.train_one_update()
                torch.cuda.synchronize()
                per_update.append(time.perf_counter() - tu)
                bad = {k: v for k, v in stats.items() if not math.isfinite(v)}
                if bad:
                    raise RuntimeError(f"update {u}: non-finite stats {bad}")
                check_launches(kernels, FLAGSHIP_LAUNCHES * (u + 1),
                               f"flagship update {u}")
                print(f"update {u}: {per_update[-1]:.2f}s "
                      f"loss {stats['loss']:.6f} entropy "
                      f"{stats['entropy']:.4f} value_loss "
                      f"{stats['value_loss']:.6f}", flush=True)
            launches = [k.launches for k in kernels]
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
            phase("trainer-check", t,
                  minibatch_agreement(trainer, batch, fwd_plain))
            phase("trainer-split", *split_update(trainer, kernels[1]))
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


def run_mysterypath(device, kernels) -> list:
    """Phase 5: Mystery Path Grid through run_training with checkpoints,
    resume, and the saved model; returns the launches of the counted run."""
    from etmppo_tpu_torch.config import MYSTERY_PATH_GRID, config_from_dict
    from etmppo_tpu_torch.training.checkpoint import load_model
    from etmppo_tpu_torch.training.trainer import PPOTrainer
    t = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        config = dataclasses.replace(
            config_from_dict(MYSTERY_PATH_GRID), updates=UPDATES,
            checkpoint_interval=1, summary_dir=tmp, checkpoint_dir=tmp)
        trainer = PPOTrainer(config, run_id="mpg", device=device)
        torch.cuda.synchronize()
        phase("mysterypath-setup", t)
        t = time.perf_counter()
        for k in kernels:
            k.launches = 0
        result = trainer.run_training()
        launches = [k.launches for k in kernels]
        check_launches(kernels, MYSTERY_LAUNCHES * UPDATES, "mysterypath")
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
        for k in kernels:
            k.launches = 0
        stats = resumed.train_one_update()
        bad = {k: v for k, v in stats.items() if not math.isfinite(v)}
        if bad:
            raise RuntimeError(f"resumed update: non-finite stats {bad}")
        check_launches(kernels, MYSTERY_LAUNCHES, "resumed update")
        model, _ = load_model(os.path.join(tmp, "mpg.nn"), device)
        _assert_same(model.state_dict(), trainer.model.state_dict(), "model")
        phase("mysterypath-resume", t,
              f"resumed at update {UPDATES} bit for bit; update {UPDATES} "
              f"loss {stats['loss']:.6f}; mpg.nn loads to the same weights")
        phase("mysterypath-split", *split_update(resumed, kernels[1]))
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

    from etmppo_tpu_torch.ops.window_attention import (
        window_attention_bwd, window_attention_bwd_plain, window_attention_fwd,
        window_attention_plain)
    kernels = (window_attention_fwd, window_attention_bwd)

    t = time.perf_counter()

    def timed_build(kernel):
        begin = time.perf_counter()
        existed = kernel.library_path().exists()
        path = kernel.build()
        return (f"{path.name} {time.perf_counter() - begin:.2f}s "
                f"({'reused' if existed else 'nvcc'})")
    with ThreadPoolExecutor(max_workers=len(kernels)) as pool:
        built = list(pool.map(timed_build, kernels))
    phase("build", t, "; ".join(built))

    t = time.perf_counter()
    gen = torch.Generator().manual_seed(0)
    edge_args, heads = edge_inputs(gen, device)
    edge_g = torch.randn(edge_args[0].shape, generator=gen).to(device)
    edge_fwd = check_forward(window_attention_fwd, window_attention_plain,
                             edge_args, heads, "edge case")
    edge_bwd, _ = check_backward(window_attention_bwd,
                                 window_attention_bwd_plain, edge_args,
                                 edge_g, heads, "edge case")
    measured = {shape: measure_shape(
        window_attention_fwd, window_attention_bwd, window_attention_plain,
        window_attention_bwd_plain, gen, device, shape) for shape in SHAPES}
    del edge_args, edge_g
    phase("kernel", t, f"edge err fwd {edge_fwd:.3e} bwd {edge_bwd:.3e}; "
          + "; ".join(f"{shape} {describe(name, m)}"
                      for shape, by_name in measured.items()
                      for name, m in by_name.items()))
    torch.cuda.empty_cache()

    launches = {"flagship": run_flagship(device, kernels,
                                         window_attention_plain)}
    torch.cuda.empty_cache()
    launches["mysterypath"] = run_mysterypath(device, kernels)

    entries = []
    for i, k in enumerate(kernels):
        name = k.symbol
        main_shape = measured["flagship"][name]
        entries.append({
            "name": name, "route": "cuda",
            "source": os.path.relpath(k.source, os.getcwd()),
            "replaces": REPLACES[name],
            "launches": sum(v[i] for v in launches.values()),
            "launches_by_path": {p: v[i] for p, v in launches.items()},
            "max_abs_err": max([edge_fwd, edge_bwd][i], *(
                m[name]["max_abs_err"] for m in measured.values())),
            "ms": main_shape["ms"], "plain_ms": main_shape["plain_ms"],
            "bound_ms": main_shape["bound_ms"],
            "bound_by": main_shape["bound_by"],
            "library_ms": main_shape["library_ms"],
            "mysterypath_shape": {
                key: measured["mysterypath"][name][key] for key in
                ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
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
