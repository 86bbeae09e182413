#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (etmppo_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one line with its seconds:

1. device:  requires a CUDA device; prints the card's name and power limit
            (nvidia-smi) and turns TF32 off for matmuls and convolutions.
2. build:   compiles the window-attention forward kernel with nvcc from
            etmppo_tpu_torch/csrc/ (skipped if the same source is built).
3. kernel:  holds the kernel against its plain PyTorch version at the
            flagship shape (B=1024, W=16, S=672, P=96, L=64, D=384, H=4) with
            windows from the port's own index math, and on a small case with
            all-masked rows and n_valid in {1, L}; times kernel, plain version,
            a gather + scaled_dot_product_attention yardstick, and the bound.
4. trainer: two PPO updates of the MiniGrid-Memory flagship at full width
            (16 workers x 512 steps, TrXL 3 x 384, 5 epochs x 8 minibatches);
            the kernel must launch exactly 120 times per update (3 blocks x 40
            minibatches), every stat must be finite, and the loss and
            gradients of one minibatch through the kernel must match those
            through the plain version.

Then it prints the kernel table as one JSON line and, last, the result line.
Any failure raises: the script exits non-zero and prints no result line.
"""
from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import tempfile
import time

import torch

KERNEL_SOURCE = "etmppo_tpu_torch/csrc/window_attention_fwd.cu"
KERNEL_REPLACES = "etmppo_tpu/ops/pallas_window_attention.py:151"
# fp32 outputs of magnitude ~1, summed in another order than the plain
# version: agreement to 1e-4 absolute leaves two orders of margin.
KERNEL_ATOL = 1e-4
# Loss and gradients of one minibatch, kernel vs plain forward: the
# difference enters through the attention outputs only (relative to the loss
# and to the largest gradient entry).
LOSS_RTOL = 1e-4
GRAD_RTOL = 1e-4
H100_BYTES_PER_S = 3.35e12     # HBM3, H100 SXM data sheet
H100_FP32_FLOPS = 67e12        # fp32 outside the tensor cores
UPDATES = 2
LAUNCHES_PER_UPDATE = 120


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


def flagship_inputs(gen: torch.Generator, device):
    """Kernel inputs at the flagship shape, with window sources from the
    port's index math over synthetic episodes of 16 workers x 512 steps."""
    from etmppo_tpu_torch.ops.memory_index import (build_memory_indices,
                                                   build_memory_mask,
                                                   compute_timeline_sources)
    W, T, max_ep, L, D, B = 16, 512, 96, 64, 384, 1024
    S = max_ep + T + L
    # Episodes of 10..96 steps; each worker starts mid-episode.
    steps = torch.empty(W, T, dtype=torch.int64)
    dones = torch.zeros(W, T, dtype=torch.bool)
    for w in range(W):
        e = int(torch.randint(0, 60, (1,), generator=gen))
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


def bound_ms(args, num_heads: int) -> tuple:
    """Least time for the work these inputs need: each distinct timeline and
    PE row read once (K and V), q and indices read, the output written;
    4*B*L*D flops (QK and PV)."""
    q, tk, _, pe_k, _, w_idx, start, n_valid, s_lo, mask = args
    B, D = q.shape
    W, S, _ = tk.shape
    L = mask.shape[1]
    offs = torch.arange(L, device=q.device)
    valid = offs[None] < n_valid[:, None]
    rows = (w_idx[:, None].long() * S + start[:, None] + offs[None])[valid]
    pe_rows = (s_lo[:, None] + offs[None])[~valid]
    n_rows = rows.unique().numel() + pe_rows.unique().numel()
    n_bytes = (2 * n_rows * D * 4 + 2 * B * D * 4 + 4 * B * 4 + B * L)
    flops = 4 * B * L * D
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


def check_kernel(kernel, plain, args, num_heads: int, label: str) -> float:
    out = kernel(*args, num_heads)
    torch.cuda.synchronize()
    ref = plain(*args, num_heads)
    if not torch.isfinite(out).all():
        raise RuntimeError(f"{label}: kernel output is not finite")
    err = (out - ref).abs().max().item()
    if err > KERNEL_ATOL:
        raise RuntimeError(f"{label}: kernel disagrees with the plain "
                           f"version: max_abs_err {err} > {KERNEL_ATOL}")
    return err


def minibatch_agreement(trainer, batch, plain) -> str:
    """Loss and gradients of one minibatch of ``batch`` through the kernel
    and through the plain version."""
    upd = trainer.update_fn
    timeline, slots, fields = upd.prepare(batch)
    gen = torch.Generator(trainer.device).manual_seed(7)
    idx = torch.randperm(trainer.config.batch_size, generator=gen,
                         device=trainer.device)[:trainer.config.mini_batch_size]
    mb = upd.minibatch(fields, idx)
    results = []
    kernel = upd.kernel
    for op in (kernel, plain):
        upd.kernel = op
        trainer.model.zero_grad(set_to_none=True)
        loss, _ = upd.loss(mb, timeline, slots, 0.1, 0.001)
        loss.backward()
        results.append((loss.detach(), [p.grad.detach().clone() for p in
                                        trainer.model.parameters()]))
    upd.kernel = kernel
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

    from etmppo_tpu_torch.config import MINIGRID_FLAGSHIP, config_from_dict
    from etmppo_tpu_torch.ops.window_attention import (window_attention_fwd,
                                                       window_attention_plain)
    from etmppo_tpu_torch.training.trainer import PPOTrainer

    t = time.perf_counter()
    existed = window_attention_fwd.library_path().exists()
    lib = window_attention_fwd.build()
    phase("build", t, f"{lib.name} ({'reused' if existed else 'nvcc'})")

    t = time.perf_counter()
    gen = torch.Generator().manual_seed(0)
    edge_args, heads = edge_inputs(gen, device)
    edge_err = check_kernel(window_attention_fwd, window_attention_plain,
                            edge_args, heads, "edge case")
    args, heads = flagship_inputs(gen, device)
    err = check_kernel(window_attention_fwd, window_attention_plain, args,
                       heads, "flagship shape")
    kernel_ms = cuda_ms(lambda: window_attention_fwd(*args, heads))
    plain_ms = cuda_ms(lambda: window_attention_plain(*args, heads))
    library = sdpa_yardstick(args, heads)
    lib_err = (library() - window_attention_plain(*args, heads)).abs().max()
    library_ms = cuda_ms(library)
    bound, bound_by = bound_ms(args, heads)
    phase("kernel", t,
          f"max_abs_err {err:.3e} (edge {edge_err:.3e}, tol {KERNEL_ATOL}); "
          f"kernel_ms {kernel_ms:.4f} plain_ms {plain_ms:.4f} "
          f"library_ms {library_ms:.4f} (sdpa err {lib_err:.1e}) "
          f"bound {bound * 1e3:.2f} us ({bound_by})")
    del args, edge_args, library

    t = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        config = dataclasses.replace(
            config_from_dict(MINIGRID_FLAGSHIP), updates=UPDATES,
            summary_dir=tmp, checkpoint_dir=tmp)
        trainer = PPOTrainer(config, run_id="chip_smoke", device=device)
        try:
            torch.cuda.synchronize()
            phase("trainer-setup", t)
            window_attention_fwd.launches = 0
            per_update = []
            for u in range(UPDATES):
                tu = time.perf_counter()
                stats = trainer.train_one_update()
                torch.cuda.synchronize()
                per_update.append(time.perf_counter() - tu)
                bad = {k: v for k, v in stats.items() if not math.isfinite(v)}
                if bad:
                    raise RuntimeError(f"update {u}: non-finite stats {bad}")
                if window_attention_fwd.launches != LAUNCHES_PER_UPDATE * (u + 1):
                    raise RuntimeError(
                        f"update {u}: {window_attention_fwd.launches} kernel "
                        f"launches, expected "
                        f"{LAUNCHES_PER_UPDATE * (u + 1)}")
                print(f"update {u}: {per_update[-1]:.2f}s "
                      f"loss {stats['loss']:.6f} entropy "
                      f"{stats['entropy']:.4f} value_loss "
                      f"{stats['value_loss']:.6f}", flush=True)
            launches = window_attention_fwd.launches
            steps = config.n_workers * config.worker_steps
            phase("trainer", t,
                  f"{UPDATES} updates, {launches} launches; s/update "
                  + " ".join(f"{s:.2f}" for s in per_update)
                  + f"; env-steps/s {steps / per_update[-1]:.0f} (update 2)")
            # One more rollout and update, timed apart (after the counted
            # run): where an update's time goes, and a check of the kernel
            # path against the plain path on this rollout's data.
            t = time.perf_counter()
            _, batch = trainer.rollout_fn(trainer.rollout_state)
            torch.cuda.synchronize()
            rollout_s = time.perf_counter() - t
            agreement = minibatch_agreement(trainer, batch,
                                            window_attention_plain)
            tu = time.perf_counter()
            trainer.update_fn(batch, 1e-4, 0.1, 0.001)
            torch.cuda.synchronize()
            update_s = time.perf_counter() - tu
            phase("trainer-check", t,
                  f"{agreement}; rollout {rollout_s:.2f}s, "
                  f"ppo update {update_s:.2f}s")
        finally:
            trainer.close()

    print(json.dumps({"kernels": [{
        "name": "window_attention_fwd", "route": "cuda",
        "source": KERNEL_SOURCE, "replaces": KERNEL_REPLACES,
        "launches": launches, "max_abs_err": max(err, edge_err),
        "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound,
        "bound_by": bound_by, "library_ms": library_ms}]}))
    phase("total", start)
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
