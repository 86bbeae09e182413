#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (etmppo_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one line with its seconds:

1. device:      requires a CUDA device; prints the card's name and power limit
                (nvidia-smi). The script sets no precision flag itself: the
                package's entry points turn TF32 off for matmuls and
                convolutions (utils/runtime.py), and the script checks both
                flags off after it builds the first trainer and again before
                its result line.
2. build:       compiles the four window-attention kernels from
                etmppo_tpu_torch/csrc/ (the per-sample forward and backward,
                the grouped forward and backward) and the two reset kernels,
                Mystery Path Grid's (mystery_path_reset.cu) and Mortar
                Mayhem Grid's (mortar_mayhem_reset.cu), one nvcc process each,
                started together (a library built from the same source is
                reused).
3. kernel:      prints each kernel's registers, spills and static shared
                memory (nvcc's -Xptxas -v report) and the four kernels'
                launch plans. Holds each kernel against its plain
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
                4-byte copies and scalar atomics); a minibatch all of one
                worker; and the grouped kernels' runs: all samples at one
                start, a worker with three samples far apart, a worker of 13
                samples. Two calls of the grouped backward must give the
                same bits, and the grouped kernels' sort on the card must
                be the stable (worker, start) sort. The same at the
                Searing Spotlights shape (B=2048, W=32, S=864, P=256, L=96,
                D=256, H=4) and at headroom_768.yaml's (B=2048, W=32,
                S=736, P=128, L=96, D=768, H=6). Times kernel, plain
                version, a library yardstick (gather +
                scaled_dot_product_attention, and for the backward autograd
                through that graph) and the bound. reset-kernel: Mystery
                Path Grid's auto-reset kernel (envs/mystery_path.py's
                MysteryPathReset) against TorchEnv.reset_done's default
                path, bit for bit, at W=32 on the flagship's reset params
                (S=7) and with origin and goal shown (S=9): 200 steps of
                random actions, each reset with an all-false, an all-true
                and a random mask; then, with a quarter of the workers done,
                the kernel, the default path, a library copy of the same
                state and frame (clone) and the bound by bytes, each timed
                inside a CUDA graph, as the rollout runs them.
                mortar-reset-kernel: the same for Mortar Mayhem Grid's
                auto-reset kernel (envs/mortar_mayhem.py's
                MortarMayhemReset), fed the uniforms of the reset draws, on
                the flagship's reset params (arena 5, 5 allowed commands,
                10 a reset) and with diagonals (arena 7, 9 allowed, 6 a
                reset): 200 steps x 3 masks each, then the four timings
                with 0, 1, 8 and 32 of the 32 workers done.
4. trainer:     two PPO updates of the MiniGrid-Memory flagship exactly as its
                YAML says (pallas_backward: true) at full width (16 workers x
                512 steps, TrXL 3 x 384, 5 epochs x 8 minibatches); each kernel
                must launch exactly 120 times per update (3 blocks x 40
                minibatches) and every stat must be finite. The second
                update runs under utils/profiling.trace (torch.profiler):
                trainer-busy prints the device busy share of that update
                (the union of the card's kernel, copy and memset intervals
                over its wall time), of its rollout and of its PPO update
                (split where the host enters the update), and the same
                busy seconds over the untraced times of trainer-split, as
                pocmemory-busy does for PocMemory. Then, on one more
                rollout, the loss and gradients of one minibatch through both
                kernels must match those through both plain versions; and one
                more rollout and PPO update are timed apart, the update with
                the plain and the kernel backward in turns.
5. mysterypath: two PPO updates of the Mystery Path Grid flagship at full
                width (32 workers x 512 steps, TrXL 2 x 256, memory 96, 3
                epochs x 8 minibatches) through run_training, checkpointing
                every update, so in fused launches of one update (the first
                eager, then the graph's capture; the second a replay); each
                kernel must launch exactly 48 times per update (a replay's
                launches counted) and the reset kernel 512 times per update
                (one launch a rollout step), and every logged stat must be
                finite; the steady rate leaves out the first launch. A fresh
                trainer resumes from the checkpoint bit for bit and takes one
                more finite update (512 reset launches); the saved .nn loads
                back to the same weights.
                Then one more rollout and PPO update are timed apart, the
                update with the plain and the kernel backward in turns.
6. mortarmayhem: two PPO updates of the Mortar Mayhem Grid flagship exactly
                as its YAML says (32 workers x 512 steps, TrXL 3 x 384,
                memory 118, 3 epochs x 8 minibatches) with the grouped
                kernels (PPOTrainer(..., grouped=True)); each grouped kernel
                must launch exactly 72 times per update (3 blocks x 24
                minibatches), the per-sample ones never, the env's reset
                kernel 512 times per update (one launch a rollout step),
                every stat must be finite, and the saved .nn must load back
                to the same weights.
                Prints the kernel shape the trainer gives. Then one more
                rollout, and the PPO update on its batch in turns with the
                plain backward, the per-sample pair and the grouped pair
                (mortarmayhem-split); and, from one state and batch, two
                updates with each pair (determinism): the largest parameter
                difference between the two, reported (cuDNN and the
                timeline-gather backward may still differ in the last bits),
                then again with PyTorch's deterministic algorithms and
                cuDNN's deterministic mode on, where the grouped pair's two
                updates must give the same bits; with the mean seconds of an
                update in each setting.
7. searingspotlights: two PPO updates of Searing Spotlights exactly as its
                YAML says (32 workers x 512 steps, TrXL 2 x 256, memory 96,
                3 epochs x 8 minibatches, both kernels of the per-sample
                pair); each must launch exactly 48 times per update, the
                grouped ones never; the saved .nn must load back to the same
                weights. Then, on one more rollout, the loss and gradients of
                one minibatch through the kernel pair must match those of the
                gathered-window path (plain PyTorch); and the PPO update is
                timed with the plain and the kernel backward in turns.
8. pocmemory:   4 PPO updates of PocMemory exactly as its YAML says (16
                workers x 128 steps, GTrXL 4 x 64, 4 epochs x 8 minibatches)
                on the gathered-window loss, no kernel launched; prints the
                steady env-steps/s, the success the 4th update reached
                (printed, not checked: the CPU test holds the bar), and one
                more rollout and PPO update timed apart.
9. cartpole:    three PPO updates of masked-velocity CartPole exactly as its
                YAML says (16 workers x 256 steps, GTrXL 4 x 128, 4 epochs x
                4 minibatches), the same way.
10. serve:      PolicyServer with 64 streams of the committed MiniGrid
                flagship (models/minigrid-r3_s0.nn: CNN on 84x84x3, TrXL 3 x
                384, memory 64) and of Mortar Mayhem Grid (mmg-full.nn,
                memory 118), greedy: 12 (6) steps on the env's observations,
                with a reset of some streams mid-run and an inactive mask,
                held against the raw-memory formulation (model.forward over
                memory[index_table[t]]): actions equal, values within
                SERVE_RTOL; step_many over 16 steps against 16 step_device
                calls from the same state; one step_device with every stream
                at t == max_episode_steps (the clamped window and PE slot).
                Prints policy-steps/s (streams x steps / s) over 1,000 steps
                of each of step (a host sync per step), step_device (no sync
                but the reset's every 50 steps) and step_many (50 steps a
                call), the FLOPs of a step (counted_flops) and its MFU; serve-busy traces 20 step_device calls and
                prints the device's busy share, kernels per step and the
                operators with the most device time.
11. evaluate:   evaluate_protocol over models/minigrid-r3_s0..s4.nn, 50
                episodes x 1 repeat each: the cross-seed success IQM must be
                1.0 and the reward IQM within 0.02 of 0.9685 (RESULTS.md's
                task result, not a speed); prints the CI, the seconds and
                episodes/s.
12. enjoy:      run_episodes on the flagship with rendering: the GIF must
                start with GIF89a and hold episode length + 1 images
                (counted by walking its blocks).
13. serve-http: serve() with 64 streams of the flagship on an ephemeral
                port in a thread: /info, /reset, a binary /step and a binary
                /step_many (X-T) must answer as a local PolicyServer in the
                same state; prints requests/s and policy-steps/s over the
                wire.
14. native:     PocMemory and masked CartPole exactly as their YAMLs say but
                with the native C++ env engine (PocMemoryEnv-native,
                CartPoleMasked-native; csrc/env_batch.cpp, built by g++
                into etmppo_tpu_torch/_build/, its seconds printed),
                three PPO updates each through PPOTrainer and the host
                rollout, the second traced, as phases 8 and 9 (no kernel
                may launch, stats finite): steady env-steps/s beside the
                device env's of phases 8 and 9, rollout and update seconds,
                busy share, success; and a probe: the engine's step alone
                with its threads and with one, and the device activities
                with the most time in the traced rollout.
15. host-pool:  the process pool (envs/host.py) over StubGridEnv, a
                deterministic, action-independent numpy env at the MiniGrid
                flagship's shape (84x84x3, 3 actions, episodes of 65-96
                steps), forked after the card's first use, driven by the
                host rollout at the flagship's full width (16 x 512, TrXL 3
                x 384, memory 64): serial (1 group) and pipelined (2 groups)
                in turns, held against each other and the serial one against
                the device rollout over StubGridTwin (the same dynamics on
                the card): obs, dones and episode steps equal, values and
                tape within 1e-4 relative / 1e-5 absolute, advantages within
                1e-4; prints each rollout's seconds and the busy share of a
                traced pipelined rollout; then one PPO update on the host
                batch with the kernel pair (120 launches of each).
16. headroom:   headroom_768.yaml at full width (Mystery Path Grid, 32 x
                512, TrXL 2 x 768, 6 heads of 128, memory 96, 3 epochs x 8
                minibatches of 2048): two updates as the YAML says (float32),
                then two with compute_dtype: bfloat16; B1 and B2 must launch
                exactly 48 times per update in both, B3/B4 never, every stat
                must be finite and every parameter float32. The bf16 run's
                second update is traced (busy share). On one more bf16
                rollout, one minibatch's loss and gradients through the
                kernel pair must match those through the plain versions
                (the same float32 casts around both) within twice the
                distance of bfloat16 from float32 (a float32 copy of the
                model) plus a bfloat16 ulp. Then one more rollout of each
                and the PPO update in turns fp32, bf16, bf16, fp32; one more
                PPO update of each traced with input shapes (its busy share
                and the device ms of aten::copy_ on (W, S, D) tensors); the
                boundary casts
                timed alone at their shapes; the update's FLOPs and MFU in
                both dtypes. The bf16 run's .nn is served with 64 streams
                for 12 steps, held against its raw-memory formulation
                (values within 2^-5, actions equal away from near ties); no
                kernel may launch there.
17. obs-uint8:  the MiniGrid flagship with obs_uint8: true at full width
                beside the same config with float obs: the batch obs must be
                uint8 and equal round(obs * 255).clamp(0, 255) of the float
                run's rollout from the same seeds (bytes printed); two
                updates (120 launches of B1 and B2 each), the first update's
                stats within 5% + 1e-3 of the float run's on the obs the
                uint8 run reads back (quantized, divided by 255); then one more
                rollout of each and the PPO update in turns (float, uint8,
                uint8, float).
18. debug-nans: utils/runtime.set_debug_nans (the CLI's --debug-nans) on
                the flagship: an unchecked update, then one under the checks
                (stats finite, 120 launches of each), their seconds
                printed; then a NaN learning rate must raise
                FloatingPointError within its first update, and no check
                may outlive the phase.
19. data-parallel: the MiniGrid flagship at full width (16 x 512, TrXL 3 x
                384, 5 epochs x 8 minibatches) on two ranks that share the
                card, spawned with gloo named (parallel/mesh.spawn; NCCL
                refuses two ranks on one card), 8 workers each, two updates;
                beside it a one-device trainer of the same seed in this
                process. Each rank must launch B1 and B2 120 times an update
                on its part of each minibatch, the ranks' parameters must be
                bit-identical after each update, and update 1 must agree
                with the one-device run. Its ranks take the one-device run's
                actions (parallel/probe.Replay), so its batch is one
                device's by construction; the actions each rank draws itself
                (as an unreplayed rank would) must equal one device's except
                at near ties (a Gumbel-max margin under DP_TIE_ATOL), the
                values within DP_VALUE_RTOL; the first minibatch's clipped
                gradients within GRAD_RTOL of the largest, and after the
                update the stats within DP_STATS_TOL and the parameters
                within 2 lr a step. Before the ranks,
                data-parallel-known-wrong reads those limits for the
                data-parallel update and two known-wrong ones (local
                advantage statistics; no all-reduce), emulated on one
                device: the first must hold the gradient and parameter
                limits (its stats are read), each wrong one break one.
                Rank 0's .nn must reload to its parameters. Prints each
                rank's rollout and PPO update seconds and the ms and bytes
                of its per-minibatch all-reduce and per-update gathers
                beside the one-device run's seconds (two ranks sharing one
                card is not a scaling number). Then one Mortar Mayhem Grid
                update with the grouped pair on the same ranks (72 launches
                of B3 and B4 each a rank, bit-identical). Where the call has
                two or more cards, the flagship at N = 1, 2 and 4 with NCCL,
                a rank a card, 3 updates each: steady env-steps/s (updates
                2-3).
20. fused:      fused launches (training/fused.py) on the graph route: a
                CUDA graph of a whole update, captured after an eager
                warm-up update and replayed. (a) The MiniGrid flagship with
                the grouped pair under PyTorch's deterministic algorithms
                (their NaN fill of new tensors off):
                an eager trainer's 6 updates and a fused trainer's 2
                launches of 3 from the same seed must give the same actions
                and logged values and, after each launch, the same
                parameters, optimizer state, rollout state and generators,
                to the bit; B3 and B4 counted 120 times an update on the
                replays. (d) A
                trainer resumed from the checkpoint of launch 1 runs launch
                2 to the same bits. (b) The flagship as its YAML says (the
                per-sample pair): 2 launches of 3; B1 and B2 counted 720
                times each, and 120 times each by name in a profiler trace
                of one replayed update (and its device busy share, beside
                trainer-busy's eager one); stats finite; update 1's actions
                equal an eager trainer's. (c) Mystery Path Grid (grouped)
                and PocMemory: a launch of 3 equal to 3 eager updates to
                the bit, deterministic algorithms on. Then Searing
                Spotlights and masked CartPole must capture and replay (a
                launch of 2, stats finite). Prints each
                graph's capture and instantiation seconds, nodes and pool
                bytes, the first launch's seconds and launch 2's s/update
                and env-steps/s beside the eager trainer's.
21. fused-mesh: the graph route under a mesh (training/fused.py's
                segments, replayed with the collectives between them), on
                phase 19's two gloo ranks, in the same spawn; its lines
                follow phase 19's. (a) The flagship with the grouped pair
                under deterministic algorithms: on each rank 2 launches of
                2 on the graph route against 2 on the eager route from the
                same seed (parallel/probe.fused_against_eager): the same
                actions, logged values and episode infos and, after each
                launch, parameters, optimizer state, rollout state and
                generators, to the bit; B3 and B4 counted 240 a launch
                (120 an update on the replays); the same collectives; the
                ranks bit-identical. (c) Then rank 1 flips a bit of a
                parameter after update 1 of a launch of 2: the launch must
                raise naming update 2. (b) The flagship as its YAML says
                (the per-sample pair): one launch of 4, update 1 on the
                one-device run's actions; B1 and B2 counted 480 a rank;
                update 1 within phase 19's limits of the one-device run;
                rank 0 traces one more replayed update (its own kernels'
                busy time in the rollout and the PPO update). Prints each
                segment's nodes, pool and capture seconds. After phase 20,
                fused-mesh-rate prints a rank's replayed update beside an
                eager mesh update and one device's replay (phase 20 (a)).
                Where the call has two or more cards, data-parallel-scaling
                also runs the graph route at N = 1, 2 and 4 (two launches
                of 2; the steady env-steps/s of launch 2).
22. phase-clock: the trainer's phase clock (utils/profiling.PhaseClock,
                csrc/phase_stamp.cu) at the three benchmark flagships,
                MiniGrid-Memory, Mystery Path Grid and Mortar Mayhem Grid
                (the last on the grouped pair, as its cell runs it), as
                their YAMLs say (launches of 4): a trainer with the clock
                off and one with it on, whose graph must hold the off
                graph's nodes plus one per stamp; their steady launches by
                the host clock, 3 each in turns; then a launch whose replays
                CUDA events time: each update span must agree with its
                replay's events within 1%, and the capture record must count
                512 reset-kernel launches an update at Mystery Path Grid and
                Mortar Mayhem Grid and none at the MiniGrid flagship.
                Prints each phase's median over the launch's updates, the
                launch's host spans, its idle time (the launch's host
                seconds less its updates' spans) and 4 x (rollout +
                ppo_update + outputs) + idle against the clock-off launch.
                ``python3 chip_smoke.py phase-clock [NAME ...]`` runs the
                device line, this phase and, per flagship, 3 processes with
                the clock off and 3 with it on, in turns, each timing its
                steady launches (the clock's cost in env-steps/s, with the
                spread), at the flagships named (of CLOCK_FLAGSHIPS) or at
                all three.
No window-attention kernel may launch in phases 10-14. The flagship phase
(4) also prints flagship-mfu: the FLOPs of a PPO update (counted_flops of
one minibatch's forward and backward, plus window_attention_flops for the
kernel pair, times the minibatches) over its measured seconds.

Then it prints the kernel table as one JSON line and, last, the result line.
Any failure raises: the script exits non-zero and prints no result line.
"""
from __future__ import annotations

import contextlib
import copy
import csv
import dataclasses
import io
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple

import numpy as np
import torch

from etmppo_tpu_torch.envs.core import TorchEnv

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
SEARING_LAUNCHES = 48          # per update: 2 blocks x 3 epochs x 8 minibatches
# PocMemory's run: its success is printed, not checked (the CPU test holds
# the bar in 30 updates); cut from 30 as phases 16-18 came in, and from 6
# as phase 20 did.
POC_UPDATES = 4
# Serving (phases 10-13), on committed artifacts under models/.
ROOT = os.path.dirname(os.path.abspath(__file__))
FLAGSHIP_NN = "minigrid-r3_s0.nn"
SERVE_STREAMS = 64
SERVE_MODELS = ((FLAGSHIP_NN, 12), ("mmg-full.nn", 6))   # (file, held steps)
SERVE_MANY_STEPS = 16
SERVE_TIMED_STEPS = 1000       # timed per entry point, a few seconds each
SERVE_RESET_EVERY = 50         # steps; under every artifact's episode length
# Served values against the raw-memory formulation, relative to the largest
# value: the same float32 products in other shapes and orders (the K/V of a
# memory item projected once, or again inside the forward).
SERVE_RTOL = 1e-4
HTTP_STEPS = 200               # binary /step requests timed
HTTP_MANY = (40, 8)            # binary /step_many requests timed, T each
EVAL_MODELS = tuple(f"minigrid-r3_s{i}.nn" for i in range(5))
EVAL_EPISODES = 50
# The MiniGrid flagship's 5-seed task result (RESULTS.md:39: cross-seed
# success IQM 1.0, reward IQM 0.9685 over 1,250 episodes); one repeat of 50
# episodes per seed must land within EVAL_REWARD_TOL of it.
EVAL_REWARD_IQM = 0.9685
EVAL_REWARD_TOL = 0.02
# (W, T, max_episode_steps, L, D, B) of the minibatches of the five
# configurations that run the kernels, with 4 heads but where HEADS says.
SHAPES = {"flagship": (16, 512, 96, 64, 384, 1024),
          "mysterypath": (32, 512, 128, 96, 256, 2048),
          "mortarmayhem": (32, 512, 120, 118, 384, 2048),
          "searingspotlights": (32, 512, 256, 96, 256, 2048),
          "headroom": (32, 512, 128, 96, 768, 2048)}
HEADS = {"headroom": 6}
# The kernels, and the configuration whose path launches each.
NAMES = ("window_attention_fwd", "window_attention_bwd",
         "window_attention_fwd_grouped", "window_attention_bwd_grouped")
MAIN_SHAPE = {"window_attention_fwd": "flagship",
              "window_attention_bwd": "flagship",
              "window_attention_fwd_grouped": "mortarmayhem",
              "window_attention_bwd_grouped": "mortarmayhem"}
# The port's own kernel beside them: Mystery Path Grid's auto-reset, held
# against TorchEnv.reset_done's default path at W workers for the reset
# params of RESET_CASES (the first is the flagship's: its main shape).
RESET_NAME = "mystery_path_reset"
RESET_REPLACES = ("no pallas_call: the JAX rollout's auto-reset, "
                  "etmppo_tpu/training/rollout.py:127-134 (every worker's "
                  "env.reset kept by jnp.where)")
RESET_CASES = {"flagship S7": None,      # MYSTERY_PATH_GRID's reset params
               "shown S9": {"arena_size": 9, "cardinal_origin_choice": [1, 3],
                            "show_origin": True, "show_goal": True,
                            "reward_fall_off": -0.1,
                            "reward_path_progress": 0.05}}
RESET_WORKERS = 32
RESET_STEPS = 200
RESET_TIMED_SHARE = 0.25       # of the workers done at a timed call
MYSTERY_RESETS = 512           # per update: one launch a rollout step
# Mortar Mayhem Grid's auto-reset kernel, held the same way on the reset
# params of MORTAR_RESET_CASES, and timed with each number of workers done.
MORTAR_RESET_NAME = "mortar_mayhem_reset"
MORTAR_RESET_CASES = {"flagship A5": None,   # MORTAR_MAYHEM_GRID's params
                      "diagonal A7": {"arena_size": 7, "allowed_commands": 9,
                                      "command_count": [4, 6],
                                      "explosion_duration": [3],
                                      "explosion_delay": [4]}}
MORTAR_RESET_DONE = (0, 1, 8, 32)
MORTAR_RESETS = 512            # per update: one launch a rollout step


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


def graph_ms(fn, iters: int = 20, replays: int = 5) -> float:
    """Device ms per call of ``fn``: ``iters`` calls captured into one CUDA
    graph, as the rollout runs them, the graph replayed ``replays`` times
    between CUDA events (no host launch cost in the time)."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    begin = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    begin.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return begin.elapsed_time(end) / (iters * replays)


def _bit_mismatches(got, want) -> torch.Tensor:
    """Elements of ``got`` (a tensor or a tuple of them) whose bits differ
    from ``want``'s, as a device tensor (no sync)."""
    if isinstance(want, tuple):
        return sum(_bit_mismatches(a, b) for a, b in zip(got, want))
    if got.dtype != want.dtype or got.shape != want.shape:
        raise RuntimeError(f"reset-kernel: {got.dtype} {tuple(got.shape)} "
                           f"against {want.dtype} {tuple(want.shape)}")
    if want.is_floating_point():
        got, want = got.view(torch.int32), want.view(torch.int32)
    return (got != want).sum()


def reset_bound_ms(mask, draws, state, obs) -> float:
    """Least time of one reset call by bytes: every output written, the
    state and frame rows of the workers not done read, the draws of those
    done and the mask read."""
    W = mask.shape[0]
    done = int(mask.sum())
    out = sum(x.numel() * x.element_size() for x in (*state, obs))
    drawn = sum(x.numel() * x.element_size() for x in draws)
    n_bytes = out + out * (W - done) / W + drawn * done / W + mask.numel()
    return n_bytes / H100_BYTES_PER_S * 1e3


def hold_reset(env, g: torch.Generator, label: str) -> tuple:
    """RESET_STEPS steps of random actions from a reset, each followed by
    the env's reset with an all-false, an all-true and a random mask (the
    dones and a random quarter): the kernel's state and frame must equal
    ``TorchEnv.reset_done``'s default path, bit for bit, with one launch a
    call. Returns the last state and frame, the calls checked and the
    random-mask resets."""
    W = env.n_workers
    kernel = env.reset_kernel
    kernel.launches = 0
    state, obs = env.reset(env.sample_reset_draws(g))
    zeros = torch.zeros(W, dtype=torch.bool, device=env.device)
    bad, ended = [], 0
    for _ in range(RESET_STEPS):
        actions = torch.randint(0, env.action_branches[0], (W, 1),
                                generator=g, device=env.device)
        state, obs, _, done, _ = env.step(state, actions)
        rand = done | (torch.rand(W, generator=g, device=env.device) < 0.25)
        for mask in (zeros, ~zeros, rand):
            draws = env.sample_reset_draws(g)
            want = TorchEnv.reset_done(env, mask, draws, state, obs)
            got = env.reset_done(mask, draws, state, obs)
            bad.append(_bit_mismatches(got, want))
        ended += rand.sum()
        state, obs = got
    bad = torch.stack(bad).cpu()
    checked = kernel.launches
    if bad.any() or checked != 3 * RESET_STEPS:
        first = int(bad.nonzero()[0, 0]) if bad.any() else -1
        raise RuntimeError(
            f"{label}: {int(bad.sum())} elements differ from the default "
            f"path (first at call {first}), {checked} launches for "
            f"{3 * RESET_STEPS} calls")
    return state, obs, checked, int(ended)


def time_reset(env, mask, draws, state, obs) -> dict:
    """The kernel, the default path, a library copy of the state and frame
    (clone) and the bound by bytes, each timed inside a CUDA graph."""
    m = dict(timed_done=int(mask.sum()))
    m["ms"] = graph_ms(lambda: env.reset_done(mask, draws, state, obs))
    m["plain_ms"] = graph_ms(
        lambda: TorchEnv.reset_done(env, mask, draws, state, obs))
    m["library_ms"] = graph_ms(lambda: [x.clone() for x in (*state, obs)])
    m["bound_ms"], m["bound_by"] = (
        reset_bound_ms(mask, draws, state, obs), "bytes")
    return m


def measure_reset(device, gen: torch.Generator) -> dict:
    """Mystery Path Grid's reset kernel against the default path, bit for
    bit, then timed (kernel, default path, library copy, bound), for each
    of RESET_CASES."""
    from etmppo_tpu_torch.config import MYSTERY_PATH_GRID
    from etmppo_tpu_torch.envs.mystery_path import MysteryPathGridEnv
    out = {}
    for case, params in RESET_CASES.items():
        params = params or MYSTERY_PATH_GRID["environment"]["reset_params"]
        env = MysteryPathGridEnv(params, RESET_WORKERS, device)
        g = torch.Generator(device).manual_seed(
            int(torch.randint(0, 2 ** 31, (1,), generator=gen)))
        state, obs, checked, ended = hold_reset(env, g,
                                                f"reset-kernel, {case}")
        mask = torch.rand(RESET_WORKERS, generator=g,
                          device=device) < RESET_TIMED_SHARE
        draws = env.sample_reset_draws(g)
        m = dict(max_abs_err=0.0, mismatched_elements=0, checked=checked,
                 ended=ended, launches=checked)
        m.update(time_reset(env, mask, draws, state, obs))
        out[case] = m
        del env, state, obs
    return out


def measure_mortar_reset(device, gen: torch.Generator) -> dict:
    """Mortar Mayhem Grid's reset kernel against the default path, bit for
    bit, for each of MORTAR_RESET_CASES; then, at each of MORTAR_RESET_DONE
    workers done, timed as ``measure_reset`` times its kernel."""
    from etmppo_tpu_torch.config import MORTAR_MAYHEM_GRID
    from etmppo_tpu_torch.envs.mortar_mayhem import MortarMayhemGridEnv
    out = {}
    for case, params in MORTAR_RESET_CASES.items():
        params = params or MORTAR_MAYHEM_GRID["environment"]["reset_params"]
        env = MortarMayhemGridEnv(params, RESET_WORKERS, device)
        g = torch.Generator(device).manual_seed(
            int(torch.randint(0, 2 ** 31, (1,), generator=gen)))
        state, obs, checked, ended = hold_reset(
            env, g, f"mortar-reset-kernel, {case}")
        m = dict(max_abs_err=0.0, mismatched_elements=0, checked=checked,
                 ended=ended, launches=checked, by_done={})
        draws = env.sample_reset_draws(g)
        order = torch.randperm(RESET_WORKERS, generator=g, device=device)
        for n_done in MORTAR_RESET_DONE:
            mask = torch.zeros(RESET_WORKERS, dtype=torch.bool, device=device)
            mask[order[:n_done]] = True
            m["by_done"][n_done] = time_reset(env, mask, draws, state, obs)
        m.update(m["by_done"][MORTAR_RESET_DONE[-2]])
        out[case] = m
        del env, state, obs
    return out


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
    return args, HEADS.get(shape, 4)


# Small cases, (B, W, S, P, L, D, H, layout): the MiniGrid flagship's width
# on a short window; the same with every sample of worker 1 ("one worker");
# headroom_768.yaml's kernel shape (L=96, D=768, H=6, head width 128) at a
# small batch; a head width that is not a multiple of 4 (D=40, H=4: 10); a
# width that is not a multiple of 4 (D=30, H=3), where the per-sample kernels
# take their 4-byte copies and the backward its scalar atomics; the
# flagship's width with the timeline and PE tables as contiguous views that
# start 4 bytes past a 16-byte boundary ("misaligned"), the same paths; and
# three cases of the grouped kernels' runs (8 sorted samples of one worker):
# every sample of worker 1 at one start ("same start": runs of identical
# windows), a worker with 3 samples whose windows lie far apart ("sparse
# worker": a run whose union has gaps), and a minibatch of 61 with a worker
# of 13 samples ("ragged segment": segments that are not a multiple of 8).
EDGE_CASES = {"edge case": (64, 4, 80, 24, 16, 384, 4, "mixed"),
              "one worker": (64, 4, 80, 24, 16, 384, 4, "one worker"),
              "headroom_768": (48, 4, 240, 120, 96, 768, 6, "mixed"),
              "narrow heads": (64, 4, 40, 20, 13, 40, 4, "mixed"),
              "odd width": (64, 4, 40, 20, 13, 30, 3, "mixed"),
              "misaligned tables": (64, 4, 80, 24, 16, 384, 4, "misaligned"),
              "same start": (64, 4, 80, 24, 16, 384, 4, "same start"),
              "sparse worker": (64, 4, 200, 24, 16, 384, 4, "sparse worker"),
              "ragged segment": (61, 4, 80, 24, 16, 384, 4, "ragged")}


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
    worker" and "same start", where every sample is worker 1's, and "sparse
    worker", where the last worker has three."""
    B, W, S, P, L, D, heads, layout = EDGE_CASES[case]
    floats = [torch.randn(shape, generator=gen) for shape in
              ((B, D), (W, S, D), (W, S, D), (P, D), (P, D))]
    w_idx = torch.randint(0, W - 1, (B,), generator=gen, dtype=torch.int32)
    start = torch.randint(0, S - L + 1, (B,), generator=gen, dtype=torch.int32)
    if layout in ("one worker", "same start"):
        w_idx[:] = 1
    if layout == "same start":
        start[:] = (S - L) // 2
    elif layout == "sparse worker":
        w_idx[[5, 20, 40]] = W - 1
        start[[5, 20, 40]] = torch.tensor([0, (S - L) // 2, S - L],
                                          dtype=torch.int32)
    elif layout == "ragged":
        w_idx[:13] = 0
        w_idx[13:] = torch.randint(1, W - 1, (B - 13,), generator=gen,
                                   dtype=torch.int32)
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
    """(L, D, H) of the configurations' and of the edge cases' windows."""
    shapes = {name: (L, D, HEADS.get(name, 4))
              for name, (_, _, _, L, D, _) in SHAPES.items()}
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


def check_sort(fwd_g, args, label: str) -> None:
    """The grouped kernels' sort on the card (their first launch, alone)
    must give the order ``grouped_order`` states: the minibatch stably
    sorted by (worker, start), with each worker's first sorted position."""
    from etmppo_tpu_torch.ops.window_attention import grouped_order
    w_idx, start, n_valid, s_lo = args[5:9]
    W = args[1].shape[0]
    meta, seg = fwd_g.sort(w_idx, start, n_valid, s_lo, W)
    order, seg_ref = grouped_order(w_idx.cpu(), start.cpu(), W)
    fields = torch.stack([order.int()] + [t.cpu()[order] for t in
                                          (w_idx, start, n_valid, s_lo)])
    if not (torch.equal(meta.cpu(), fields)
            and torch.equal(seg.cpu().long(), seg_ref)):
        raise RuntimeError(f"sort, {label}: the grouped kernels' order is "
                           "not the stable (worker, start) sort")


def check_all(k, args, g, num_heads: int, label: str) -> dict:
    """Every kernel against its plain version; the grouped forward against
    the per-sample forward, the grouped backward against the per-sample
    backward, and the grouped backward against itself; the grouped kernels'
    sort against its statement. Returns the largest error of each kernel,
    and each backward's largest share of its tolerance."""
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
    check_sort(fwd_g, args, label)
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


def minibatch_agreement(trainer, batch, gathered: bool = False) -> str:
    """Loss and gradients of one minibatch of ``batch`` through the
    trainer's kernels, and through the plain versions of the kernels or,
    with ``gathered``, through the gathered-window path (plain PyTorch)."""
    upd = trainer.update_fn
    timeline, slots, fields = upd.prepare_timeline(batch)
    gen = torch.Generator(trainer.device).manual_seed(7)
    idx = torch.randperm(trainer.config.batch_size, generator=gen,
                         device=trainer.device)[:trainer.config.mini_batch_size]
    kernels = (upd.kernel, upd.backward_kernel)
    paths = [(upd.loss_timeline, kernels, timeline, slots, fields)]
    if gathered:
        paths.append((upd.loss_gathered, kernels) + upd.prepare_gathered(batch))
    else:
        paths.append((upd.loss_timeline, (None, None), timeline, slots,
                      fields))
    del timeline, fields
    results = []
    for loss_fn, (fwd, bwd), memory, memory_slots, mb_fields in paths:
        upd.kernel, upd.backward_kernel = fwd, bwd
        trainer.model.zero_grad(set_to_none=True)
        loss, _ = loss_fn(upd.minibatch(mb_fields, idx), memory,
                          memory_slots, 0.1, 0.001)
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
    reference = "gathered-window" if gathered else "plain"
    if (loss_err > LOSS_RTOL * max(1.0, abs(loss_p.item()))
            or grad_err > GRAD_RTOL * grad_max):
        raise RuntimeError(f"kernel path disagrees with the {reference} "
                           f"path: loss diff {loss_err}, grad diff {grad_err}")
    return (f"loss {loss_k.item():.6f} vs {loss_p.item():.6f} ({reference} "
            f"path), max grad diff {grad_err:.3e} of max grad "
            f"{grad_max:.3e}")


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
    a). Returns (phase start, detail, (rollout seconds, mean update seconds
    by pair))."""
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
                                        for n, m in mean.items())), (
        rollout_s, mean)


def train_counted(trainer, k, label: str, expected: dict,
                  trace_dir: str = None):
    """Sets every launch count to 0, then runs UPDATES updates of
    ``trainer``, with a ``trace_dir`` the second under
    ``utils/profiling.trace``; after each update, each kernel of
    ``expected`` (name -> launches per update) must have launched that many
    times per update so far, every other kernel never, and every stat must
    be finite. Returns the seconds and the stats of each update and the
    traced update's ``device_busy`` shares (None without a trace)."""
    from etmppo_tpu_torch.utils.profiling import trace
    for kernel in k.values():
        kernel.launches = 0
    per_update, results = [], []
    for u in range(UPDATES):
        traced = u == 1 and trace_dir is not None
        tu = time.perf_counter()
        with (trace(trace_dir) if traced else contextlib.nullcontext()):
            stats = trainer.train_one_update()
            results.append(stats)
            torch.cuda.synchronize()
            per_update.append(time.perf_counter() - tu)   # without the export
        bad = {n: v for n, v in stats.items() if not math.isfinite(v)}
        if bad:
            raise RuntimeError(f"{label} update {u}: non-finite stats {bad}")
        for name, kernel in k.items():
            check_launches((kernel,), expected.get(name, 0) * (u + 1),
                           f"{label} update {u}")
        print(f"update {u}: {per_update[-1]:.2f}s{' (traced)' * traced} "
              f"loss {stats['loss']:.6f} entropy {stats['entropy']:.4f} "
              f"value_loss {stats['value_loss']:.6f}", flush=True)
    if trace_dir is None:
        return per_update, None, results
    from etmppo_tpu_torch.utils.profiling import TRACE_FILE, device_busy
    shares = device_busy(os.path.join(trace_dir, TRACE_FILE),
                         ("rollout", "ppo_update"))
    if shares["total"]["busy_s"] <= 0:
        raise RuntimeError(f"{label}: the trace holds no device activity")
    return per_update, shares, results


def busy_line(wall_s: float, shares: dict, rollout_s: float,
              update_s: float) -> str:
    """The device busy share of the traced update (``utils/profiling.py``):
    the union of the card's kernel, copy and memset intervals over the
    update's wall time, and over its rollout and PPO update apart (split
    where the host enters the PPO update); then the same busy seconds over
    the wall seconds of the untraced rollout and PPO update of the split
    phase, since the profiler slows the host and not the device."""
    untraced = {"rollout": rollout_s, "ppo_update": update_s,
                "total": rollout_s + update_s}
    return (f"update 2 traced ({wall_s:.2f}s with the profiler): device busy "
            + ", ".join(f"{name} {m['busy_share'] * 100:.1f}% of "
                        f"{m['wall_s']:.3f}s ({m['busy_s']:.3f}s busy)"
                        for name, m in shares.items())
            + "; over the untraced split's times: " + ", ".join(
                f"{name} {shares[name]['busy_s'] / wall * 100:.1f}% of "
                f"{wall:.3f}s" for name, wall in untraced.items()))


def kernel_shape(trainer, name: str) -> str:
    """The window-attention kernel shape ``trainer`` gives, which must be
    ``SHAPES[name]``, as text."""
    config, trx = trainer.config, trainer.config.transformer
    max_ep = trainer.max_episode_steps
    shape = (config.n_workers, config.worker_steps, max_ep,
             trx.memory_length, trx.embed_dim, config.mini_batch_size)
    if shape != SHAPES[name]:
        raise RuntimeError(f"{name}: kernel shape {shape}, expected "
                           f"{SHAPES[name]}")
    return (f"kernel shape B={config.mini_batch_size} W={config.n_workers} "
            f"S={max_ep + config.worker_steps + trx.memory_length} "
            f"P={max_ep} L={trx.memory_length} D={trx.embed_dim} "
            f"H={trx.num_heads}")


def check_float32(where: str) -> None:
    """The package's entry points turn TF32 off (utils/runtime.py); this
    script sets neither flag itself."""
    if not (torch.backends.cuda.matmul.allow_tf32 is False
            and torch.backends.cudnn.allow_tf32 is False):
        raise RuntimeError(f"TF32 is on {where}")


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
        check_float32("after the first trainer")
        fwd, bwd = k[NAMES[0]], k[NAMES[1]]
        try:
            torch.cuda.synchronize()
            phase("trainer-setup", t)
            per_update, shares, _ = train_counted(
                trainer, k, "flagship", {n: FLAGSHIP_LAUNCHES
                                         for n in NAMES[:2]},
                os.path.join(tmp, "trace"))
            launches = [k[n].launches for n in NAMES]
            steps = config.n_workers * config.worker_steps
            phase("trainer", t,
                  f"{UPDATES} updates, launches fwd {launches[0]} bwd "
                  f"{launches[1]}; s/update "
                  + " ".join(f"{s:.2f}" for s in per_update)
                  + f"; env-steps/s {steps / per_update[-1]:.0f} (update 2,"
                  " traced)")
            # After the counted run: the kernels against the plain versions
            # on one more rollout's data, and where an update's time goes.
            t = time.perf_counter()
            _, batch = trainer.rollout_fn(trainer.rollout_state)
            phase("trainer-check", t, minibatch_agreement(trainer, batch))
            t, detail, (rollout_s, mean) = split_update(trainer, {
                "plain backward": (fwd, None), "kernel backward": (fwd, bwd)})
            phase("trainer-split", t, detail)
            phase("trainer-busy", t, busy_line(
                per_update[1], shares, rollout_s, mean["kernel backward"]))
            t = time.perf_counter()
            phase("flagship-mfu", t, update_mfu(trainer, batch,
                                                mean["kernel backward"]))
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
    from etmppo_tpu_torch.parallel.probe import differences
    found = differences(a, b, where)
    if found:
        raise RuntimeError(found[0])


def run_mysterypath(device, k) -> tuple:
    """Phase 5: Mystery Path Grid through run_training with checkpoints,
    resume, and the saved model; returns the launches of the counted run, in
    the order of NAMES, and the reset kernel's launches there and in the
    resumed update."""
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
        for kernel in (*k.values(), trainer.env.reset_kernel):
            kernel.launches = 0
        result = trainer.run_training()
        launches = [k[n].launches for n in NAMES]
        check_launches(per_sample, MYSTERY_LAUNCHES * UPDATES, "mysterypath")
        check_launches(grouped, 0, "mysterypath")
        check_launches((trainer.env.reset_kernel,), MYSTERY_RESETS * UPDATES,
                       "mysterypath")
        resets = trainer.env.reset_kernel.launches
        trainer.close()
        n_rows = _finite_csv(trainer.writer.csv_path)
        if n_rows != UPDATES:
            raise RuntimeError(f"mysterypath: {n_rows} logged updates")
        phase("mysterypath", t,
              f"{UPDATES} updates, launches fwd {launches[0]} bwd "
              f"{launches[1]} reset {resets}; env-steps/s "
              f"{result['env_steps_per_second']:.0f}"
              f" (steady {result['env_steps_per_second_steady']:.0f}: without"
              " the first launch, update 1 and the graph's capture; update 2"
              " a replay)")

        t = time.perf_counter()
        resumed = PPOTrainer(config, run_id="mpg", device=device,
                             enable_metrics=False)
        if not resumed.resume_from_checkpoint() or resumed.update != UPDATES:
            raise RuntimeError(f"resume: at update {resumed.update}")
        _assert_same(resumed._training_state(), trainer._training_state(),
                     "resume: state")
        for kernel in (*k.values(), resumed.env.reset_kernel):
            kernel.launches = 0
        stats = resumed.train_one_update()
        bad = {k: v for k, v in stats.items() if not math.isfinite(v)}
        if bad:
            raise RuntimeError(f"resumed update: non-finite stats {bad}")
        check_launches(per_sample, MYSTERY_LAUNCHES, "resumed update")
        check_launches((resumed.env.reset_kernel,), MYSTERY_RESETS,
                       "resumed update")
        resets += resumed.env.reset_kernel.launches
        model, _ = load_model(os.path.join(tmp, "mpg.nn"), device)
        _assert_same(model.state_dict(), trainer.model.state_dict(), "model")
        phase("mysterypath-resume", t,
              f"resumed at update {UPDATES} bit for bit; update {UPDATES} "
              f"loss {stats['loss']:.6f}; mpg.nn loads to the same weights")
        phase("mysterypath-split", *split_update(resumed, {
            "plain backward": (per_sample[0], None),
            "kernel backward": per_sample})[:2])
    return launches, resets


def update_drift(trainer, batch, pair, deterministic: bool = False) -> tuple:
    """Two PPO updates with the (forward, backward) ``pair`` from one state,
    on one batch and one set of permutations: the largest difference of a
    parameter between the two, and the mean wall seconds of an update. With
    ``deterministic``, PyTorch's own operations run with
    ``torch.use_deterministic_algorithms`` (warn only) and
    ``cudnn.deterministic``, so that what is left comes from the
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
    after, seconds = [], []
    for _ in range(2):
        trainer.model.load_state_dict(model_state)
        upd.optimizer.load_state_dict(copy.deepcopy(opt_state))
        torch.cuda.synchronize()
        t = time.perf_counter()
        upd(batch, 1e-4, 0.1, 0.001, perms=perms)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t)
        after.append([p.detach().clone() for p in trainer.model.parameters()])
    upd.kernel, upd.backward_kernel = kept
    trainer.model.load_state_dict(model_state)
    upd.optimizer.load_state_dict(opt_state)
    torch.use_deterministic_algorithms(flags[0], warn_only=True)
    torch.backends.cudnn.deterministic = flags[1]
    drift = max((a - b).abs().max().item() for a, b in zip(*after))
    return drift, sum(seconds) / len(seconds)


def run_mortarmayhem(device, k) -> tuple:
    """Phase 6: Mortar Mayhem Grid with the grouped kernels; returns the
    launches of the counted run, in the order of NAMES, and the env's reset
    kernel's launches there."""
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
            torch.cuda.synchronize()
            phase("mortarmayhem-setup", t, kernel_shape(trainer,
                                                         "mortarmayhem"))
            t = time.perf_counter()
            reset = trainer.env.reset_kernel
            reset.launches = 0
            per_update, _, _ = train_counted(
                trainer, k, "mortarmayhem",
                {n: MORTAR_LAUNCHES for n in NAMES[2:]})
            launches = [k[n].launches for n in NAMES]
            check_launches((reset,), MORTAR_RESETS * UPDATES, "mortarmayhem")
            resets = reset.launches
            trainer._save_model()
            model, _ = load_model(os.path.join(tmp, "mmg.nn"), device)
            _assert_same(model.state_dict(), trainer.model.state_dict(),
                         "model")
            steps = config.n_workers * config.worker_steps
            phase("mortarmayhem", t,
                  f"{UPDATES} updates, launches fwd_grouped {launches[2]} "
                  f"bwd_grouped {launches[3]} reset {resets}; s/update "
                  + " ".join(f"{s:.2f}" for s in per_update)
                  + f"; env-steps/s {steps / per_update[-1]:.0f} (update 2);"
                  " mmg.nn loads to the same weights")

            t = time.perf_counter()
            _, batch = trainer.rollout_fn(trainer.rollout_state)
            phase("mortarmayhem-check", t,
                  minibatch_agreement(trainer, batch))
            phase("mortarmayhem-split", *split_update(trainer, {
                "plain backward": (grouped[0], None),
                "per-sample pair": per_sample, "grouped pair": grouped})[:2])
            t = time.perf_counter()
            drift = {(name, det): update_drift(trainer, batch, pair, det)
                     for det in (False, True) for name, pair in
                     (("per-sample pair", per_sample),
                      ("grouped pair", grouped))}
            phase("determinism", t,
                  "largest parameter difference between two PPO updates "
                  "from one state and batch: " + ", ".join(
                      f"{name} {d:.3e}" for (name, det), (d, _)
                      in drift.items() if not det)
                  + "; with PyTorch's deterministic algorithms: " + ", ".join(
                      f"{name} {d:.3e}" for (name, det), (d, _)
                      in drift.items() if det)
                  + "; mean s per update, deterministic algorithms off / on: "
                  + ", ".join(f"{name} {drift[name, False][1]:.3f} / "
                              f"{drift[name, True][1]:.3f}"
                              for name in ("per-sample pair",
                                           "grouped pair")))
            if drift["grouped pair", True][0] != 0.0:
                raise RuntimeError("determinism: two grouped-pair PPO updates "
                                   "with deterministic algorithms differ")
        finally:
            trainer.close()
    return launches, resets


def run_searingspotlights(device, k) -> list:
    """Phase 7: Searing Spotlights with the per-sample kernel pair; returns
    the launches of the counted run, in the order of NAMES."""
    from etmppo_tpu_torch.config import SEARING_SPOTLIGHTS, config_from_dict
    from etmppo_tpu_torch.training.checkpoint import load_model
    from etmppo_tpu_torch.training.trainer import PPOTrainer
    t = time.perf_counter()
    per_sample = (k[NAMES[0]], k[NAMES[1]])
    with tempfile.TemporaryDirectory() as tmp:
        config = dataclasses.replace(
            config_from_dict(SEARING_SPOTLIGHTS), updates=UPDATES,
            summary_dir=tmp, checkpoint_dir=tmp)
        trainer = PPOTrainer(config, run_id="ss", device=device)
        try:
            torch.cuda.synchronize()
            phase("searingspotlights-setup", t,
                  kernel_shape(trainer, "searingspotlights"))
            t = time.perf_counter()
            per_update, _, _ = train_counted(
                trainer, k, "searingspotlights",
                {n: SEARING_LAUNCHES for n in NAMES[:2]})
            launches = [k[n].launches for n in NAMES]
            trainer._save_model()
            model, _ = load_model(os.path.join(tmp, "ss.nn"), device)
            _assert_same(model.state_dict(), trainer.model.state_dict(),
                         "model")
            del model
            steps = config.n_workers * config.worker_steps
            phase("searingspotlights", t,
                  f"{UPDATES} updates, launches fwd {launches[0]} bwd "
                  f"{launches[1]}; s/update "
                  + " ".join(f"{s:.2f}" for s in per_update)
                  + f"; env-steps/s {steps / per_update[-1]:.0f} (update 2);"
                  " ss.nn loads to the same weights")
            t = time.perf_counter()
            _, batch = trainer.rollout_fn(trainer.rollout_state)
            phase("searingspotlights-check", t,
                  minibatch_agreement(trainer, batch, gathered=True))
            del batch
            phase("searingspotlights-split", *split_update(trainer, {
                "plain backward": (per_sample[0], None),
                "kernel backward": per_sample})[:2])
        finally:
            trainer.close()
    return launches


def run_gathered(device, k, name: str, raw: dict, updates: int,
                 traced: bool, probe=None) -> float:
    """Phases 8, 9 and 14: a configuration on the gathered-window loss (no
    kernel may launch), ``updates`` (more than UPDATES) updates, with
    ``traced`` the second traced; prints the steady env-steps/s (over the
    updates after the second), the last update's success where the env
    reports one, and the rollout and PPO update seconds apart; then
    ``probe(trainer, trace file)``'s line, where given (with ``traced``).
    Returns the steady env-steps/s."""
    from etmppo_tpu_torch.config import config_from_dict
    from etmppo_tpu_torch.training.trainer import PPOTrainer
    from etmppo_tpu_torch.utils.profiling import TRACE_FILE
    t = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        config = dataclasses.replace(
            config_from_dict(raw), updates=updates, summary_dir=tmp,
            checkpoint_dir=tmp)
        if config.use_pallas_attention:
            raise RuntimeError(f"{name} must take the gathered-window loss")
        trainer = PPOTrainer(config, run_id=name, device=device)
        try:
            torch.cuda.synchronize()
            phase(f"{name}-setup", t)
            t = time.perf_counter()
            per_update, shares, _ = train_counted(
                trainer, k, name, {},
                os.path.join(tmp, "trace") if traced else None)
            result = {}
            for _ in range(updates - UPDATES):
                tu = time.perf_counter()
                result = trainer.train_one_update()
                torch.cuda.synchronize()
                per_update.append(time.perf_counter() - tu)
            check_launches(k.values(), 0, name)
            bad = {n: v for n, v in result.items() if not math.isfinite(v)}
            if bad:
                raise RuntimeError(f"{name}: non-finite stats {bad}")
            steps = config.n_workers * config.worker_steps
            steady = per_update[UPDATES:]
            rate = steps * len(steady) / sum(steady)
            detail = (f"{updates} updates, no kernel launched; s/update "
                      + " ".join(f"{s:.2f}" for s in per_update[:UPDATES])
                      + (" (update 2 traced)" if traced else "")
                      + f"; steady env-steps/s {rate:.0f} (mean over "
                      f"updates {UPDATES + 1}-{updates})")
            if "success" in result:
                detail += (f"; update {updates}: success "
                           f"{result['success']:.3f}, reward_mean "
                           f"{result['reward_mean']:.3f}")
            phase(name, t, detail)
            t, detail, (rollout_s, mean) = split_update(trainer, {
                "gathered loss": (None, None)})
            phase(f"{name}-split", t, detail)
            if traced:
                phase(f"{name}-busy", t, busy_line(
                    per_update[1], shares, rollout_s, mean["gathered loss"]))
            if probe is not None:
                t = time.perf_counter()
                phase(f"{name}-probe", t, probe(trainer, os.path.join(
                    tmp, "trace", TRACE_FILE)))
        finally:
            trainer.close()
    return rate


def artifact(name: str) -> str:
    """A committed model artifact of the checkout."""
    path = os.path.join(ROOT, "models", name)
    if not os.path.exists(path):
        raise RuntimeError(f"{path}: the committed artifact is missing")
    return path


def hold_raw_memory(server, steps: int, gen, rtol: float = SERVE_RTOL,
                    near_ties: bool = False) -> str:
    """``steps`` greedy steps of ``server`` (all streams) on its env's
    observations, the env stepped with the served actions, with a third of
    the streams reset half-way and the odd streams inactive every fourth
    step; each step held against the raw-memory formulation
    (``model.forward`` over ``memory[index_table[t]]``, ``memory[t] =
    new_memory`` where active): values within ``rtol`` of the largest (at
    least 1), and actions equal; with ``near_ties``, equal where the raw
    path's top-2 logit gap of every branch exceeds twice ``rtol`` of the
    largest logit, as a bfloat16 model may round a near tie either way."""
    from etmppo_tpu_torch.envs.factory import create_env
    from etmppo_tpu_torch.ops.memory_index import (build_memory_indices,
                                                   build_memory_mask)
    model, config, dev = server.model, server.config, server.device
    trx = config.transformer
    M, L, max_ep = server.max_streams, trx.memory_length, \
        server.max_episode_steps
    env = create_env(config.environment, M, dev)
    state, obs = env.reset(env.sample_reset_draws(gen))
    index_table = torch.as_tensor(build_memory_indices(max_ep, L),
                                  device=dev).long()
    mask_table = torch.as_tensor(build_memory_mask(L), device=dev)
    memory = torch.zeros(M, max_ep, trx.num_blocks, trx.embed_dim, device=dev)
    t = torch.zeros(M, dtype=torch.int64, device=dev)
    rows = torch.arange(M, device=dev)
    server.reset(range(M))
    worst, compared = 0.0, 0
    for step in range(steps):
        active = torch.ones(M, dtype=torch.bool, device=dev)
        if step % 4 == 3:
            active[1::2] = False
        if step == steps // 2:
            server.reset(range(0, M, 3))
            memory[0::3] = 0.0
            t[0::3] = 0
        actions, values = server.step(obs, active.cpu().numpy())
        with torch.no_grad():
            idx = index_table[t]
            logits, value_raw, new_memory = model(
                obs, memory[rows[:, None], idx],
                mask_table[t.clamp(0, L - 1)], idx)
        memory[rows[active], t[active]] = new_memory[active]
        t = t + active.long()
        greedy = torch.stack([lg.argmax(dim=-1) for lg in logits], dim=-1)
        clear = np.ones(M, bool)
        if near_ties:
            gaps = torch.stack([lg.topk(2, dim=-1).values.diff().neg()[:, 0]
                                for lg in logits]).min(0).values
            scale = max(lg.abs().max().item() for lg in logits)
            clear = (gaps > 2 * rtol * scale).cpu().numpy()
        compared += int(clear.sum())
        if not np.array_equal(actions[clear], greedy.cpu().numpy()[clear]):
            raise RuntimeError(f"serve, step {step}: greedy actions differ "
                               "from the raw-memory formulation's")
        err = (torch.as_tensor(values, device=dev) - value_raw).abs().max()
        tol = rtol * max(1.0, value_raw.abs().max().item())
        if not err.item() <= tol:
            raise RuntimeError(f"serve, step {step}: values differ from the "
                               f"raw-memory formulation's by {err.item()} > "
                               f"{tol}")
        worst = max(worst, err.item())
        state, obs, _, _, _ = env.step(state, torch.as_tensor(
            actions, device=dev), env.sample_step_draws(gen))
    if not np.array_equal(server.steps, t.cpu().numpy()):
        raise RuntimeError("serve: step counters differ from the raw path's")
    return (f"{steps} steps held against the raw-memory path: actions equal"
            + (f" in {compared} of {steps * M} stream-steps clear of a near "
               "tie" if near_ties else "")
            + f", max value diff {worst:.3e}")


def hold_step_many(path: str, device, gen, obs_shape) -> str:
    """``step_many`` over SERVE_MANY_STEPS steps against as many
    ``step_device`` calls of a second server from the same state; then the
    second server driven to ``t == max_episode_steps`` on every stream and
    stepped once more (the clamped window start and PE slot)."""
    from etmppo_tpu_torch.serve import PolicyServer
    M, T = SERVE_STREAMS, SERVE_MANY_STEPS
    one, many = (PolicyServer(path, M, greedy=True, device=device)
                 for _ in range(2))
    for server in (one, many):
        server.reset(range(M))
    obs_seq = torch.rand((T, M) + tuple(obs_shape), generator=gen,
                         device=device)
    singles = [one.step_device(obs) for obs in obs_seq]
    actions, values = many.step_many(obs_seq)
    err = (values - torch.stack([v for _, v in singles])).abs().max().item()
    if not (torch.equal(actions, torch.stack([a for a, _ in singles]))
            and err <= 1e-5 and np.array_equal(one.steps, many.steps)):
        raise RuntimeError(f"serve: step_many differs from {T} step_device "
                           f"calls (values by {err})")
    max_ep = one.max_episode_steps
    for _ in range(max_ep - T):
        one.step_device(obs_seq[0])
    _, frozen = one.step_device(obs_seq[0])
    torch.cuda.synchronize()
    if not (list(one.steps) == [max_ep] * M
            and torch.isfinite(frozen).all()):
        raise RuntimeError("serve: a step at t == max_episode_steps did not "
                           "freeze the streams")
    return (f"step_many({T}) equals {T} step_device calls (max value diff "
            f"{err:.1e}); a step at t == max_episode_steps={max_ep} froze "
            "every stream")


def serving_rates(server, gen) -> str:
    """Policy-steps/s (streams x steps / s) over SERVE_TIMED_STEPS steps of
    each of ``step`` (host observations, a host sync per step),
    ``step_device`` (observations on the card) and ``step_many``
    (SERVE_RESET_EVERY steps a call), every stream reset each
    SERVE_RESET_EVERY steps (the reset's copy of the ids is the only sync of
    the last two); the FLOPs of one step by ``counted_flops`` and its MFU at
    the ``step_device`` rate."""
    from etmppo_tpu_torch.utils.flops import (counted_flops,
                                              device_peak_flops, mfu)
    M, N, dev = server.max_streams, SERVE_TIMED_STEPS, server.device
    R = SERVE_RESET_EVERY
    shape = (M,) + tuple(server.observation_shape)
    host_obs = np.random.default_rng(0).uniform(size=shape).astype(
        np.float32)
    obs = torch.rand(shape, generator=gen, device=dev)
    obs_seq = torch.rand((R,) + shape, generator=gen, device=dev)
    seconds = {}
    for name in ("step", "step_device", "step_many"):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(N // R):
            server.reset(range(M))
            if name == "step":
                for _ in range(R):
                    server.step(host_obs)
            elif name == "step_device":
                for _ in range(R):
                    server.step_device(obs)
            else:
                server.step_many(obs_seq)
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t
    server.reset(range(M))
    flops = counted_flops(server.step_device, obs)
    step_s = seconds["step_device"] / N
    peak = device_peak_flops(dev)
    return (f"policy-steps/s at M={M} over {N} steps: " + ", ".join(
        f"{name} {M * N / s:,.0f} ({s / N * 1e3:.3f} ms/step, {s:.2f} s)"
        for name, s in seconds.items())
        + f"; a step {flops / 1e9:.2f} GFLOP (counted_flops), "
        f"{flops / step_s / 1e12:.2f} TFLOP/s at the step_device rate, MFU "
        f"{mfu(flops, step_s, peak) * 100:.3f}% of {peak / 1e12:.1f} TFLOP/s")


def serving_trace(server, gen, steps: int = 20) -> str:
    """``steps`` step_device calls of ``server`` under
    ``utils/profiling.trace``: the device's busy share of their wall time,
    CUDA kernels per step and the operators that take the most device
    time."""
    from etmppo_tpu_torch.utils.profiling import (TRACE_FILE, annotate,
                                                  device_busy, trace)
    M = server.max_streams
    obs = torch.rand((M,) + tuple(server.observation_shape), generator=gen,
                     device=server.device)
    server.reset(range(M))
    server.step_device(obs)
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        with trace(tmp) as prof:
            with annotate("serve_steps"):
                for _ in range(steps):
                    server.step_device(obs)
                torch.cuda.synchronize()
        path = os.path.join(tmp, TRACE_FILE)
        busy = device_busy(path, ["serve_steps"])["serve_steps"]
        with open(path) as f:
            kernels = sum(ev.get("ph") == "X" and ev.get("cat") == "kernel"
                          for ev in json.load(f)["traceEvents"])
    top = sorted((e for e in prof.key_averages() if e.key != "serve_steps"),
                 key=lambda e: e.self_device_time_total, reverse=True)[:5]
    return (f"traced {steps} step_device calls: device busy "
            f"{busy['busy_share'] * 100:.1f}% of {busy['wall_s'] * 1e3:.2f} ms "
            f"({busy['busy_s'] / steps * 1e3:.3f} ms busy a step), "
            f"{kernels / steps:.0f} kernels a step; most device time: "
            + ", ".join(f"{e.key[:40]} {e.self_device_time_total / steps / 1e3:.3f}"
                        " ms" for e in top) + " a step")


def run_serve(device, k) -> None:
    """Phase 10: PolicyServer at both artifacts' full width."""
    from etmppo_tpu_torch.serve import PolicyServer
    for name, steps in SERVE_MODELS:
        t = time.perf_counter()
        for kernel in k.values():
            kernel.launches = 0
        path = artifact(name)
        gen = torch.Generator(device).manual_seed(0)
        server = PolicyServer(path, SERVE_STREAMS, greedy=True, device=device)
        trx = server.config.transformer
        detail = (f"{name} ({trx.num_blocks} x {trx.embed_dim}, memory "
                  f"{trx.memory_length}, obs {server.observation_shape}, "
                  f"M={SERVE_STREAMS}): " + hold_raw_memory(server, steps, gen)
                  + "; " + hold_step_many(path, device, gen,
                                          server.observation_shape)
                  + "; " + serving_rates(server, gen))
        check_launches(k.values(), 0, f"serve {name}")
        phase("serve", t, detail + "; no kernel launched")
        phase("serve-busy", t, f"{name}: " + serving_trace(server, gen))
        del server
        torch.cuda.empty_cache()


def run_evaluate(device, k) -> None:
    """Phase 11: the 5-seed evaluation protocol of the MiniGrid flagship."""
    from etmppo_tpu_torch.evaluate import evaluate_protocol
    for kernel in k.values():
        kernel.launches = 0
    t = time.perf_counter()
    per_seed, aggregate = evaluate_protocol(
        [artifact(n) for n in EVAL_MODELS], episodes=EVAL_EPISODES,
        repeats=1, seed=0, device=device)
    seconds = time.perf_counter() - t
    check_launches(k.values(), 0, "evaluate")
    success, reward = aggregate["success"], aggregate["reward"]
    episodes = EVAL_EPISODES * len(EVAL_MODELS)
    phase("evaluate", t,
          f"{len(EVAL_MODELS)} seeds x {EVAL_EPISODES} episodes x 1 repeat: "
          f"success IQM {success[0]:.4f} [{success[1]:.4f}, "
          f"{success[2]:.4f}], reward IQM {reward[0]:.4f} [{reward[1]:.4f}, "
          f"{reward[2]:.4f}], length IQM {aggregate['length'][0]:.2f}; "
          f"{seconds:.2f}s with the loads, {episodes / seconds:.1f} "
          "episodes/s; no kernel launched")
    if success[0] != 1.0 or abs(reward[0] - EVAL_REWARD_IQM) > EVAL_REWARD_TOL:
        raise RuntimeError(
            f"evaluate: success IQM {success[0]}, reward IQM {reward[0]}; "
            f"expected 1.0 and {EVAL_REWARD_IQM} +- {EVAL_REWARD_TOL}")


def gif_images(path: str) -> int:
    """The image descriptors of a GIF89a file, counted by walking its
    blocks."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:6] != b"GIF89a":
        raise RuntimeError(f"{path} does not start with GIF89a")

    def table(flags):   # bytes of a colour table, if the flags say one follows
        return 3 * (2 << (flags & 7)) if flags & 0x80 else 0
    pos, images = 13 + table(data[10]), 0
    while data[pos] != 0x3B:
        if data[pos] == 0x21:                 # extension: label, sub-blocks
            pos += 2
        elif data[pos] == 0x2C:               # image: descriptor, table, LZW
            images += 1
            pos += 10 + table(data[pos + 9]) + 1
        else:
            raise RuntimeError(f"{path}: block {data[pos]:#x} at byte {pos}")
        while data[pos]:
            pos += data[pos] + 1
        pos += 1
    return images


def run_enjoy(device, k) -> None:
    """Phase 12: one rendered episode of the MiniGrid flagship."""
    from etmppo_tpu_torch.enjoy import run_episodes
    for kernel in k.values():
        kernel.launches = 0
    t = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            returns = run_episodes(artifact(FLAGSHIP_NN), episodes=1,
                                   render=True, render_dir=tmp, device=device)
        length = int(re.search(r"Episode length: (\d+)",
                               out.getvalue()).group(1))
        gif = os.path.join(tmp, "episode_000.gif")
        images = gif_images(gif)
        size = os.path.getsize(gif)
    check_launches(k.values(), 0, "enjoy")
    if images != length + 1:
        raise RuntimeError(f"enjoy: {images} images in the GIF of an episode "
                           f"of {length} steps")
    phase("enjoy", t, f"{FLAGSHIP_NN}: an episode of {length} steps, return "
          f"{returns[0]:.4f}; GIF89a of {images} images, {size} bytes; no "
          "kernel launched")


def _http(base: str, route: str, body=None, headers=None):
    req = urllib.request.Request(base + route, data=body,
                                 headers=headers or {})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def run_serve_http(device, k) -> None:
    """Phase 13: the HTTP front end at the flagship's width, against a
    local PolicyServer in the same state."""
    from etmppo_tpu_torch.serve import PolicyServer
    from etmppo_tpu_torch.serve_http import serve
    for kernel in k.values():
        kernel.launches = 0
    t = time.perf_counter()
    path, M = artifact(FLAGSHIP_NN), SERVE_STREAMS
    httpd = serve(path, M, 0, greedy=True, device=device)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        local = PolicyServer(path, M, greedy=True, device=device)
        info = _http(base, "/info")
        shape = (M,) + tuple(info["observation_shape"])
        if info["max_streams"] != M or shape[1:] != local.observation_shape:
            raise RuntimeError(f"serve-http: /info says {info}")
        json_hdr = {"Content-Type": "application/json"}
        reset = json.dumps({"streams": list(range(M))}).encode()
        _http(base, "/reset", reset, json_hdr)
        local.reset(range(M))
        rng = np.random.default_rng(0)
        obs = rng.uniform(size=shape).astype("<f4")
        obs_seq = rng.uniform(size=(HTTP_MANY[1],) + shape).astype("<f4")
        binary = {"Content-Type": "application/octet-stream",
                  "X-Streams": str(M)}
        for route, body, extra, run_local in (
                ("/step", obs, {}, lambda: local.step(obs)),
                ("/step_many", obs_seq, {"X-T": str(HTTP_MANY[1])},
                 lambda: local.step_many(obs_seq))):
            got = _http(base, route, body.tobytes(), {**binary, **extra})
            actions, values = run_local()
            err = np.abs(np.asarray(got["values"])
                         - np.asarray(values.tolist())).max()
            if not (np.array_equal(got["actions"], actions.tolist())
                    and err <= 1e-5 and got["steps"] == local.steps.tolist()):
                raise RuntimeError(f"serve-http: {route} answers otherwise "
                                   f"than a local PolicyServer ({err})")
        def timed(n, steps, route, body, headers):
            # n requests of ``steps`` steps each; every stream reset (not
            # timed) before each SERVE_RESET_EVERY steps, as /step refuses
            # an exhausted stream.
            seconds, chunk = 0.0, SERVE_RESET_EVERY // steps
            for i in range(0, n, chunk):
                _http(base, "/reset", reset, json_hdr)
                tr = time.perf_counter()
                for _ in range(min(chunk, n - i)):
                    _http(base, route, body, headers)
                seconds += time.perf_counter() - tr
            return seconds
        step_s = timed(HTTP_STEPS, 1, "/step", obs.tobytes(), binary)
        many_s = timed(HTTP_MANY[0], HTTP_MANY[1], "/step_many",
                       obs_seq.tobytes(), {**binary, "X-T": str(HTTP_MANY[1])})
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=60)
    check_launches(k.values(), 0, "serve-http")
    n_many = HTTP_MANY[0] * HTTP_MANY[1]
    phase("serve-http", t,
          f"{FLAGSHIP_NN}, M={M}: /info, /reset, binary /step and /step_many "
          f"(X-T={HTTP_MANY[1]}) answer as a local PolicyServer; binary "
          f"/step ({obs.nbytes} bytes) {HTTP_STEPS / step_s:.1f} requests/s, "
          f"{M * HTTP_STEPS / step_s:,.0f} policy-steps/s ({HTTP_STEPS} in "
          f"{step_s:.2f} s); binary /step_many {HTTP_MANY[0] / many_s:.2f} "
          f"requests/s, {M * n_many / many_s:,.0f} policy-steps/s "
          f"({HTTP_MANY[0]} in {many_s:.2f} s); no kernel launched")


# Phases 14-15: the host environment paths.
NATIVE_UPDATES = 3
HOSTPOOL_PROCS = 2       # each steps 8 consecutive workers, serial or grouped
STUB_PER_PROC = 8
STUB_MAX_STEPS = 96
# Host rollout against another rollout of the same deterministic dynamics
# (the tolerances of tests/test_host_env.py): obs, dones and episode steps
# equal; values and the memory tape, transformer outputs at other batch
# sizes, within HOST_RTOL / HOST_ATOL; advantages, sums of them, within
# HOST_ADV_TOL relative and absolute.
HOST_RTOL, HOST_ATOL, HOST_ADV_TOL = 1e-4, 1e-5, 1e-4
_STUB_MADE = {}          # envs made so far, by process id


def _stub_obs(t, j, k, xp):
    """The stub's (84, 84, 3) observation at episode step t of worker
    identity j's k-th episode, in [0, 1), exact in float32; ``xp``: numpy
    or torch arrays of the grid and the integers."""
    h, w, c = xp
    return ((h * 7 + w * 3 + c * 11 + t * 5 + j * 13 + k * 17) % 256) / 256


def _stub_length(j, k):
    """Episode k of worker identity j lasts 65-96 steps: longer than the
    flagship's memory of 64, and 96 (the limit) for j = k = 0."""
    return STUB_MAX_STEPS - (j + 3 * k) % 32


class _StubSpace:
    def __init__(self, shape=None, n=None):
        self.shape, self.n = shape, n


class StubGridEnv:
    """A deterministic, action-independent Python env at the MiniGrid
    flagship's shape (84x84x3 float obs, given CHW as the wrappers give
    them; 3 actions; 96 steps at most), numpy only, as the pool's forked
    workers require. Its identity j is its index among the envs its process
    made, which is the worker's index modulo STUB_PER_PROC when the pool
    gives every process STUB_PER_PROC consecutive workers."""

    observation_space = _StubSpace(shape=(3, 84, 84))
    action_space = _StubSpace(n=3)
    max_episode_steps = STUB_MAX_STEPS
    _grid = tuple(np.ix_(np.arange(84), np.arange(84), np.arange(3)))

    def __init__(self):
        pid = os.getpid()
        self.j = _STUB_MADE.get(pid, 0)
        _STUB_MADE[pid] = self.j + 1
        self.k = -1

    def _obs(self):
        obs = _stub_obs(self.t, self.j, self.k, self._grid)
        return obs.astype(np.float32).transpose(2, 0, 1)

    def reset(self):
        self.k += 1
        self.t = 0
        return self._obs()

    def step(self, action):
        self.t += 1
        done = self.t >= _stub_length(self.j, self.k)
        info = ({"reward": self.t / 64, "length": float(self.t)} if done
                else None)
        return self._obs(), np.float32(1 / 64), done, info

    def close(self):
        pass


class StubGridState(NamedTuple):
    t: torch.Tensor      # (W,) int64 episode step
    k: torch.Tensor      # (W,) int64 episode count


class StubGridTwin(TorchEnv):
    """StubGridEnv's dynamics as a batched env on the device (the port's
    TorchEnv protocol), for the device rollout: worker w has identity
    w % STUB_PER_PROC. Episode counts live on the env, since the rollout's
    resets replace the state of the workers that are done."""

    observation_shape = (84, 84, 3)
    action_branches = (3,)
    max_episode_steps = STUB_MAX_STEPS
    info_keys = ("reward", "length")

    def __init__(self, n_workers: int, device):
        self.n_workers, self.device = n_workers, device
        self.j = torch.arange(n_workers, device=device) % STUB_PER_PROC
        self.episodes = torch.zeros(n_workers, dtype=torch.int64,
                                    device=device)
        ar = lambda n: torch.arange(n, device=device)
        self._grid = (ar(84)[:, None, None], ar(84)[None, :, None],
                      ar(3)[None, None, :])

    def _obs(self, t, k):
        v = lambda x: x[:, None, None, None]
        return _stub_obs(v(t), v(self.j), v(k),
                         tuple(g[None] for g in self._grid)).float()

    def sample_reset_draws(self, generator):
        return None

    def sample_step_draws(self, generator):
        return None

    def reset(self, draws):
        t = torch.zeros_like(self.episodes)
        k = self.episodes.clone()
        return StubGridState(t, k), self._obs(t, k)

    def step(self, state, actions, draws=None):
        t = state.t + 1
        done = t >= _stub_length(self.j, state.k)
        self.episodes += done
        reward = torch.full((self.n_workers,), 1 / 64, device=self.device)
        return StubGridState(t, state.k), self._obs(t, state.k), reward, \
            done, {"reward": t.float() / 64, "length": t.float()}


def hold_host_batch(ours, ref, label: str) -> str:
    """A host rollout's batch against another rollout's of the same
    dynamics, to the HOST_* tolerances; returns the largest differences."""
    for name in ("obs", "dones", "episode_steps"):
        if not torch.equal(getattr(ours, name), getattr(ref, name)):
            raise RuntimeError(f"{label}: {name} differ")
    errs = {}
    for name, rtol, atol in (("values", HOST_RTOL, HOST_ATOL),
                             ("tape", HOST_RTOL, HOST_ATOL),
                             ("advantages", HOST_ADV_TOL, HOST_ADV_TOL)):
        a, b = getattr(ours, name), getattr(ref, name)
        diff = (a - b).abs()
        if bool((diff > atol + rtol * b.abs()).any()):
            raise RuntimeError(f"{label}: {name} differ by up to "
                               f"{diff.max().item():.3e}")
        errs[name] = diff.max().item()
    if not bool(ours.dones.any()):
        raise RuntimeError(f"{label}: no episode ended")
    return (f"{label}: obs, dones, episode steps equal; max diff "
            + ", ".join(f"{n} {e:.2e}" for n, e in errs.items()))


def device_top(path: str, span: str, until: str, steps: int,
               n: int = 6) -> str:
    """From a trace written by ``utils/profiling.trace``: the device
    activities (kernels, copies, memsets) with the most time between the
    first ``span`` annotation's start and the first ``until``'s, by name,
    per step of ``steps``."""
    from etmppo_tpu_torch.utils.profiling import DEVICE_CATEGORIES
    with open(path) as f:
        events = [ev for ev in json.load(f)["traceEvents"]
                  if ev.get("ph") == "X"]
    starts = {}
    for ev in events:
        if (ev.get("cat") == "user_annotation"
                and ev.get("name") in (span, until)):
            starts.setdefault(ev["name"], float(ev["ts"]))
    lo, hi = starts[span], starts[until]
    totals, counts = {}, {}
    for ev in events:
        if ev.get("cat") in DEVICE_CATEGORIES and lo <= float(ev["ts"]) < hi:
            totals[ev["name"]] = totals.get(ev["name"], 0.0) + ev["dur"]
            counts[ev["name"]] = counts.get(ev["name"], 0) + 1
    top = sorted(totals, key=totals.get, reverse=True)[:n]
    return ", ".join(f"{name[:40]} {totals[name] / steps / 1e3:.3f} ms "
                     f"({counts[name] / steps:.1f} calls)" for name in top)


def native_probe(trainer, trace_file: str) -> str:
    """Where a native rollout's time goes: the engine's ``step`` alone over
    a rollout's steps, with its thread pool as the factory builds it and
    with one thread, and the device activities with the most time in the
    traced update's rollout (``trace_file``)."""
    from etmppo_tpu_torch.envs.native import NativeEnvBatch
    cfg = trainer.config
    W, T = cfg.n_workers, cfg.worker_steps
    secs = {}
    for threads in (os.cpu_count() or 1, 1):
        env = NativeEnvBatch(cfg.environment.type, n_threads=threads)
        env.start(W)
        try:
            env.reset_all()
            actions = np.zeros((W, 1), np.int32)
            begin = time.perf_counter()
            for _ in range(T):
                env.step(actions)
            secs[threads] = time.perf_counter() - begin
        finally:
            env.close()
    return (f"engine step alone, {T} steps of {W} envs: " + ", ".join(
        f"{n} threads {sec:.3f}s ({sec / T * 1e3:.3f} ms a step)"
        for n, sec in secs.items())
        + "; traced rollout, most device time: "
        + device_top(trace_file, "rollout", "ppo_update", T) + " a step")


def run_native(device, k, device_rates: dict) -> None:
    """Phase 14: PocMemory and masked CartPole as their YAMLs say, on the
    native C++ engine (``-native``), through PPOTrainer on the card."""
    from etmppo_tpu_torch.config import CARTPOLE_MASKED, POC_MEMORY
    from etmppo_tpu_torch.envs import native
    t = time.perf_counter()
    existed = native.library_path().exists()
    path = native.build_native_library()
    phase("native-build", t, f"{path.name} {time.perf_counter() - t:.2f}s "
          f"({'reused' if existed else 'g++'})")
    lines = []
    for name, raw in (("pocmemory", POC_MEMORY),
                      ("cartpole", CARTPOLE_MASKED)):
        env_type = raw["environment"]["type"] + "-native"
        rate = run_gathered(device, k, f"{name}-native",
                            dict(raw, environment={"type": env_type}),
                            NATIVE_UPDATES, True, native_probe)
        lines.append(f"{env_type} {rate:.0f} steady env-steps/s against "
                     f"{device_rates[name]:.0f} on the device env "
                     f"({name} phase)")
    phase("native", t, "; ".join(lines))


def run_hostpool(device, k) -> list:
    """Phase 15: the process pool and the host rollout at the MiniGrid
    flagship's full width over StubGridEnv; returns the launches of the
    phase, in the order of NAMES."""
    from etmppo_tpu_torch.config import MINIGRID_FLAGSHIP, config_from_dict
    from etmppo_tpu_torch.envs.host import HostEnvBatch
    from etmppo_tpu_torch.models.actor_critic import ActorCriticModel
    from etmppo_tpu_torch.training.host_rollout import HostRolloutFn
    from etmppo_tpu_torch.training.ppo import PPOUpdate
    from etmppo_tpu_torch.training.rollout import RolloutFn
    from etmppo_tpu_torch.utils.profiling import (TRACE_FILE, annotate,
                                                  device_busy, trace)
    for kernel in k.values():
        kernel.launches = 0
    t = time.perf_counter()
    config = config_from_dict(MINIGRID_FLAGSHIP)
    W = config.n_workers
    if config.host_pipeline_groups != 2 or W != 2 * STUB_PER_PROC:
        raise RuntimeError("the host-pool phase expects 16 workers in 2 "
                           "groups")
    model = ActorCriticModel(
        config, StubGridTwin.observation_shape, StubGridTwin.action_branches,
        STUB_MAX_STEPS, device=device,
        generator=torch.Generator().manual_seed(config.seed))
    pools, fns, states = {}, {}, {}
    try:
        for kind in ("serial", "pipelined"):
            pools[kind] = HostEnvBatch(make_env=StubGridEnv,
                                       n_procs=HOSTPOOL_PROCS)
            fns[kind] = HostRolloutFn(
                config, pools[kind], model,
                torch.Generator(device).manual_seed(1),
                pipeline=kind == "pipelined")
            states[kind] = fns[kind].init_state()
        if (fns["serial"].n_groups, fns["pipelined"].n_groups) != (1, 2):
            raise RuntimeError("expected 1 and 2 groups")
        torch.cuda.synchronize()
        phase("host-pool-setup", t, f"{len(pools['serial']._procs)} + "
              f"{len(pools['pipelined']._procs)} worker processes started "
              "after the card's first use")

        def timed(run, state):
            torch.cuda.synchronize()
            begin = time.perf_counter()
            out = run(state)
            torch.cuda.synchronize()
            return out, time.perf_counter() - begin

        t = time.perf_counter()
        twin = StubGridTwin(W, device)
        device_fn = RolloutFn(config, twin, model,
                              torch.Generator(device).manual_seed(1))
        (_, device_batch), device_s = timed(device_fn, device_fn.init_state())
        # Serial and pipelined in turns (s, p, p, s); each pair of equal
        # turns starts from equal states.
        secs = {"serial": [], "pipelined": []}
        held = []
        for turn in (("serial", "pipelined"), ("pipelined", "serial")):
            batches = {}
            for kind in turn:
                (states[kind], batches[kind]), sec = timed(fns[kind],
                                                           states[kind])
                secs[kind].append(sec)
            if not held:
                held.append(hold_host_batch(batches["serial"], device_batch,
                                            "host against device"))
                del device_batch
            held.append(hold_host_batch(batches["pipelined"],
                                        batches["serial"],
                                        f"pipelined against serial "
                                        f"{len(held)}"))
            host_batch = batches["serial"]
            del batches
        steps = W * config.worker_steps
        mean = {kind: sum(v) / len(v) for kind, v in secs.items()}
        phase("host-pool", t,
              "; ".join(held) + f"; rollout s: device env {device_s:.2f}, "
              + ", ".join(f"{kind} {' '.join(f'{x:.2f}' for x in v)}"
                          for kind, v in secs.items())
              + "; env-steps/s of a rollout: " + ", ".join(
                  f"{kind} {steps / m:.0f}" for kind, m in mean.items())
              + f", device env {steps / device_s:.0f}; pipelined/serial "
              f"{mean['pipelined'] / mean['serial']:.3f}")

        t = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            with trace(tmp):
                with annotate("rollout"):
                    states["pipelined"], _ = fns["pipelined"](
                        states["pipelined"])
                torch.cuda.synchronize()
            shares = device_busy(os.path.join(tmp, TRACE_FILE), ["rollout"])
        busy = shares["rollout"]
        if busy["busy_s"] <= 0:
            raise RuntimeError("host-pool: the trace holds no device "
                           "activity")
        phase("host-pool-busy", t,
              f"traced pipelined rollout: device busy "
              f"{busy['busy_share'] * 100:.1f}% of {busy['wall_s']:.3f}s "
              f"({busy['busy_s']:.3f}s busy); over the untraced pipelined "
              f"mean {busy['busy_s'] / mean['pipelined'] * 100:.1f}% of "
              f"{mean['pipelined']:.3f}s")
    finally:
        for pool in pools.values():
            pool.close()

    t = time.perf_counter()
    update = PPOUpdate(config, model, STUB_MAX_STEPS,
                       torch.Generator(device).manual_seed(2))
    stats, _ = update(host_batch, 1e-4, 0.1, 0.001)
    torch.cuda.synchronize()
    update_s = time.perf_counter() - t
    if not bool(torch.isfinite(stats).all()):
        raise RuntimeError(f"host-pool: non-finite stats {stats.tolist()}")
    check_launches((k[NAMES[0]], k[NAMES[1]]), FLAGSHIP_LAUNCHES,
                   "host-pool")
    check_launches((k[NAMES[2]], k[NAMES[3]]), 0, "host-pool")
    phase("host-pool-update", t,
          f"one PPO update on the serial host batch with the kernel pair in "
          f"{update_s:.2f}s, launches fwd {k[NAMES[0]].launches} bwd "
          f"{k[NAMES[1]].launches}; stats finite")
    return [k[n].launches for n in NAMES]



# --- phases 16-18: the trainer options and --debug-nans ----------------------

HEADROOM_LAUNCHES = 48         # per update: 2 blocks x 3 epochs x 8 minibatches
HEADROOM_SERVE_STEPS = 12
BF16_ULP = 2.0 ** -7
# A bfloat16 artifact served against its raw-memory formulation: the two
# compute the same bfloat16 products in other shapes, so a GEMM may round
# an element to the neighbouring bfloat16 value (2^-8 of it), and a few such
# roundings through the blocks move a value by a few ulps: values within 4
# ulps (2^-5) of the largest (at least 1); actions equal away from near
# ties (hold_raw_memory's near_ties).
SERVE_BF16_RTOL = 2.0 ** -5
# obs_uint8 against float obs: the uint8 run's first update against the
# float run's on the obs it reads back (its batch obs quantized, then
# divided by 255), so that the two updates read the same values and differ
# only by the storage path and B2's and cuDNN's atomics; later minibatches
# start from parameters that AdamW moved apart by up to lr where a gradient
# is at noise level. Each stat within 5% of the float run's plus 1e-3 (the
# KL and the clip fraction lie near 0). Against the float run on its own
# float obs, the half-level quantization (up to 1/510 on 7% of the pixels)
# makes update 1's clip fraction land 5-10% apart with the capturable AdamW
# and 1-3% apart with the non-capturable one, in the code before the fused
# launch as after it (PERF.md §6): it measures the optimizer's last bits, so
# it is not the held comparison.
UINT8_STAT_RTOL, UINT8_STAT_ATOL = 0.05, 1e-3


def _assert_bf16_close(got, ref, ref32, what: str) -> str:
    """``max|got - ref| <= 2 * max|ref - ref32| + 2^-7 * max|ref32|``: two
    bfloat16 computations of one function (through the kernels and through
    their plain versions, the same float32 casts around both) differ by at
    most twice bfloat16's own distance from float32 (the same model in
    float32) plus one bfloat16 ulp of the largest value, the criterion of
    tests/test_torch_mixed_precision.py. The kernels differ from the plain
    versions by float32 rounding only, so a flipped bfloat16 rounding after
    the cast back is what they can add."""
    err = (got - ref).abs().max().item()
    bound = (2 * (ref - ref32).abs().max().item()
             + BF16_ULP * ref32.abs().max().item())
    if not err <= bound:
        raise RuntimeError(f"{what}: max diff {err} > {bound}")
    return f"{what} diff {err:.3e} (bound {bound:.3e})"


def bf16_minibatch_agreement(trainer, batch) -> str:
    """One minibatch of ``batch`` (``trainer`` computes in bfloat16): loss
    and gradients through the kernel pair, through the plain versions, and
    through the plain versions in a float32 copy of the model, held by
    ``_assert_bf16_close``."""
    from etmppo_tpu_torch.models.actor_critic import ActorCriticModel
    from etmppo_tpu_torch.training.ppo import PPOUpdate
    upd, cfg = trainer.update_fn, trainer.config
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    model32 = ActorCriticModel(cfg32, trainer.env.observation_shape,
                               trainer.env.action_branches,
                               trainer.max_episode_steps,
                               device=trainer.device)
    model32.load_state_dict(trainer.model.state_dict())
    upd32 = PPOUpdate(cfg32, model32, trainer.max_episode_steps, None)
    gen = torch.Generator(trainer.device).manual_seed(7)
    idx = torch.randperm(cfg.batch_size, generator=gen,
                         device=trainer.device)[:cfg.mini_batch_size]
    kernels = (upd.kernel, upd.backward_kernel)
    results = []
    for u, pair in ((upd, kernels), (upd, (None, None)),
                    (upd32, (None, None))):
        timeline, slots, fields = u.prepare_timeline(batch)
        u.kernel, u.backward_kernel = pair
        u.model.zero_grad(set_to_none=True)
        loss, _ = u.loss_timeline(u.minibatch(fields, idx), timeline, slots,
                                  0.1, 0.001)
        loss.backward()
        results.append((loss.detach().reshape(1), torch.cat(
            [p.grad.reshape(-1) for p in u.model.parameters()])))
        u.model.zero_grad(set_to_none=True)
    upd.kernel, upd.backward_kernel = kernels
    (loss_k, grad_k), (loss_p, grad_p), (loss_32, grad_32) = results
    if not (torch.isfinite(loss_k).all() and torch.isfinite(grad_k).all()):
        raise RuntimeError("bf16 minibatch: loss or gradients not finite")
    return (_assert_bf16_close(loss_k, loss_p, loss_32, "loss") + "; "
            + _assert_bf16_close(grad_k, grad_p, grad_32, "gradients")
            + f" (bf16 loss {loss_k.item():.6f}, fp32 {loss_32.item():.6f})")


def split_in_turns(trainers: dict, pair) -> tuple:
    """One more rollout of each trainer, timed, then one PPO update of each
    on its batch with the kernel ``pair`` in turns (a, b, b, a). Returns
    (phase start, detail, (rollout seconds, mean update seconds), batches),
    each by name."""
    t = time.perf_counter()
    batches, rollout_s = {}, {}
    for name, trainer in trainers.items():
        tr = time.perf_counter()
        _, batches[name] = trainer.rollout_fn(trainer.rollout_state)
        torch.cuda.synchronize()
        rollout_s[name] = time.perf_counter() - tr
    turns = list(trainers) + list(trainers)[::-1]
    secs = [update_seconds(trainers[n], batches[n], pair) for n in turns]
    mean = {n: sum(s for m, s in zip(turns, secs) if m == n) / 2
            for n in trainers}
    return t, ("rollout " + ", ".join(f"{n} {s:.2f}s"
                                      for n, s in rollout_s.items())
               + "; ppo update in turns " + ", ".join(
                   f"{n} {s:.3f}" for n, s in zip(turns, secs))
               + "s; mean " + ", ".join(f"{n} {m:.3f}s"
                                        for n, m in mean.items())), (
        rollout_s, mean), batches


def traced_update(trainer, batch, pair, log_dir: str) -> tuple:
    """One PPO update of ``trainer`` on ``batch`` with the kernel ``pair``
    under ``utils/profiling.trace`` with input shapes (the update alone: a
    rollout's events would take minutes to group). Returns its
    ``device_busy`` shares, and the device ms and the calls of
    ``aten::copy_`` on tensors of the timeline's per-block shape (W, S, D):
    in a bfloat16 update, the float32 casts of the timeline K/V at the
    kernels' boundary and the bfloat16 casts of their gradients, and the
    casts of the pre-LN ``norm_kv`` output and its gradient; in both dtypes,
    LayerNorm's copy of its strided input."""
    from etmppo_tpu_torch.utils.profiling import (TRACE_FILE, annotate,
                                                  device_busy, trace)
    cfg, trx = trainer.config, trainer.config.transformer
    shape = [cfg.n_workers, trainer.max_episode_steps + cfg.worker_steps
             + trx.memory_length, trx.embed_dim]
    upd = trainer.update_fn
    kept = upd.kernel, upd.backward_kernel
    upd.kernel, upd.backward_kernel = pair
    with trace(log_dir, record_shapes=True) as prof:
        with annotate("ppo_update"):
            upd(batch, 1e-4, 0.1, 0.001)
            torch.cuda.synchronize()
    upd.kernel, upd.backward_kernel = kept
    ms, calls = 0.0, 0
    for e in prof.key_averages(group_by_input_shape=True):
        shapes = e.input_shapes or []
        if e.key == "aten::copy_" and shapes and list(shapes[0]) == shape:
            ms += e.self_device_time_total / 1e3
            calls += e.count
    busy = device_busy(os.path.join(log_dir, TRACE_FILE), ["ppo_update"])
    return busy["ppo_update"], ms, calls


def boundary_cast_ms(trainer) -> float:
    """Device ms a bfloat16 PPO update of ``trainer`` spends in the float32
    casts at the window-attention kernels' boundary, each cast timed alone
    at its shape: per block and minibatch, the timeline K and V (W, S, D)
    and the PE K and V (P, D) to float32 and their gradients back to
    bfloat16, q (B, D) to float32 and the output back, and the same two in
    the backward."""
    cfg, trx = trainer.config, trainer.config.transformer
    W, D = cfg.n_workers, trx.embed_dim
    S = trainer.max_episode_steps + cfg.worker_steps + trx.memory_length
    total = 0.0
    for shape, count in (((W, S, D), 2), ((trainer.max_episode_steps, D), 2),
                         ((cfg.mini_batch_size, D), 2)):
        x = torch.randn(shape, device=trainer.device)
        x16 = x.to(torch.bfloat16)
        total += count * (cuda_ms(lambda: x16.float())
                          + cuda_ms(lambda: x.to(torch.bfloat16)))
    return total * trx.num_blocks * cfg.epochs * cfg.n_mini_batch


def run_headroom(device, k) -> list:
    """Phase 16: headroom_768.yaml at full width (Mystery Path Grid, 32 x
    512, TrXL 2 x 768, 6 heads, memory 96) in float32 and in bfloat16;
    returns the launches of the counted runs (two updates of each), in the
    order of NAMES."""
    from etmppo_tpu_torch.config import HEADROOM_768, config_from_dict
    from etmppo_tpu_torch.serve import PolicyServer
    from etmppo_tpu_torch.training.trainer import PPOTrainer
    t = time.perf_counter()
    pair = (k[NAMES[0]], k[NAMES[1]])
    expected = {n: HEADROOM_LAUNCHES for n in NAMES[:2]}
    trainers, per_update, shares = {}, {}, {}
    launches = [0] * len(NAMES)
    with tempfile.TemporaryDirectory() as tmp:
        try:
            for dtype in ("float32", "bfloat16"):
                config = dataclasses.replace(
                    config_from_dict(HEADROOM_768), updates=UPDATES,
                    compute_dtype=dtype, summary_dir=tmp, checkpoint_dir=tmp)
                trainer = trainers[dtype] = PPOTrainer(
                    config, run_id=f"headroom_{dtype}", device=device)
                torch.cuda.synchronize()
                phase("headroom-setup", t, f"{dtype}: " + kernel_shape(
                    trainer, "headroom"))
                t = time.perf_counter()
                # the bf16 run's second update traced (a full update's
                # trace takes the host about a minute to write and read)
                per_update[dtype], shares[dtype], _ = train_counted(
                    trainer, k, f"headroom {dtype}", expected,
                    os.path.join(tmp, "trace") if dtype == "bfloat16"
                    else None)
                launches = [a + k[n].launches
                            for a, n in zip(launches, NAMES)]
                params = {p.dtype for p in trainer.model.parameters()}
                if params != {torch.float32}:
                    raise RuntimeError(f"headroom {dtype}: parameters {params}")
                phase("headroom", t,
                      f"{dtype}: {UPDATES} updates, launches fwd "
                      f"{k[NAMES[0]].launches} bwd {k[NAMES[1]].launches}; "
                      "s/update " + " ".join(f"{s:.2f}"
                                             for s in per_update[dtype])
                      + (" (update 2 traced)" if shares[dtype] else "")
                      + "; parameters float32")
                t = time.perf_counter()
            bf16 = trainers["bfloat16"]
            if bf16.model.compute_dtype != torch.bfloat16:
                raise RuntimeError("headroom: the bf16 model is not bf16")
            _, batch = bf16.rollout_fn(bf16.rollout_state)
            phase("headroom-check", t, bf16_minibatch_agreement(bf16, batch))
            del batch
            t, detail, (rollout_s, mean), batches = split_in_turns(
                trainers, pair)
            phase("headroom-split", t, detail)
            t = time.perf_counter()
            traced = {d: traced_update(trainer, batches[d], pair,
                                       os.path.join(tmp, f"update_{d}"))
                      for d, trainer in trainers.items()}
            phase("headroom-busy", t, "bfloat16: " + busy_line(
                per_update["bfloat16"][1], shares["bfloat16"],
                rollout_s["bfloat16"], mean["bfloat16"]) + "; " + "; ".join(
                f"{d}: a traced PPO update, device busy "
                f"{busy['busy_share'] * 100:.1f}% of {busy['wall_s']:.3f}s, "
                f"{busy['busy_s'] / mean[d] * 100:.1f}% of the untraced "
                f"{mean[d]:.3f}s; aten::copy_ of (W, S, D) tensors {ms:.3f} "
                f"ms in {calls} calls" for d, (busy, ms, calls)
                in traced.items())
                + f"; the boundary casts, each timed alone: "
                  f"{boundary_cast_ms(bf16):.3f} ms of device time a bf16 "
                  "update")
            for d, trainer in trainers.items():
                t = time.perf_counter()
                phase("headroom-mfu", t, f"{d}: " + update_mfu(
                    trainer, batches[d], mean[d]))
            del batches
            t = time.perf_counter()
            bf16._save_model()
            path = os.path.join(tmp, "headroom_bfloat16.nn")
            for kernel in k.values():
                kernel.launches = 0
            server = PolicyServer(path, SERVE_STREAMS, greedy=True,
                                  device=device)
            if server.model.compute_dtype != torch.bfloat16:
                raise RuntimeError("headroom: the served model is not bf16")
            detail = hold_raw_memory(server, HEADROOM_SERVE_STEPS,
                                     torch.Generator(device).manual_seed(0),
                                     rtol=SERVE_BF16_RTOL, near_ties=True)
            check_launches(k.values(), 0, "headroom serve")
            phase("headroom-serve", t,
                  f"headroom_bfloat16.nn (bf16, M={SERVE_STREAMS}): {detail};"
                  " no kernel launched")
        finally:
            for trainer in trainers.values():
                trainer.close()
    return launches


def run_obs_uint8(device, k) -> list:
    """Phase 17: the MiniGrid flagship with obs_uint8 at full width beside
    the same config with float obs; returns the launches of the counted
    run, in the order of NAMES."""
    from etmppo_tpu_torch.config import MINIGRID_FLAGSHIP, config_from_dict
    from etmppo_tpu_torch.training.ppo import STAT_NAMES
    from etmppo_tpu_torch.training.rollout import quantize_obs
    from etmppo_tpu_torch.training.trainer import PPOTrainer
    t = time.perf_counter()
    trainers = {}
    with tempfile.TemporaryDirectory() as tmp:
        try:
            for obs_uint8 in (False, True):
                config = dataclasses.replace(
                    config_from_dict(MINIGRID_FLAGSHIP), updates=UPDATES,
                    obs_uint8=obs_uint8, summary_dir=tmp, checkpoint_dir=tmp)
                trainers[obs_uint8] = PPOTrainer(
                    config, run_id=f"uint8_{obs_uint8}", device=device)
            batches = {u: tr.rollout_fn(tr.rollout_state)[1]
                       for u, tr in trainers.items()}
            obs32, obs8 = batches[False].obs, batches[True].obs
            if obs8.dtype != torch.uint8 or not torch.equal(
                    obs8, quantize_obs(obs32)):
                raise RuntimeError("obs-uint8: the batch obs are not the "
                                   "float run's quantized")
            same = all(torch.equal(getattr(batches[False], f),
                                   getattr(batches[True], f))
                       for f in ("values", "actions", "tape"))
            phase("obs-uint8-batch", t,
                  f"batch obs uint8 equal round(obs * 255).clamp(0, 255) of "
                  f"the float run's rollout from the same seeds; "
                  f"{obs32.nbytes / 1e6:.1f} MB float32 against "
                  f"{obs8.nbytes / 1e6:.1f} MB uint8; values, actions and "
                  f"tape {'equal' if same else 'differ'}")
            del batches, obs32, obs8
            # The float run's first update reads what the uint8 run's reads
            # back (UINT8_STAT_RTOL's comment).
            rollout = trainers[False].rollout_fn

            def read_back(state):
                final, batch = rollout(state)
                return final, batch._replace(
                    obs=quantize_obs(batch.obs).float() / 255.0)
            trainers[False].rollout_fn = read_back
            t = time.perf_counter()
            first32 = trainers[False].train_one_update()
            torch.cuda.synchronize()
            float_s = time.perf_counter() - t
            trainers[False].rollout_fn = rollout
            t = time.perf_counter()
            per_update, _, results = train_counted(
                trainers[True], k, "obs-uint8",
                {n: FLAGSHIP_LAUNCHES for n in NAMES[:2]})
            launches = [k[n].launches for n in NAMES]
            first8 = results[0]
            worst = 0.0
            for name in STAT_NAMES:
                err = abs(first8[name] - first32[name])
                tol = UINT8_STAT_RTOL * abs(first32[name]) + UINT8_STAT_ATOL
                if not err <= tol:
                    raise RuntimeError(f"obs-uint8: update 1 {name} "
                                       f"{first8[name]} vs float "
                                       f"{first32[name]} (tol {tol})")
                worst = max(worst, err / tol)
            phase("obs-uint8", t,
                  f"{UPDATES} updates, launches fwd {launches[0]} bwd "
                  f"{launches[1]}; s/update " + " ".join(
                      f"{s:.2f}" for s in per_update)
                  + f" (float obs: update 1 {float_s:.2f}s); update 1 stats "
                  f"within {worst:.2f} of their tolerance of the float run's "
                  "on the obs read back from uint8 (loss "
                  f"{first8['loss']:.6f} vs {first32['loss']:.6f})")
            phase("obs-uint8-split", *split_in_turns(
                {"float obs": trainers[False], "uint8 obs": trainers[True]},
                (k[NAMES[0]], k[NAMES[1]]))[:2])
        finally:
            for trainer in trainers.values():
                trainer.close()
    return launches


def run_debug_nans(device, k) -> list:
    """Phase 18: --debug-nans (utils/runtime.set_debug_nans) on the MiniGrid
    flagship at full width: an unchecked update, one under the checks (stats
    finite, the kernel pair launched as always), then one with a NaN
    learning rate, which must raise FloatingPointError; returns the
    launches of the checked update, in the order of NAMES."""
    from etmppo_tpu_torch.config import (MINIGRID_FLAGSHIP, ScheduleConfig,
                                         config_from_dict)
    from etmppo_tpu_torch.training.trainer import PPOTrainer
    from etmppo_tpu_torch.utils import runtime
    t = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        config = dataclasses.replace(
            config_from_dict(MINIGRID_FLAGSHIP), summary_dir=tmp,
            checkpoint_dir=tmp)
        trainer = PPOTrainer(config, run_id="debug_nans", device=device)
        try:
            seconds = {}
            for checked in (False, True):
                if checked:
                    runtime.set_debug_nans(True)
                    runtime.name_modules(trainer.model)
                for kernel in k.values():
                    kernel.launches = 0
                tu = time.perf_counter()
                stats = trainer.train_one_update()
                torch.cuda.synchronize()
                seconds[checked] = time.perf_counter() - tu
                bad = {n: v for n, v in stats.items() if not math.isfinite(v)}
                if bad:
                    raise RuntimeError(f"debug-nans: non-finite stats {bad}")
                check_launches((k[NAMES[0]], k[NAMES[1]]), FLAGSHIP_LAUNCHES,
                               "debug-nans")
                check_launches((k[NAMES[2]], k[NAMES[3]]), 0, "debug-nans")
            launches = [k[n].launches for n in NAMES]
            phase("debug-nans", t,
                  f"a flagship update under the checks {seconds[True]:.2f}s "
                  f"(unchecked {seconds[False]:.2f}s, "
                  f"{seconds[True] / seconds[False]:.2f}x), launches fwd "
                  f"{launches[0]} bwd {launches[1]}, stats finite")
            t = time.perf_counter()
            nan = float("nan")
            trainer.config = dataclasses.replace(
                config, learning_rate_schedule=ScheduleConfig(nan, nan))
            try:
                trainer.train_one_update()
            except FloatingPointError as e:
                raised = str(e)
            else:
                raise RuntimeError("debug-nans: a NaN learning rate did not "
                                   "raise FloatingPointError")
            phase("debug-nans-raise", t,
                  f"a NaN learning rate raised FloatingPointError in its "
                  f"first update: {raised[:160]}")
        finally:
            runtime.set_debug_nans(False)
            trainer.close()
    if runtime.debug_nans_enabled() or torch.is_anomaly_enabled():
        raise RuntimeError("debug-nans: the checks outlived the phase")
    return launches


# --- phase 19: data parallelism ---------------------------------------------

DP_RANKS = 2                   # gloo ranks sharing the card
DP_UPDATES = 2
# The ranks take the one-device run's actions in update 1 (``probe.Replay``),
# so update 1's batch is one device's by construction and its check always
# holds. A rank computes its W/N rows where one device computes W: cuBLAS
# and cuDNN may pick other kernels for the other shapes, so the values
# differ in the last bits, which the memory carries through the rollout. The
# action a rank draws itself (it draws them all the same) may then differ
# from one device's only at a near tie: a Gumbel-max margin (the gap
# between the two largest perturbed logits) under DP_TIE_ATOL in either run.
DP_TIE_ATOL = 1e-4
DP_VALUE_RTOL = 1e-4           # of max(1, |value|)
# The first minibatch's clipped gradients, before any AdamW step: within
# GRAD_RTOL of the largest. After the update's 40 steps, AdamW has turned
# noise-level gradient signs into steps of about the learning rate (B2's
# and cuDNN's atomics make even two one-device updates differ, ROADMAP §C):
# every parameter within 2 lr a step; the stats, relative and absolute,
# the losses and the entropy as tests/test_torch_training.py's full update
# holds them (policy_loss, a mean near 0, by the absolute term), kl and the
# clip fraction (means of functions of the probability ratio, which move
# most with the parameters' last bits) to 5%. PERF.md gives the readings of
# sound runs and of two known-wrong updates (``dp_known_wrong``) beside
# these limits.
DP_STATS_TOL = {"policy_loss": (1e-3, 1e-4), "value_loss": (1e-3, 1e-4),
                "loss": (1e-3, 1e-4), "entropy": (1e-3, 1e-4),
                "kl": (5e-2, 1e-4), "clip_fraction": (5e-2, 1e-4)}
DP_SCALING_UPDATES = 3         # N = 1, 2, 4 on their own cards: updates 2-3 timed


def check_counts(counts: dict, expected: dict, label: str) -> None:
    """Launches of each kernel (a rank's in one update, ``probe.train``'s
    ``launches``, or a fused run's) against ``expected`` (name -> launches;
    every other kernel never)."""
    for name in NAMES:
        if counts[name] != expected.get(name, 0):
            raise RuntimeError(f"{label}: {name} launched {counts[name]} "
                               f"times, expected {expected.get(name, 0)}")


def hold_ranks_replicated(ranks, label: str) -> None:
    """The ranks' parameters bit-identical after every update: their digests
    and, where kept, the parameters."""
    for r in ranks[1:]:
        for u, digest in enumerate(ranks[0]["digests"]):
            if not torch.equal(r["digests"][u], digest):
                raise RuntimeError(f"{label}: rank {r['rank']}'s parameters "
                                   f"differ from rank 0's after update {u}")
        for u, params in enumerate(ranks[0]["params"]):
            _assert_same(params, r["params"][u], f"{label} update {u}")


def hold_rows(ranks, one, n_workers: int, T: int) -> str:
    """Each rank's rows of update 1's rollout against the one-device run's:
    the actions it took are one device's (replayed); the actions it drew
    itself equal one device's except at near ties (a margin under
    DP_TIE_ATOL in either run); the values within DP_VALUE_RTOL. Returns
    the detail."""
    per = n_workers // len(ranks)
    ties, worst = [], 0.0
    for r in ranks:
        rows = slice(r["rank"] * per, (r["rank"] + 1) * per)
        b, o = r["batch"], {k: v[rows] for k, v in one["batch"].items()}
        if not torch.equal(b["actions"], o["actions"]):
            raise RuntimeError(f"data-parallel: rank {r['rank']} did not "
                               "take the one-device run's actions")
        differ = (b["sampled"] != o["actions"]).reshape(per, T, -1).any(-1)
        for w, t in differ.nonzero().tolist():
            margin = min(float(b["margins"][w, t]), float(o["margins"][w, t]))
            if margin > DP_TIE_ATOL:
                raise RuntimeError(
                    f"data-parallel: worker {rows.start + w}'s action at "
                    f"step {t} differs from one device's, clear of a tie "
                    f"(margin {margin:.3e})")
            ties.append((rows.start + w, t, margin))
        scale = o["values"].abs().amax(dim=1).clamp(min=1.0)
        err = float(((b["values"] - o["values"]).abs().amax(dim=1)
                     / scale).max())
        if err > DP_VALUE_RTOL:
            raise RuntimeError(f"data-parallel: rank {r['rank']}'s values "
                               f"differ from one device's by {err:.3e} of "
                               "max(1, |v|)")
        worst = max(worst, err)
    return (f"rollout rows (one device's actions taken): the ranks' own "
            f"draws equal one device's in {n_workers * T - len(ties)} of "
            f"{n_workers * T} worker-steps, the rest near ties"
            + (" (" + ", ".join(f"w{w} t{t} margin {m:.1e}"
                                for w, t, m in ties[:8]) + ")" if ties else "")
            + f"; values within {worst:.2e} of max(1, |v|)")


def read_limits(got: dict, want: dict, config) -> tuple:
    """Update 1's limits read for ``got`` against ``want`` (each a dict of
    ``stats`` (name -> float), ``first_grads`` and ``params`` (name ->
    tensor)). Returns (what is out of its limit, detail)."""
    bad, stats = [], []
    for key, (rtol, atol) in DP_STATS_TOL.items():
        g, w = got["stats"][key], want["stats"][key]
        limit = rtol * abs(w) + atol
        stats.append(f"{key} {g:.6g} / {w:.6g} ({abs(g - w) / limit:.2g} "
                     "of its limit)")
        if not abs(g - w) <= limit:
            bad.append(f"{key} (tol {rtol:g} relative + {atol:g})")
    grad_err = max(float((got["first_grads"][n] - g).abs().max())
                   for n, g in want["first_grads"].items())
    grad_max = max(float(g.abs().max())
                   for g in want["first_grads"].values())
    if not grad_err <= GRAD_RTOL * grad_max:
        bad.append(f"the first minibatch's gradients (tol {GRAD_RTOL:g} of "
                   "the largest)")
    diffs = torch.cat([(got["params"][n] - p).abs().reshape(-1)
                       for n, p in want["params"].items()])
    steps = config.epochs * config.n_mini_batch
    lr = config.learning_rate_schedule.value(0)
    q99 = float(diffs.sort().values[int(0.99 * (diffs.numel() - 1))])
    if float(diffs.max()) > 2 * lr * steps:
        bad.append(f"the largest parameter difference (tol 2 lr x {steps} "
                   f"= {2 * lr * steps:.2e})")
    return bad, (f"first minibatch's gradients within {grad_err:.2e} of the "
                 f"largest {grad_max:.2e} ({grad_err / grad_max:.2e}, limit "
                 f"{GRAD_RTOL:g}); " + ", ".join(stats) + f"; parameters max "
                 f"{float(diffs.max()):.2e} (limit 2 lr x {steps} = "
                 f"{2 * lr * steps:.2e}), 99% within {q99:.2e}")


def update_one(r) -> dict:
    """A ``probe.train`` result's update 1, for ``read_limits``."""
    return dict(stats=r["results"][0], first_grads=r["first_grads"],
                params=r["params"][0])


def dp_known_wrong(config, device) -> str:
    """Update 1's limits read for the data-parallel update and for two
    known-wrong ones, each emulated here on one device from the same
    parameters, batch and permutations, against the one-device update:
    ``sound`` sums DP_RANKS ranks' parts of every minibatch, each with the
    global minibatch's advantage statistics and count (what the ranks
    compute); ``local statistics`` takes each rank's part as a minibatch of
    its own and averages over the ranks (a per-shard approximation); ``no
    all-reduce`` steps on rank 0's part alone. Fails unless the sound one
    holds the gradient and parameter limits (its stats are read, not held:
    B2's and cuDNN's atomics move the one-device update's clip fraction by
    up to 3.8%, 0.75 of its limit) and each wrong one breaks a limit.
    Returns the detail."""
    from etmppo_tpu_torch.training.ppo import STAT_NAMES, clip_grads_torch
    from etmppo_tpu_torch.training.trainer import PPOTrainer
    cfg = dataclasses.replace(config, num_devices=1)
    trainer = PPOTrainer(cfg, run_id="dpwrong", device=device,
                         enable_metrics=False)
    try:
        upd, model = trainer.update_fn, trainer.model
        _, batch = trainer.rollout_fn(trainer.rollout_state)
        lr, clip, beta = (s.value(0) for s in (cfg.learning_rate_schedule,
                                                cfg.clip_range_schedule,
                                                cfg.beta_schedule))
        perms = torch.stack([
            torch.randperm(cfg.batch_size, generator=upd.generator,
                           device=device) for _ in range(cfg.epochs)])
        start = copy.deepcopy((model.state_dict(),
                               upd.optimizer.state_dict()))
        memory, slots, fields = upd.prepare(batch)
        per_rank = cfg.n_workers // DP_RANKS * cfg.worker_steps

        def emulated(variant):
            ranks = range(1 if variant == "no all-reduce" else DP_RANKS)
            for group in upd.optimizer.param_groups:
                group["lr"] = lr
            mbs = perms.reshape(cfg.epochs * cfg.n_mini_batch, -1)
            stats = torch.zeros(len(STAT_NAMES), device=device)
            for idx in mbs:
                upd.optimizer.zero_grad(set_to_none=True)
                for r in ranks:
                    part = idx[idx // per_rank == r]
                    if variant == "local statistics":
                        mb, scale = upd.minibatch(fields, part), 1 / DP_RANKS
                    else:
                        mb = upd.minibatch(fields, part,
                                           fields["advantages"][idx])
                        scale = 1.0
                    loss, s = upd.loss(mb, memory, slots, clip, beta)
                    (loss * scale).backward()
                    stats += s * scale
                clip_grads_torch(model, cfg.max_grad_norm)
                upd.optimizer.step()
            return stats / len(mbs)

        def update(variant) -> dict:
            model.load_state_dict(start[0])
            upd.optimizer.load_state_dict(start[1])
            grads: list = []

            def keep(optimizer, args, kwargs):
                grads.append({n: p.grad.detach().cpu().clone()
                              for n, p in model.named_parameters()})
                hook.remove()
            hook = upd.optimizer.register_step_pre_hook(keep)
            stats = (upd(batch, lr, clip, beta, perms=perms)[0]
                     if variant == "one device" else emulated(variant))
            return dict(stats=dict(zip(STAT_NAMES, stats.tolist())),
                        first_grads=grads[0],
                        params={n: p.detach().cpu().clone()
                                for n, p in model.named_parameters()})
        want = update("one device")
        details = []
        for variant in ("sound", "local statistics", "no all-reduce"):
            bad, detail = read_limits(update(variant), want, cfg)
            details.append(f"{variant}: {detail}")
            if variant == "sound":
                # Its stats are one more draw of the atomics' noise, which
                # the ranks' own check below already holds: read, not held.
                bad = [b for b in bad if b.split()[0] not in DP_STATS_TOL]
            if (variant == "sound") != (not bad):
                raise RuntimeError(
                    f"data-parallel known-wrong: the {variant} update "
                    + (f"breaks {', '.join(bad)}" if bad
                       else "holds every limit"))
        return "; ".join(details)
    finally:
        trainer.close()


def traffic_line(r) -> str:
    """A rank's seconds and collectives (a collective's seconds include the
    wait for the slower rank)."""
    tr, sec = r["traffic"], r["seconds"]
    per_mb = tr["gradients"]
    n_up = len(sec["ppo_update"])
    gathers = [name for name in ("advantages", "episode rows",
                                 "replica check") if name in tr]
    return (f"rank {r['rank']}: rollout s " + " ".join(
        f"{s:.2f}" for s in sec["rollout"]) + ", ppo update s " + " ".join(
        f"{s:.2f}" for s in sec["ppo_update"])
        + f"; all-reduce {per_mb['calls']} x "
        f"{per_mb['bytes'] / per_mb['calls'] / 1e6:.3f} MB, "
        f"{per_mb['seconds'] / per_mb['calls'] * 1e3:.3f} ms each; gathers "
        "per update " + ", ".join(
            f"{g} {tr[g]['bytes'] / n_up / 1e3:.1f} kB "
            f"{tr[g]['seconds'] / n_up * 1e3:.3f} ms" for g in gathers))


def run_data_parallel(device, k) -> list:
    """Phase 19: the MiniGrid flagship at full width on DP_RANKS gloo ranks
    sharing the card (8 workers each), DP_UPDATES updates, against a
    one-device trainer of the same seed run here; then a Mortar Mayhem
    Grid update with the grouped pair on the same ranks; with two or more
    cards, NCCL with a rank a card at N = 2 and 4 (scaling). Returns the
    ranks' launches summed, in the order of NAMES."""
    from etmppo_tpu_torch.config import (MINIGRID_FLAGSHIP, MORTAR_MAYHEM_GRID,
                                         config_from_dict)
    from etmppo_tpu_torch.parallel import probe
    from etmppo_tpu_torch.parallel.mesh import spawn
    from etmppo_tpu_torch.training.checkpoint import load_model
    t = time.perf_counter()
    backend = "gloo"
    print(f"data-parallel: {DP_RANKS} ranks on {device} with {backend} named "
          "(NCCL refuses two ranks on one card); spawned, each loading the "
          "kernels built above", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        flagship = dataclasses.replace(
            config_from_dict(MINIGRID_FLAGSHIP), updates=DP_UPDATES,
            num_devices=DP_RANKS, summary_dir=tmp, checkpoint_dir=tmp)
        mortar = dataclasses.replace(
            config_from_dict(MORTAR_MAYHEM_GRID), updates=1,
            num_devices=DP_RANKS, summary_dir=tmp, checkpoint_dir=tmp)
        W, T = flagship.n_workers, flagship.worker_steps
        fields = ("actions", "values")
        one = probe.train(None, dataclasses.replace(flagship, num_devices=1),
                          "one", updates=DP_UPDATES, batch_fields=fields,
                          device=device)
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
        phase("data-parallel-one-device", t, "one device: rollout s "
              + " ".join(f"{s:.2f}" for s in one["seconds"]["rollout"])
              + ", ppo update s " + " ".join(
                  f"{s:.2f}" for s in one["seconds"]["ppo_update"]))
        t = time.perf_counter()
        wrong = dp_known_wrong(flagship, device)
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
        phase("data-parallel-known-wrong", t, "update 1's limits read, "
              "emulated on one device against the one-device update: "
              + wrong)
        t = time.perf_counter()
        # Update 1 takes the one-device run's actions; the ranks draw their
        # own all the same, and hold_rows holds those to one device's.
        replay = probe.Replay(reset=None, actions=one["batch"]["actions"],
                              perms=None)
        # Then phase 21 on the same ranks: (a) and (c) on the grouped pair,
        # (b) the per-sample pair, its update 1 on the one-device actions.
        on_cpu = torch.device(device).type == "cpu"
        runs = [(probe.train, flagship, dict(
                    run_id="dp", updates=DP_UPDATES, batch_fields=fields,
                    timed_collectives=True, save_model=True, device=device,
                    replay=replay)),
                (probe.train, mortar, dict(
                    run_id="dpmmg", grouped=True, updates=1,
                    keep_params=False, device=device)),
                (probe.fused_against_eager, flagship, dict(
                    chunk=FM_CHUNK, chunks=FM_CHUNKS, grouped=True,
                    deterministic=True, device=device, stand_in=on_cpu,
                    perturb=(1, 1))),
                (probe.train, dataclasses.replace(
                    flagship, updates_per_launch=FM_LAUNCH), dict(
                    run_id="fmb", updates=FM_LAUNCH, chunk=FM_LAUNCH,
                    batch_fields=fields, device=device, replay=replay,
                    trace=True))]
        ranks = spawn(probe.train_runs, DP_RANKS, (runs,), device=device,
                      backend=backend, timeout=900, collective_timeout=300)
        spawned_s = time.perf_counter() - t
        dp = [r[0] for r in ranks]
        mmg = [r[1] for r in ranks]
        for r in dp:
            print("data-parallel " + traffic_line(r) + "; one device: "
                  "rollout s " + " ".join(
                      f"{s:.2f}" for s in one["seconds"]["rollout"])
                  + ", ppo update s " + " ".join(
                      f"{s:.2f}" for s in one["seconds"]["ppo_update"])
                  + " (two ranks share one card: not a scaling number)",
                  flush=True)
        for r in mmg:
            print("data-parallel mortarmayhem " + traffic_line(r), flush=True)
        for r in dp:
            for u, counts in enumerate(r["launches"]):
                check_counts(counts, {n: FLAGSHIP_LAUNCHES for n in NAMES[:2]},
                             f"data-parallel rank {r['rank']} update {u}")
            bad = {key: v for res in r["results"] for key, v in res.items()
                   if not math.isfinite(v)}
            if bad:
                raise RuntimeError(f"data-parallel rank {r['rank']}: "
                                   f"non-finite {bad}")
        for r in mmg:
            check_counts(r["launches"][0], {n: MORTAR_LAUNCHES
                                            for n in NAMES[2:]},
                         f"data-parallel mortarmayhem rank {r['rank']}")
        hold_ranks_replicated(dp, "data-parallel")
        hold_ranks_replicated(mmg, "data-parallel mortarmayhem")
        rows_detail = hold_rows(dp, one, W, T)
        bad, update_detail = read_limits(update_one(dp[0]), update_one(one),
                                         flagship)
        print(f"data-parallel check: {rows_detail}; update 1, ranks / one "
              f"device: {update_detail}", flush=True)
        if bad:
            raise RuntimeError("data-parallel: update 1 differs from one "
                               "device's in " + ", ".join(bad))
        model, _ = load_model(os.path.join(tmp, "dp.nn"), device)
        _assert_same({n: p.detach().cpu() for n, p in
                      model.named_parameters()}, dp[0]["params"][-1],
                     "data-parallel dp.nn")
        phase("data-parallel", t,
              f"MiniGrid flagship {W} x {T} on {DP_RANKS} ranks of "
              f"{W // DP_RANKS} workers, {DP_UPDATES} updates: launches per "
              "rank per update " + ", ".join(
                  f"fwd {c[NAMES[0]]} bwd {c[NAMES[1]]}"
                  for r in dp for c in r["launches"])
              + "; parameters bit-identical across ranks after each update; "
              f"{rows_detail}; update 1 within tolerance of one device's; "
              "dp.nn (rank 0) "
              "reloads to rank 0's parameters; Mortar Mayhem Grid 1 update "
              "grouped: " + ", ".join(
                  f"rank {r['rank']} fwd_grouped {r['launches'][0][NAMES[2]]}"
                  f" bwd_grouped {r['launches'][0][NAMES[3]]}" for r in mmg)
              + f", bit-identical; {spawned_s:.1f} s for the spawned ranks "
              "(phase 21's runs included)")
        fused_mesh = check_fused_mesh([r[2] for r in ranks],
                                      [r[3] for r in ranks], one, flagship)
    launches = [sum(u[name] for r in dp + mmg for u in r["launches"])
                for name in NAMES]
    if torch.device(device).type == "cuda" and torch.cuda.device_count() >= 2:
        run_dp_scaling(device)
    else:
        print("data-parallel scaling: one card visible; NCCL at N = 2 and 4 "
              "runs only where a call has two or more cards", flush=True)
    return launches, fused_mesh


def segment_line(capture: dict) -> str:
    """Each captured segment's nodes, pool and seconds."""
    return ", ".join(
        f"{name} {c['nodes']} nodes {c['pool_bytes'] / 2**20:.0f} MiB "
        f"capture {c['capture_s']:.2f}s instantiate {c['instantiate_s']:.2f}s"
        for name, c in capture.get("segments", {}).items())


def check_fused_mesh(grouped: list, per_sample: list, one: dict,
                     config) -> dict:
    """Phase 21 on phase 19's ranks (each rank's results of
    ``probe.fused_against_eager`` and of ``probe.train`` with a ``chunk``).
    Prints the phase and returns its launches (in the order of NAMES) and a
    rank's seconds for the rate line."""
    t = time.perf_counter()
    W, T = config.n_workers, config.worker_steps
    n = FM_CHUNK * FM_CHUNKS
    for rank, r in enumerate(grouped):
        label = f"fused-mesh rank {rank}"
        if r["route"] != "graph":
            raise RuntimeError(f"{label}: the route is {r['route']!r}")
        if r["mismatches"]:
            raise RuntimeError(f"{label}: the graph launches differ from the "
                               "eager mesh updates: "
                               + "; ".join(r["mismatches"][:8]))
        want = [[FLAGSHIP_LAUNCHES * FM_CHUNK] * 2] * FM_CHUNKS
        for route in ("eager", "fused"):
            if r["launches"][route] != want:
                raise RuntimeError(f"{label}: B3, B4 counted "
                                   f"{r['launches'][route]} on the {route} "
                                   f"route, expected {want}")
        if r["traffic"]["fused"] != r["traffic"]["eager"]:
            raise RuntimeError(f"{label}: the collectives differ: "
                               f"{r['traffic']}")
        expect = f"after update 2 of {FM_CHUNK} in this launch"
        if r["raised"] is None or expect not in r["raised"]:
            raise RuntimeError(f"{label}: the perturbed launch raised "
                               f"{r['raised']!r}, not {expect!r}")
    for a, b in zip(grouped[0]["digests"], grouped[1]["digests"]):
        if not torch.equal(a, b):
            raise RuntimeError("fused-mesh: the ranks' parameters differ")
    for rank, r in enumerate(per_sample):
        check_counts(r["launches"][0], {name: FLAGSHIP_LAUNCHES * FM_LAUNCH
                                        for name in NAMES[:2]},
                     f"fused-mesh per-sample rank {rank}")
        bad = {key: v for res in r["results"] for key, v in res.items()
               if not math.isfinite(v)}
        if bad:
            raise RuntimeError(f"fused-mesh per-sample rank {rank}: "
                               f"non-finite {bad}")
    hold_ranks_replicated(per_sample, "fused-mesh per-sample")
    rows_detail = hold_rows(per_sample, one, W, T)
    r0 = per_sample[0]
    bad, detail = read_limits(dict(stats=r0["results"][0],
                                   first_grads=r0["first_grads"],
                                   params=r0["first_params"]),
                              update_one(one), config)
    if bad:
        raise RuntimeError("fused-mesh: the per-sample launch's update 1 "
                           "differs from one device's in " + ", ".join(bad))
    g = grouped[0]
    seconds = {route: g["seconds"][route][-1] / FM_CHUNK
               for route in ("eager", "fused")}
    phase("fused-mesh", t,
          f"the flagship on {DP_RANKS} gloo ranks sharing the card, the "
          "graph route under a mesh (segments replayed, the collectives "
          "between them): (a) grouped pair, deterministic algorithms: "
          f"{FM_CHUNKS} launches of {FM_CHUNK} equal {n} eager mesh updates "
          "to the bit on each rank (actions, logged values, episode infos, "
          "parameters, optimizer, rollout state, generators), the ranks "
          "bit-identical, B3 and B4 counted "
          f"{g['launches']['fused']} a launch ({FLAGSHIP_LAUNCHES} an update "
          "on the replays), the collectives equal the eager route's "
          f"({traffic_calls(g['traffic']['fused'])}); rank 0's segments: "
          f"{segment_line(g['capture'])}; launch seconds graph "
          + " ".join(f"{x:.2f}" for x in g["seconds"]["fused"])
          + ", eager " + " ".join(f"{x:.2f}" for x in g["seconds"]["eager"])
          + f" (a replayed update {seconds['fused']:.3f} s, an eager mesh "
          f"update {seconds['eager']:.3f} s); (c) rank 1 flipped a bit "
          f"after update 1 of a launch: the launch raised \"{g['raised']}\";"
          f" (b) per-sample pair: one launch of {FM_LAUNCH}, B1 and B2 "
          f"counted {r0['launches'][0][NAMES[0]]} and "
          f"{r0['launches'][0][NAMES[1]]} a rank, in "
          f"{r0['seconds']['launch'][0]:.2f} s (warm-up, capture, "
          f"{FM_LAUNCH - 1} replays; segments {segment_line(r0['capture'])})"
          f"; {rows_detail}; update 1, ranks / one device: {detail}; rank 0's "
          "traced replay of one more update (its own kernels; phase 4's "
          "trainer-busy has one device's): rollout "
          f"{busy(r0['busy']['rollout'])}, PPO update "
          f"{busy(r0['busy']['ppo_update'])}")
    launches = [sum(r["launches"][0][name] for r in per_sample)
                for name in NAMES[:2]]
    launches += [sum(c[i] for r in grouped for route in ("eager", "fused")
                     for c in r["launches"][route]) for i in range(2)]
    return dict(launches=launches, seconds=seconds)


def traffic_calls(traffic: dict) -> str:
    return ", ".join(f"{label} {rec['calls']} x "
                     f"{rec['bytes'] / rec['calls'] / 1e6:.3f} MB"
                     for label, rec in traffic.items() if rec["calls"])


def fused_mesh_rate(fused_mesh: dict, one_device: dict, steps: int) -> None:
    """Phase 21's rate line, after phase 20: a rank's replayed update on
    the graph route under the mesh beside an eager mesh update and one
    device's replayed update, all the grouped flagship under deterministic
    algorithms in this call."""
    t = time.perf_counter()
    rates = dict(fused_mesh["seconds"], one_device=one_device["replay_s"])
    phase("fused-mesh-rate", t, "the flagship, grouped, deterministic, s per "
          f"update (env-steps/s of its {steps} steps): " + ", ".join(
              f"{name} {s:.3f} ({steps / s:.0f})" for name, s in (
                  ("graph route, a rank of 2 on one card", rates["fused"]),
                  ("eager mesh route, the same", rates["eager"]),
                  ("one device's graph route (phase 20)",
                   rates["one_device"])))
          + "; graph/eager under the mesh "
          f"{rates['eager'] / rates['fused']:.2f}x (two ranks share one "
          "card: not a scaling number)")


def run_dp_scaling(device, cards: int = 0) -> None:
    """With two or more cards: the flagship at N = 1 (here), 2 and 4 (NCCL,
    a rank a card, where there are that many), on the eager route
    DP_SCALING_UPDATES updates each (the steady env-steps/s of updates 2
    onward) and on the graph route two launches of FM_CHUNK (the steady
    env-steps/s of launch 2, replays only). On the CPU (a rehearsal) the
    ranks are gloo processes, ``cards`` of them at most, and the graph
    route is left out."""
    from etmppo_tpu_torch.config import MINIGRID_FLAGSHIP, config_from_dict
    from etmppo_tpu_torch.parallel import probe
    from etmppo_tpu_torch.parallel.mesh import spawn
    cuda = torch.device(device).type == "cuda"
    cards = torch.cuda.device_count() if cuda else cards
    with tempfile.TemporaryDirectory() as tmp:
        base = dataclasses.replace(
            config_from_dict(MINIGRID_FLAGSHIP), updates=DP_SCALING_UPDATES,
            summary_dir=tmp, checkpoint_dir=tmp)
        steps = base.n_workers * base.worker_steps
        for n in (1, 2, 4):
            if n > cards:
                continue
            t = time.perf_counter()
            cfg = dataclasses.replace(base, num_devices=n)
            kwargs = dict(run_id=f"scale{n}", updates=DP_SCALING_UPDATES,
                          keep_params=False, device=device)
            ranks = ([probe.train(None, cfg, **kwargs)] if n == 1 else
                     spawn(probe.train, n, (cfg,), kwargs=kwargs,
                           device="cuda" if cuda else "cpu", timeout=900,
                           collective_timeout=300))
            hold_ranks_replicated(ranks, f"scaling N={n}")
            for r in ranks:
                for u, counts in enumerate(r["launches"]):
                    check_counts(counts, {nm: FLAGSHIP_LAUNCHES
                                          for nm in NAMES[:2]},
                                 f"scaling N={n} rank {r['rank']} update {u}")
            per_update = [max(r["seconds"]["rollout"][u]
                              + r["seconds"]["ppo_update"][u] for r in ranks)
                          for u in range(DP_SCALING_UPDATES)]
            steady = steps * (DP_SCALING_UPDATES - 1) / sum(per_update[1:])
            backend = "nccl" if cuda else "gloo"
            detail = f"N={n} ({backend if n > 1 else 'one device'}): " + (
                "eager s/update " + " ".join(f"{s:.2f}" for s in per_update)
                + f"; steady env-steps/s {steady:.0f} (updates 2-"
                f"{DP_SCALING_UPDATES})")
            if n > 1:
                detail += "; " + "; ".join(traffic_line(r) for r in ranks)
            if cuda:
                kwargs = dict(run_id=f"scalegraph{n}",
                              updates=FM_CHUNK * 2, chunk=FM_CHUNK,
                              keep_params=False, device=device)
                cfg = dataclasses.replace(cfg, updates_per_launch=FM_CHUNK)
                graph = ([probe.train(None, cfg, **kwargs)] if n == 1 else
                         spawn(probe.train, n, (cfg,), kwargs=kwargs,
                               device="cuda", timeout=900,
                               collective_timeout=300))
                hold_ranks_replicated(graph, f"scaling N={n} graph")
                launch = max(r["seconds"]["launch"][1] for r in graph)
                detail += (f"; graph route: launches " + " ".join(
                    f"{max(r['seconds']['launch'][i] for r in graph):.2f}"
                    for i in range(2)) + " s; steady env-steps/s "
                    f"{steps * FM_CHUNK / launch:.0f} (launch 2)")
            phase("data-parallel-scaling", t, detail)


# Phase 21, run on phase 19's ranks: the graph route under a mesh.
FM_CHUNK = 2                   # (a): launches of 2 ...
FM_CHUNKS = 2                  # ... two of them, against 4 eager updates
FM_LAUNCH = 4                  # (b): one launch, the YAMLs' updates_per_launch


# --- phase 20: fused launches (training/fused.py) ---------------------------

# Updates a launch: the YAMLs' updates_per_launch is 4; 3 since phase 21
# came in, for the script's time.
FUSED_CHUNK = 3
FUSED_CHUNKS = 2
# B1's and B2's CUDA functions, as a profiler trace names them.
FUSED_KERNEL_NAMES = ("window_attention_fwd_kernel",
                      "window_attention_bwd_kernel")
# Updates a launch of the configurations held only to run on the graph route.
FUSED_ROUTE_UPDATES = 2


def same_results(eager: list, fused: list, label: str) -> None:
    """Every logged value of every update equal, to the bit."""
    for u, (a, b) in enumerate(zip(eager, fused, strict=True)):
        if a != b:
            diff = {k: (a.get(k), b.get(k)) for k in set(a) | set(b)
                    if a.get(k) != b.get(k)}
            raise RuntimeError(f"{label}: update {u + 1} differs: {diff}")


def fused_trainer(raw: dict, tmp: str, run_id: str, device, grouped: bool,
                  **overrides):
    """A trainer of ``raw`` (a YAML as a dict) whose fused launches run
    FUSED_CHUNK updates; it must have taken the graph route."""
    from etmppo_tpu_torch.config import config_from_dict
    from etmppo_tpu_torch.training.trainer import PPOTrainer
    config = dataclasses.replace(
        config_from_dict(raw), updates_per_launch=FUSED_CHUNK,
        summary_dir=tmp, checkpoint_dir=tmp, **overrides)
    trainer = PPOTrainer(config, run_id=run_id, device=device,
                         enable_metrics=False, grouped=grouped)
    check_graph_route(trainer, run_id)
    return trainer


def check_graph_route(trainer, label: str) -> None:
    if trainer.fused_route != "graph":
        trainer.close()
        raise RuntimeError(f"{label}: the fused route on the card is "
                           f"{trainer.fused_route!r}, not 'graph'")


def timed(fn):
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def capture_line(trainer) -> str:
    c = trainer.fused_loop.capture
    return (f"capture {c['capture_s']:.2f}s, instantiate "
            f"{c['instantiate_s']:.2f}s, {c['nodes']} nodes, graph pool "
            f"{c['pool_bytes'] / 2**20:.0f} MiB")


def kernel_events(trace_file: str) -> dict:
    """The launches of each CUDA function in a Chrome trace, by name."""
    with open(trace_file) as f:
        events = json.load(f)["traceEvents"]
    names: dict = {}
    for ev in events:
        if ev.get("ph") == "X" and ev.get("cat") == "kernel":
            names[ev["name"]] = names.get(ev["name"], 0) + 1
    return names


def named_launches(names: dict, function: str) -> int:
    """The launches of ``function`` (any template instance of it)."""
    return sum(n for name, n in names.items()
               if re.search(rf"\b{function}\b", name))


def traced_replay(trainer, log_dir: str) -> tuple:
    """One more update of a trainer on the graph route, a replay, under
    utils/profiling.trace: the device busy share of the update
    (``utils/profiling.device_busy`` over the span ``launch``) and the
    launches of each CUDA function by name."""
    from etmppo_tpu_torch.utils.profiling import TRACE_FILE, device_busy, trace
    with trace(log_dir):
        trainer.train_chunk(1)
        torch.cuda.synchronize()
    path = os.path.join(log_dir, TRACE_FILE)
    return device_busy(path, ("launch",))["total"], kernel_events(path)


def busy(shares: dict) -> str:
    return (f"{shares['busy_share'] * 100:.1f}% of {shares['wall_s']:.3f}s "
            f"({shares['busy_s']:.3f}s busy)")


def fused_against_eager(raw: dict, tmp: str, name: str, device, grouped: bool,
                        chunks: int, k: dict, per_update: dict) -> dict:
    """An eager trainer's ``chunks`` x FUSED_CHUNK updates
    (train_one_update) and a fused trainer's ``chunks`` launches
    (train_chunk) from the same seed, with PyTorch's deterministic
    algorithms: every update's actions and logged values, and after each
    launch the parameters, the optimizer state, the rollout state and both
    generators, equal to the bit; the fused launches must count
    ``per_update`` (name -> launches) of each kernel an update. The fused
    trainer saves a checkpoint after its first launch. Returns the two
    trainers' numbers."""
    from etmppo_tpu_torch.parallel.probe import (
        cpu_tree, deterministic_algorithms, record_actions)
    n = chunks * FUSED_CHUNK
    out: dict = {}
    with deterministic_algorithms():
        eager = fused_trainer(raw, tmp, f"{name}-eager", device, grouped)
        try:
            fused = fused_trainer(raw, tmp, f"{name}-fused", device, grouped,
                                  checkpoint_interval=FUSED_CHUNK)
        except RuntimeError:
            eager.close()
            raise
        try:
            recorders = [record_actions(t, n + 1) for t in (eager, fused)]
            eager_results, states = [], []
            out["eager_s"] = []
            for u in range(n):
                result, s = timed(eager.train_one_update)
                eager_results.append(result)
                out["eager_s"].append(s)
                if (u + 1) % FUSED_CHUNK == 0:
                    states.append(cpu_tree(eager._training_state()))
            fused_results, out["chunk_s"] = [], []
            before = {kn: kernel.launches for kn, kernel in k.items()}
            for c in range(chunks):
                results, s = timed(lambda: fused.train_chunk(FUSED_CHUNK))
                fused_results += results
                out["chunk_s"].append(s)
                if c == 0:
                    fused._save_checkpoint()
                _assert_same(states[c], fused._training_state(),
                             f"{name}: the fused state after launch {c + 1}")
            counted = {kn: kernel.launches - before[kn]
                       for kn, kernel in k.items()}
            check_counts(counted, {kn: v * n for kn, v in per_update.items()},
                         f"{name}: the fused launches")
            same_results(eager_results, fused_results, name)
            if list(eager.episode_infos) != list(fused.episode_infos):
                raise RuntimeError(f"{name}: the episode infos differ")
            if not torch.equal(recorders[0].actions[:n],
                               recorders[1].actions[:n]):
                raise RuntimeError(f"{name}: the actions differ")
            out.update(capture=capture_line(fused), counted=counted,
                       final=cpu_tree(fused._training_state()),
                       results=fused_results[FUSED_CHUNK:])
        finally:
            eager.close()
            fused.close()
    return out


def rate_line(steps: int, eager_s: list, launch_s: float) -> str:
    """Launch 2's s/update and env-steps/s beside the eager trainer's
    (without its first update)."""
    steady, eager = launch_s / FUSED_CHUNK, eager_s[1:]
    mean = sum(eager) / len(eager)
    return (f"launch 2 {launch_s:.3f}s = {steady:.4f} s/update, "
            f"{steps / steady:.0f} env-steps/s; eager {mean:.4f} s/update "
            f"(updates 2-{len(eager_s)}), {steps / mean:.0f} env-steps/s; "
            f"fused/eager rate {mean / steady:.2f}x")


def run_fused(device, k) -> list:
    """Phase 20: fused launches of whole updates (training/fused.py) on the
    graph route, held against eager updates. Returns the launches of the
    phase, in the order of NAMES."""
    from etmppo_tpu_torch.config import (CARTPOLE_MASKED, MINIGRID_FLAGSHIP,
                                         MYSTERY_PATH_GRID, POC_MEMORY,
                                         SEARING_SPOTLIGHTS)
    from etmppo_tpu_torch.parallel.probe import (deterministic_algorithms,
                                                 record_actions)
    t = time.perf_counter()
    for kernel in k.values():
        kernel.launches = 0
    flagship_steps = (MINIGRID_FLAGSHIP["n_workers"]
                      * MINIGRID_FLAGSHIP["worker_steps"])
    with tempfile.TemporaryDirectory() as tmp:
        # (a) the flagship with the grouped pair: the deterministic route.
        a = fused_against_eager(
            MINIGRID_FLAGSHIP, tmp, "flagship-grouped", device, True,
            FUSED_CHUNKS, k, {n: FLAGSHIP_LAUNCHES for n in NAMES[2:]})
        phase("fused", t,
              f"flagship, grouped pair, deterministic algorithms: "
              f"{FUSED_CHUNKS} launches of {FUSED_CHUNK} updates on the "
              f"graph route equal {FUSED_CHUNKS * FUSED_CHUNK} eager updates "
              "to the bit (actions, logged values, parameters, optimizer, "
              "rollout state, generators); "
              f"B3, B4 counted {a['counted'][NAMES[2]]}, "
              f"{a['counted'][NAMES[3]]}; {a['capture']}; first launch "
              f"{a['chunk_s'][0]:.2f}s; "
              + rate_line(flagship_steps, a["eager_s"], a["chunk_s"][1]))

        # (d) a resume across the launch boundary on route (a).
        t = time.perf_counter()
        with deterministic_algorithms():
            resumed = fused_trainer(MINIGRID_FLAGSHIP, tmp,
                                    "flagship-grouped-fused", device, True,
                                    checkpoint_interval=FUSED_CHUNK)
            try:
                if (not resumed.resume_from_checkpoint()
                        or resumed.update != FUSED_CHUNK):
                    raise RuntimeError(f"fused resume: at update "
                                       f"{resumed.update}")
                same_results(a["results"], resumed.train_chunk(FUSED_CHUNK),
                             "fused resume")
                _assert_same(a["final"], resumed._training_state(),
                             "fused resume: the state after launch 2")
            finally:
                resumed.close()
        phase("fused-resume", t,
              f"resumed at update {FUSED_CHUNK} from launch 1's checkpoint;"
              f" launch 2 (its update {FUSED_CHUNK + 1} eager, then a new "
              "capture) equals the "
              "uninterrupted run's to the bit")

        # (b) the flagship as its YAML says: the per-sample pair.
        t = time.perf_counter()
        n = FUSED_CHUNKS * FUSED_CHUNK
        eager = fused_trainer(MINIGRID_FLAGSHIP, tmp, "flagship-eager",
                              device, False)
        fused = fused_trainer(MINIGRID_FLAGSHIP, tmp, "flagship-fused",
                              device, False)
        try:
            recorders = [record_actions(tr, n + 1) for tr in (eager, fused)]
            _, eager_s = timed(eager.train_one_update)
            before = [k[name].launches for name in NAMES]
            chunk_s, results = [], []
            for _ in range(FUSED_CHUNKS):
                r, s = timed(lambda: fused.train_chunk(FUSED_CHUNK))
                results += r
                chunk_s.append(s)
            counted = [k[name].launches - b for name, b in zip(NAMES, before)]
            check_counts(dict(zip(NAMES, counted)),
                         {name: FLAGSHIP_LAUNCHES * n for name in NAMES[:2]},
                         "fused flagship: the fused launches")
            for u, r in enumerate(results):
                bad = {key: v for key, v in r.items()
                       if not math.isfinite(v)}
                if bad:
                    raise RuntimeError(f"fused flagship update {u + 1}: "
                                       f"non-finite stats {bad}")
            if not torch.equal(recorders[0].actions[0],
                               recorders[1].actions[0]):
                raise RuntimeError("fused flagship: update 1's actions differ"
                                   " from the eager trainer's")
            fused_busy, names = traced_replay(
                fused, os.path.join(tmp, "flagship-fused-trace"))
            ran = [named_launches(names, f) for f in FUSED_KERNEL_NAMES]
            if ran != [FLAGSHIP_LAUNCHES] * 2:
                raise RuntimeError(f"fused flagship: the traced replay ran "
                                   f"B1, B2 {ran} times")
            phase("fused-flagship", t,
                  f"the flagship as its YAML says (per-sample pair): "
                  f"{FUSED_CHUNKS} launches of {FUSED_CHUNK} on the graph "
                  f"route, B1 and B2 counted {counted[0]} and {counted[1]} "
                  f"times; the traced replay of update {n + 1} ran "
                  f"{FUSED_KERNEL_NAMES[0]} {ran[0]} and "
                  f"{FUSED_KERNEL_NAMES[1]} {ran[1]} times by name; stats "
                  f"finite; update 1's actions equal the eager trainer's; "
                  f"{capture_line(fused)}; first launch {chunk_s[0]:.2f}s; "
                  f"launch 2 {chunk_s[1]:.3f}s = "
                  f"{chunk_s[1] / FUSED_CHUNK:.4f} s/update, "
                  f"{flagship_steps * FUSED_CHUNK / chunk_s[1]:.0f} "
                  f"env-steps/s (eager: update 1 {eager_s:.2f}s here, the "
                  "steady rate in trainer and fused); device busy: a "
                  f"replayed update {busy(fused_busy)} (traced; an eager "
                  "one: trainer-busy)")
        finally:
            eager.close()
            fused.close()
        del eager, fused
        torch.cuda.empty_cache()

        # (c) Mystery Path Grid (its path-walk reset; with the grouped pair,
        # so that the update is deterministic) and PocMemory (the gathered
        # loss, no kernel).
        for name, raw, grouped in (("mysterypath", MYSTERY_PATH_GRID, True),
                                   ("pocmemory", POC_MEMORY, False)):
            t = time.perf_counter()
            blocks = raw["transformer"]["num_blocks"]
            per_update = ({n: blocks * raw["epochs"] * raw["n_mini_batch"]
                           for n in NAMES[2:]} if grouped else {})
            c = fused_against_eager(raw, tmp, name, device, grouped, 1, k,
                                    per_update)
            steps = raw["n_workers"] * raw["worker_steps"]
            eager = c["eager_s"][1:]
            mean = sum(eager) / len(eager)
            phase(f"fused-{name}", t,
                  f"one launch of {FUSED_CHUNK} on the graph route equals "
                  f"{FUSED_CHUNK} eager updates to the bit (deterministic "
                  f"algorithms{', grouped pair' * grouped}); "
                  f"{c['capture']}; the launch {c['chunk_s'][0]:.2f}s "
                  f"(warm-up and capture in it); eager {mean:.4f} s/update "
                  f"(updates 2-{FUSED_CHUNK}), {steps / mean:.0f} "
                  "env-steps/s")
            torch.cuda.empty_cache()

        # The CLI takes the graph route for every device env on the card:
        # Searing Spotlights (the env that draws in its step) and masked
        # CartPole must capture too (Mortar Mayhem Grid's env did on the
        # card, PERF.md §5; left out for the script's time).
        t = time.perf_counter()
        lines = []
        for name, raw in (("searingspotlights", SEARING_SPOTLIGHTS),
                          ("cartpole", CARTPOLE_MASKED)):
            trainer = fused_trainer(raw, tmp, name, device, False)
            try:
                results, s = timed(
                    lambda: trainer.train_chunk(FUSED_ROUTE_UPDATES))
                for u, r in enumerate(results):
                    bad = {key: v for key, v in r.items()
                           if not math.isfinite(v)}
                    if bad:
                        raise RuntimeError(f"fused {name} update {u + 1}: "
                                           f"non-finite stats {bad}")
                lines.append(f"{name} {capture_line(trainer)}, the launch "
                             f"{s:.2f}s")
            finally:
                trainer.close()
            torch.cuda.empty_cache()
        phase("fused-routes", t,
              f"a launch of {FUSED_ROUTE_UPDATES} (an eager update, then a "
              "replay) on the graph route, stats finite: " + "; ".join(lines))
    one_device = dict(replay_s=a["chunk_s"][1] / FUSED_CHUNK)
    return [k[name].launches for name in NAMES], one_device


def update_mfu(trainer, batch, update_s: float) -> str:
    """The FLOPs of one PPO update of ``trainer`` (``counted_flops`` of one
    minibatch's forward and backward through the kernel pair, plus
    ``window_attention_flops`` of the pair at every block, which the counter
    cannot see, times the minibatches of an update) over ``update_s``."""
    from etmppo_tpu_torch.utils.flops import (counted_flops,
                                              device_peak_flops, mfu,
                                              window_attention_flops)
    upd, cfg = trainer.update_fn, trainer.config
    trx = cfg.transformer
    timeline, slots, fields = upd.prepare_timeline(batch)
    idx = torch.arange(cfg.mini_batch_size, device=trainer.device)

    def forward_backward():
        loss, _ = upd.loss_timeline(upd.minibatch(fields, idx), timeline,
                                    slots, 0.1, 0.001)
        loss.backward()
    counted = counted_flops(forward_backward)
    trainer.model.zero_grad(set_to_none=True)
    B, L, D = cfg.mini_batch_size, trx.memory_length, trx.embed_dim
    pair = trx.num_blocks * (window_attention_flops(B, L, D)
                             + window_attention_flops(B, L, D, backward=True))
    n = cfg.epochs * cfg.n_mini_batch
    total = n * (counted + pair)
    peak = device_peak_flops(trainer.device)
    return (f"a minibatch {counted / 1e9:.2f} GFLOP counted + {pair / 1e9:.3f}"
            f" GFLOP of the kernel pair, x {n} = {total / 1e12:.3f} TFLOP per"
            f" PPO update; over its {update_s:.3f} s: "
            f"{total / update_s / 1e12:.2f} TFLOP/s, MFU "
            f"{mfu(total, update_s, peak) * 100:.2f}% of "
            f"{peak / 1e12:.1f} TFLOP/s")


# --- phase 22: the phase clock ------------------------------------------

CLOCK_FLAGSHIPS = ("MINIGRID_FLAGSHIP", "MYSTERY_PATH_GRID",
                   "MORTAR_MAYHEM_GRID")
# The flagships trained on the grouped pair, as their benchmark cells are.
CLOCK_GROUPED = ("MORTAR_MAYHEM_GRID",)
# The flagships whose env resets in a kernel of its own: one launch a
# rollout step.
CLOCK_RESET_KERNEL = ("MYSTERY_PATH_GRID", "MORTAR_MAYHEM_GRID")
# Steady launches of the clock-off and clock-on trainers, in turns.
CLOCK_TURNS = (False, True, True, False, False, True)
CLOCK_RATE_SECONDS = 15.0


class EventTimedGraph:
    """A CUDA graph whose every replay a pair of CUDA events times."""

    def __init__(self, graph):
        self.graph, self.events = graph, []

    def replay(self):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        self.graph.replay()
        end.record()
        self.events.append((start, end))


def clock_trainer(name: str, tmp: str, device, on: bool, seed: int = 0):
    """The flagship ``name`` of ``etmppo_tpu_torch.config`` as its YAML
    says (on the grouped pair where CLOCK_GROUPED names it), with the clock
    on or off; it must take the graph route."""
    from etmppo_tpu_torch import config as config_lib
    from etmppo_tpu_torch.training.trainer import PPOTrainer
    config = dataclasses.replace(
        config_lib.config_from_dict(getattr(config_lib, name)),
        summary_dir=tmp, checkpoint_dir=tmp, seed=seed,
        grouped_attention=name in CLOCK_GROUPED)
    trainer = PPOTrainer(config, run_id=name, device=device,
                         enable_metrics=False, phase_clock=on)
    check_graph_route(trainer, name)
    return trainer


def clock_stamps(config) -> int:
    """The stamps of one update on one device: 4 a rollout step, 4 a
    minibatch (the loss's and the step's phases), 12 around them."""
    return (4 * config.worker_steps
            + 4 * config.epochs * config.n_mini_batch + 12)


def launch_seconds(trainer, launches: int) -> list:
    """Host seconds of each of ``launches`` launches, each ending in its
    drain (the launch's device-to-host copies wait for the card)."""
    k = trainer.config.updates_per_launch
    out = []
    for _ in range(launches):
        t = time.perf_counter()
        trainer.train_chunk(k)
        out.append(time.perf_counter() - t)
    return out


def clock_breakdown(clock, first: int, k: int) -> dict:
    """The medians over updates ``first`` .. ``first + k - 1`` of each
    phase, the launch's host spans, and its idle seconds: the launch less
    its updates' spans."""
    from etmppo_tpu_torch.utils.profiling import PHASES
    updates = [clock.updates[u]["seconds"] for u in range(first, first + k)]
    phases = {p: float(np.median([u[p] for u in updates])) for p in PHASES}
    launch = clock.launches[first]
    idle = launch["launch"] - sum(u["update"] for u in updates)
    return dict(phases=phases, launch=launch, idle_s=idle)


def fmt(values) -> str:
    return "/".join(f"{v:.4f}" for v in values)


def run_phase_clock(device, rates: int = 0,
                    names: tuple = CLOCK_FLAGSHIPS) -> dict:
    """Phase 22 (the module's docstring) at the flagships ``names``; with
    ``rates`` > 0 also that many processes each with the clock off and on,
    per flagship. Returns the numbers by flagship."""
    out = {}
    for name in names:
        t = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            off = clock_trainer(name, tmp, device, False)
            k = off.config.updates_per_launch
            steps = off.env_steps_per_update
            first_off = launch_seconds(off, 1)[0]
            nodes_off = off.fused_loop.capture["nodes"]
            stamps = clock_stamps(off.config)
            want_resets = (off.config.worker_steps
                           if name in CLOCK_RESET_KERNEL else 0)
            on = clock_trainer(name, tmp, device, True)
            first_on = launch_seconds(on, 1)[0]
            capture = dict(on.fused_loop.capture)
            reset_kernel = on.env.reset_kernel
            turns = {False: [], True: []}       # launches in turns
            for clock_on in CLOCK_TURNS:
                turns[clock_on] += launch_seconds(on if clock_on else off, 1)
            steady = turns[False]
            del off
            torch.cuda.empty_cache()
            loop = on.fused_loop
            loop._graph = timed_graph = EventTimedGraph(loop._graph)
            u0 = on.update
            launch_seconds(on, 1)
            torch.cuda.synchronize(device)
            event_s = [a.elapsed_time(b) * 1e-3
                       for a, b in timed_graph.events]
            clock = on.clock
            span_s = [clock.updates[u0 + i]["seconds"]["update"]
                      for i in range(k)]
            parts = clock_breakdown(clock, u0, k)
            setup = dict(clock.setup)
            first_launch = dict(clock.launches[0])
            resets = reset_kernel.launches if reset_kernel else 0
            del on, loop, timed_graph, reset_kernel
            torch.cuda.empty_cache()
        agree = max(abs(s - e) / e for s, e in zip(span_s, event_s))
        p = parts["phases"]
        accounted = k * (p["rollout"] + p["ppo_update"] + p["outputs"]) \
            + parts["idle_s"]
        off_launch = float(np.median(steady))
        numbers = dict(
            nodes_off=nodes_off, nodes_on=capture["nodes"], stamps=stamps,
            update_vs_events=agree, span_s=span_s, event_s=event_s,
            phases=p, launch=parts["launch"], idle_s=parts["idle_s"],
            accounted_s=accounted, off_launch_s=steady,
            on_launch_s=turns[True],
            off_rate=k * steps / off_launch, first_launch_off_s=first_off,
            first_launch_on_s=first_on, first_launch=first_launch,
            setup=setup, reset_launches=resets,
            capture_reset_launches=capture["reset_launches"])
        phase("phase-clock", t, f"{name}: nodes off {nodes_off}, on "
              f"{capture['nodes']} (+{capture['nodes'] - nodes_off}, "
              f"{stamps} stamps), reset launches {capture['reset_launches']}"
              f" an update, {resets} in the clock-on trainer; update span vs CUDA events max "
              f"{agree * 100:.3f}%; phases (median s) " + ", ".join(
                  f"{n} {v:.4f}" for n, v in p.items())
              + f"; launch {parts['launch']['launch']:.4f}s, idle "
              f"{parts['idle_s'] * 1e3:.1f} ms; 4 x (rollout + ppo_update + "
              f"outputs) + idle {accounted:.4f}s vs the clock-off launch "
              f"{off_launch:.4f}s ({(accounted / off_launch - 1) * 100:+.2f}"
              f"%); in turns, launches off {fmt(steady)} s, on "
              f"{fmt(turns[True])} s; set-up " + ", ".join(f"{n} {v:.2f}s"
                                         for n, v in setup.items())
              + "; first launch " + ", ".join(
                  f"{n} {v:.2f}s" for n, v in first_launch.items()
                  if n != "updates"))
        print("phase-clock-numbers " + json.dumps({name: numbers}),
              flush=True)
        problems = []
        if capture["nodes"] != nodes_off + stamps:
            problems.append(f"{capture['nodes']} nodes with the clock on, "
                            f"not {nodes_off} + {stamps}")
        if agree > 0.01:
            problems.append(f"update spans {span_s} vs events {event_s}")
        if capture["reset_launches"] != want_resets:
            problems.append(f"{capture['reset_launches']} reset launches in "
                            f"a captured update, not {want_resets}")
        if problems:
            raise RuntimeError(f"phase-clock {name}: " + "; ".join(problems))
        if rates:
            numbers["rates"] = clock_rates(name, rates)
        out[name] = numbers
    return out


def clock_rate(name: str, on: bool, seed: int, seconds: float) -> None:
    """One process's steady env-steps/s of the flagship ``name`` with the
    clock on or off: launches after the first until ``seconds`` pass.
    Prints one JSON line."""
    device = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory() as tmp:
        trainer = clock_trainer(name, tmp, device, on, seed)
        k = trainer.config.updates_per_launch
        launch_seconds(trainer, 1)
        ends = [time.perf_counter()]
        while ends[-1] - ends[0] < seconds:
            trainer.train_chunk(k)
            ends.append(time.perf_counter())
        rate = ((len(ends) - 1) * k * trainer.env_steps_per_update
                / (ends[-1] - ends[0]))
    print("clock-rate " + json.dumps(dict(name=name, on=on, seed=seed,
                                          env_steps_per_s=rate)), flush=True)


def clock_rates(name: str, n: int) -> dict:
    """``n`` processes with the clock off and ``n`` with it on, in turns
    (off, on, on, off, ...), seeds 1 .. 2n; the medians and quartile
    spreads of their env-steps/s."""
    import statistics
    rates = {False: [], True: []}
    order = [(False, True, True, False)[i % 4] for i in range(2 * n)]
    for i, on in enumerate(order):
        t = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c", "import chip_smoke; chip_smoke.clock_rate("
             f"{name!r}, {on}, {i + 1}, {CLOCK_RATE_SECONDS})"],
            capture_output=True, text=True, timeout=900,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        if proc.returncode != 0:
            raise RuntimeError(f"clock_rate {name} on={on}: "
                               f"{proc.stderr[-2000:]}")
        line = [ln for ln in proc.stdout.splitlines()
                if ln.startswith("clock-rate ")][-1]
        rate = json.loads(line.split(" ", 1)[1])["env_steps_per_s"]
        rates[on].append(rate)
        phase("phase-clock-rate", t, f"{name} clock {'on' if on else 'off'}"
              f" seed {i + 1}: {rate:.1f} env-steps/s")
    out = {}
    for on, values in rates.items():
        q1, med, q3 = statistics.quantiles(values, n=4)
        out["on" if on else "off"] = dict(values=values, median=med,
                                          spread=(q3 - q1) / med)
    cost = 1 - out["on"]["median"] / out["off"]["median"]
    phase("phase-clock-cost", time.perf_counter(),
          f"{name}: off median {out['off']['median']:.1f} env-steps/s "
          f"(spread {out['off']['spread'] * 100:.2f}%), on "
          f"{out['on']['median']:.1f} (spread {out['on']['spread'] * 100:.2f}"
          f"%): the clock costs {cost * 100:.2f}%")
    out["cost"] = cost
    return out


def phase_clock_main(names: list) -> int:
    """``python3 chip_smoke.py phase-clock [NAME ...]``: the device line and
    phase 22 with the clock's cost in processes, at the flagships named or
    at every one."""
    unknown = set(names) - set(CLOCK_FLAGSHIPS)
    if unknown:
        print(f"chip_smoke: no flagship {sorted(unknown)} in "
              f"{CLOCK_FLAGSHIPS}", file=sys.stderr)
        return 2
    start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    device = torch.device("cuda", 0)
    phase("device", start, f"{torch.cuda.get_device_name(0)}; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")
    run_phase_clock(device, rates=3, names=tuple(names) or CLOCK_FLAGSHIPS)
    phase("total", start)
    print(smi)
    return 0


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
    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    phase("device", start, f"{kind}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")

    from etmppo_tpu_torch.envs.mortar_mayhem import MortarMayhemReset
    from etmppo_tpu_torch.envs.mystery_path import MysteryPathReset
    from etmppo_tpu_torch.ops import window_attention as wa
    k = {name: getattr(wa, name) for name in NAMES}
    reset_kernel = MysteryPathReset()
    mortar_reset = MortarMayhemReset()

    t = time.perf_counter()

    def timed_build(kernel):
        begin = time.perf_counter()
        existed = kernel.library_path().exists()
        path = kernel.build()
        return (f"{path.name} {time.perf_counter() - begin:.2f}s "
                f"({'reused' if existed else 'nvcc'})")
    with ThreadPoolExecutor(max_workers=len(k) + 2) as pool:
        built = list(pool.map(timed_build, [*k.values(), reset_kernel,
                                            mortar_reset]))
    phase("build", t, "; ".join(built))

    t = time.perf_counter()
    plans = {NAMES[0]: wa.forward_plan, NAMES[1]: wa.backward_plan,
             NAMES[2]: wa.grouped_forward_plan,
             NAMES[3]: wa.grouped_backward_plan}
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
    for name, kernel in ((RESET_NAME, reset_kernel),
                         (MORTAR_RESET_NAME, mortar_reset)):
        print(f"{name}: " + "; ".join(
            f"{r['function']} {r['registers']} registers, "
            f"{r['spill_bytes']} bytes spilled, {r['static_smem']} bytes "
            f"static smem" for r in kernel.resources()), flush=True)
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
    t = time.perf_counter()
    reset = measure_reset(device, gen)
    phase("reset-kernel", t, "; ".join(
        f"{case}: {m['checked']} calls bit-identical to the default path "
        f"({m['ended']} random-mask resets); {m['timed_done']} of "
        f"{RESET_WORKERS} done: ms {m['ms']:.4f} plain {m['plain_ms']:.4f} "
        f"library {m['library_ms']:.4f} bound {m['bound_ms']:.4f} "
        f"({m['bound_by']})" for case, m in reset.items()))
    torch.cuda.empty_cache()
    t = time.perf_counter()
    mortar = measure_mortar_reset(device, gen)
    phase("mortar-reset-kernel", t, "; ".join(
        f"{case}: {m['checked']} calls bit-identical to the default path "
        f"({m['ended']} random-mask resets); " + ", ".join(
            f"{n} of {RESET_WORKERS} done: ms {d['ms']:.4f} plain "
            f"{d['plain_ms']:.4f} library {d['library_ms']:.4f} bound "
            f"{d['bound_ms']:.4f} ({d['bound_by']})"
            for n, d in m["by_done"].items())
        for case, m in mortar.items()))
    torch.cuda.empty_cache()

    launches = {"flagship": run_flagship(device, k)}
    torch.cuda.empty_cache()
    reset_launches = {"reset-kernel": sum(m["launches"]
                                          for m in reset.values())}
    launches["mysterypath"], reset_launches["mysterypath"] = \
        run_mysterypath(device, k)
    torch.cuda.empty_cache()
    mortar_launches = {"mortar-reset-kernel": sum(m["launches"]
                                                  for m in mortar.values())}
    launches["mortarmayhem"], mortar_launches["mortarmayhem"] = \
        run_mortarmayhem(device, k)
    torch.cuda.empty_cache()
    launches["searingspotlights"] = run_searingspotlights(device, k)
    torch.cuda.empty_cache()
    from etmppo_tpu_torch.config import CARTPOLE_MASKED, POC_MEMORY
    device_rates = {
        "pocmemory": run_gathered(device, k, "pocmemory", POC_MEMORY,
                                  POC_UPDATES, True),
        "cartpole": run_gathered(device, k, "cartpole", CARTPOLE_MASKED,
                                 UPDATES + 1, False)}
    torch.cuda.empty_cache()
    run_serve(device, k)
    run_evaluate(device, k)
    run_enjoy(device, k)
    run_serve_http(device, k)
    torch.cuda.empty_cache()
    run_native(device, k, device_rates)
    torch.cuda.empty_cache()
    launches["hostpool"] = run_hostpool(device, k)
    torch.cuda.empty_cache()
    launches["headroom"] = run_headroom(device, k)
    torch.cuda.empty_cache()
    launches["obs_uint8"] = run_obs_uint8(device, k)
    torch.cuda.empty_cache()
    launches["debug_nans"] = run_debug_nans(device, k)
    torch.cuda.empty_cache()
    launches["data_parallel"], fused_mesh = run_data_parallel(device, k)
    launches["fused_mesh"] = fused_mesh["launches"]
    torch.cuda.empty_cache()
    launches["fused"], one_device = run_fused(device, k)
    from etmppo_tpu_torch.config import MINIGRID_FLAGSHIP
    fused_mesh_rate(fused_mesh, one_device,
                    MINIGRID_FLAGSHIP["n_workers"]
                    * MINIGRID_FLAGSHIP["worker_steps"])
    torch.cuda.empty_cache()
    clock = run_phase_clock(device)
    reset_launches["phase-clock"] = clock["MYSTERY_PATH_GRID"][
        "reset_launches"]
    mortar_launches["phase-clock"] = clock["MORTAR_MAYHEM_GRID"][
        "reset_launches"]
    check_float32("before the result line")

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
    main_case = next(iter(RESET_CASES))
    entries.append({
        "name": RESET_NAME, "route": "cuda",
        "source": os.path.relpath(reset_kernel.source, os.getcwd()),
        "replaces": RESET_REPLACES,
        "launches": sum(reset_launches.values()),
        "launches_by_path": reset_launches,
        "max_abs_err": 0.0, "mismatched_elements": 0,
        **{key: reset[main_case][key] for key in
           ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        "library": "clone of the state and frame, the copy-through floor",
        "timed_in": "a CUDA graph of 20 calls",
        "main_shape": main_case,
        "by_shape": {case: {key: m[key] for key in
                            ("ms", "plain_ms", "bound_ms", "bound_by",
                             "library_ms", "max_abs_err", "timed_done")}
                     for case, m in reset.items()},
    })
    main_case = next(iter(MORTAR_RESET_CASES))
    entries.append({
        "name": MORTAR_RESET_NAME, "route": "cuda",
        "source": os.path.relpath(mortar_reset.source, os.getcwd()),
        "replaces": RESET_REPLACES,
        "launches": sum(mortar_launches.values()),
        "launches_by_path": mortar_launches,
        "max_abs_err": 0.0, "mismatched_elements": 0,
        **{key: mortar[main_case][key] for key in
           ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        "library": "clone of the state and frame, the copy-through floor",
        "timed_in": "a CUDA graph of 20 calls",
        "main_shape": f"{main_case}, {MORTAR_RESET_DONE[-2]} done",
        "by_shape": {f"{case}, {n} done": {
            key: d[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                                    "library_ms", "timed_done")}
            for case, m in mortar.items() for n, d in m["by_done"].items()},
    })
    print(json.dumps({"kernels": entries}))
    phase("total", start)
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(phase_clock_main(sys.argv[2:]) if sys.argv[1:2] == ["phase-clock"]
             else main())
