#!/usr/bin/env python3
"""Where a window-attention kernel's time goes, on one CUDA card: times copies
of its CUDA source with parts cut out, at the shapes of chip_smoke.py.

    python3 kernel_parts.py --kernel bwd --cut 'no scatter|// Scatter dK|return;'
    python3 kernel_parts.py --kernel bwd_grouped --cut 'pass 1 only|const int threads2|return 0;'

Run it from the root of the checkout whose kernel it times: it imports that
checkout's wrapper (etmppo_tpu_torch.ops.window_attention) and chip_smoke.py.
A cut is NAME|ANCHOR|LINE: a copy of the source with LINE inserted before the
one line of the source, as it stands, that contains ANCHOR (``return;`` ends
the kernel there, ``if (false)`` drops the statement that follows). The copies are written and built
under etmppo_tpu_torch/_build/parts/ with the headers they include, never
beside the source; their results are wrong by design and are not checked.
Each is timed as chip_smoke.py times a kernel (3 warm-up and 20 timed
launches), through its wrapper (for the grouped pair, the sort and the
scratch included), with the whole kernel, in turns forth and back; for the
per-sample backward, the zeroing of its four gradient tables alone is timed too, as four
``zeros_like`` ("zeroing only") and as one zeroed buffer. With --profile,
each copy's kernels are also traced with torch.profiler and their device ms
per call printed by kernel (the host's own time in the wrapper, which the
event timing includes where it exceeds the device's, is left out). Prints
one line per shape and, last, one JSON object.
"""
from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

# --kernel: the wrapper class of etmppo_tpu_torch.ops.window_attention whose
# source is cut.
KERNELS = {"fwd": "WindowAttentionForward", "bwd": "WindowAttentionBackward",
           "fwd_grouped": "WindowAttentionForwardGrouped",
           "bwd_grouped": "WindowAttentionBackwardGrouped"}


def variant_sources(source: Path, cuts, out_dir: Path) -> dict:
    """The source, and one copy of it per cut beside a copy of each header
    it includes, as {name: path}."""
    whole = source.read_text()
    text = whole.splitlines(keepends=True)
    out_dir.mkdir(parents=True, exist_ok=True)
    for header in re.findall(r'#include "([^"]+)"', whole):
        shutil.copyfile(source.parent / header, out_dir / header)
    paths = {"full": source}
    for cut in cuts:
        name, anchor, line = cut.split("|")
        hits = [i for i, t in enumerate(text) if anchor in t]
        if len(hits) != 1:
            raise ValueError(f"cut {name!r}: {len(hits)} lines contain "
                             f"{anchor!r}, expected 1")
        lines = list(text)
        lines.insert(hits[0], line + "\n")
        slug = re.sub(r"\W+", "_", name)
        path = out_dir / f"{source.stem}_{slug}.cu"
        path.write_text("".join(lines))
        paths[name] = path
    return paths


def device_ms(fn, iters: int = 20) -> dict:
    """Device ms per call of each CUDA kernel that ``fn`` launches, over
    ``iters`` calls traced by torch.profiler (after one untraced call), by
    kernel function name."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for event in prof.key_averages():
        total = getattr(event, "device_time_total", None)
        if total is None:
            total = getattr(event, "cuda_time_total", 0)
        if total:
            name = re.findall(r"(\w+_kernel\w*)", event.key)
            key = name[0] if name else event.key[:40]
            out[key] = out.get(key, 0.0) + total / iters / 1e3
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--kernel", choices=sorted(KERNELS), default="bwd")
    parser.add_argument("--cut", action="append", default=[])
    parser.add_argument("--shapes", default="flagship,mysterypath,mortarmayhem")
    parser.add_argument("--profile", action="store_true",
                        help="also print each CUDA kernel's device ms per "
                        "call of each copy, from torch.profiler")
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        print("kernel_parts: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path.cwd()))
    import chip_smoke
    from etmppo_tpu_torch.ops import window_attention as wa
    from etmppo_tpu_torch.utils.build import BUILD_DIR

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    cls = getattr(wa, KERNELS[opts.kernel])
    source = Path(cls().source)
    parts_dir = BUILD_DIR / "parts"
    paths = variant_sources(source, opts.cut, parts_dir)
    kernels = {name: cls(path, parts_dir) for name, path in paths.items()}
    with ThreadPoolExecutor(max_workers=len(kernels)) as pool:
        list(pool.map(lambda k: k.build(), kernels.values()))

    gen = torch.Generator().manual_seed(0)
    device = torch.device("cuda", 0)
    result = {}
    for shape in opts.shapes.split(","):
        args, heads = chip_smoke.window_inputs(gen, device, shape)
        g = torch.randn(args[0].shape, generator=gen).to(device)
        extra = (g,) if opts.kernel.startswith("bwd") else ()
        runs = {name: (lambda k=k: k(*args, *extra, heads))
                for name, k in kernels.items()}
        if opts.kernel == "bwd":
            tables = args[1:5]
            runs["zeroing only"] = lambda: [torch.zeros_like(t) for t in tables]
            runs["one zeroed buffer"] = lambda: torch.zeros(
                sum(t.numel() for t in tables), device=device)
        turns = list(runs) + list(runs)[::-1]
        times = {name: [] for name in runs}
        for name in turns:
            times[name].append(chip_smoke.cuda_ms(runs[name]))
        result[shape] = times
        if opts.profile:
            traced = {name: device_ms(fn) for name, fn in runs.items()}
            result[shape + " device"] = traced
            for name, kernels_ms in traced.items():
                print(f"{shape} device, {name}: " + "; ".join(
                    f"{k} {v:.4f}" for k, v in kernels_ms.items()), flush=True)
        print(f"{shape}: " + "; ".join(
            f"{name} {t[0]:.4f} / {t[1]:.4f} ms" for name, t in times.items()),
            flush=True)
        del args, g
        torch.cuda.empty_cache()
    print(json.dumps({"device": smi.splitlines()[0], "kernel": opts.kernel,
                      "source": str(source), "cuts": opts.cut,
                      "ms": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
