"""The harness: it finds a cell's configuration, traffic mix, limits and
metrics by name, runs the cell with the driver its mix names, and prints
the result.

Everything that belongs to one configuration, one mix or one per-layer
metric is a file of its own, found by the name ``BENCHMARK.json`` gives:

* ``configs/<config>.json``: the program's configuration dict as it is run
  (``config``), with its source and the keys cut from it (``reduced``);
* ``traffic/<traffic>.json``: the mix's parameters; ``driver`` names the
  module ``portbench/<driver>.py`` whose ``run`` drives them, so a mix of
  a new kind adds its file and its driver and edits nothing;
* ``limits/<cell>.json``: the limit of every number the cell compares
  (``compare.py``);
* ``metrics/<metric>.py``: a per-layer metric's reader, ``read(context)``,
  which returns the metric's value from what the traced run saw, or None
  where the cell gives it nothing to read (the metric is then left out of
  the line).
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import os
import shutil
import sys
import tempfile
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# Whole top-level module names that no run may load: JAX, its libraries,
# and the JAX package the port was made from.
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "etmppo_tpu")


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[dict]
    per_layer: List[dict]
    # Test hooks: configuration keys set over the file's, and functions that
    # plant a fault in the program object before the first launch.
    overrides: dict = field(default_factory=dict)
    faults: List[Callable] = field(default_factory=list)


def stamp(t_start: float, what: str) -> None:
    """A progress line on standard error: seconds since the run started."""
    import time
    print(f"[{time.perf_counter() - t_start:8.2f} s] {what}", file=sys.stderr,
          flush=True)


def _json(path: Path):
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: Path = ROOT, bench: dict = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json``, or of ``bench`` where given
    (the tests add the cells under ``later/`` to it)."""
    bench = bench or _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    config = next(c for c in bench["configs"] if c["name"] == cell["config"])

    def applies(metric):
        return name in metric.get("workloads", [name])
    e2e = [m for m in bench["end_to_end"] if applies(m)]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in e2e_names)]
    return Cell(name, cell["chips"], _json(root / config["file"]),
                _json(HERE / "traffic" / f"{cell['traffic']}.json"),
                _json(HERE / "limits" / f"{name}.json"), e2e, per_layer)


def read_metric(name: str, context: dict):
    """The per-layer metric ``name`` from its reader file, or None."""
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{name}", HERE / "metrics" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read(context)


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def device_info(cell: Cell, device, outcome: dict) -> dict:
    import torch
    info = dict(platform="cpu", kind="cpu", count=cell.chips,
                memory_peak_bytes=outcome["memory_peak_bytes"])
    if torch.device(device).type == "cuda":
        info.update(platform="gpu",
                    kind=torch.cuda.get_device_name(torch.device(device)))
    summary = outcome["context"].get("trace")
    if summary is not None:
        info.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
    return info


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float) -> dict:
    """Runs one cell once; returns the result line's object (``checks``
    last), with the readings beside it under ``readings``."""
    driver = importlib.import_module(f"portbench.{cell.traffic['driver']}")
    tmp = tempfile.mkdtemp(prefix="portbench-")
    try:
        outcome = driver.run(cell, seed, seconds, trace, tmp, device, t_start)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    from . import compare
    numbers = outcome["numbers"]
    if trace:
        metrics = {}
        for m in cell.per_layer:
            value = read_metric(m["name"], outcome["context"])
            if value is not None:
                metrics[m["name"]] = dict(value=value, unit=m["unit"])
    else:
        metrics = {m["name"]: dict(value=outcome["metrics"][m["name"]],
                                   unit=m["unit"]) for m in cell.end_to_end}
    result = dict(correct=compare.judge(numbers, cell.limits),
                  attempted=outcome["attempted"], failed=outcome["failed"],
                  metrics=metrics,
                  device=device_info(cell, device, outcome))
    summary = outcome["context"].get("trace")
    if summary is not None:
        result["breakdown"] = dict(device_ops=summary["device_ops"],
                                   idle_gaps=summary["idle_gaps"])
    result["readings"] = outcome["readings"]
    if "samples" in outcome["context"]:
        result["readings"]["samples"] = outcome["context"]["samples"]
    result["checks"] = {k: dict(value=v, limit=cell.limits.get(k))
                        for k, v in numbers.items()}
    return result


def emit(result: dict) -> None:
    """The compared numbers as the last lines on standard error, then the
    result as the last line on standard output."""
    for k, v in result["readings"].items():
        print(f"reading {k}: {v}", file=sys.stderr)
    for k, v in result["checks"].items():
        print(f"check {k}: {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result, allow_nan=True), flush=True)


def set_cache_dirs() -> None:
    """Build and kernel caches at fixed places inside the checkout (the
    program keeps its own nvcc builds in ``etmppo_tpu_torch/_build``)."""
    cache = ROOT / ".portbench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
