"""Runs one cell of ``BENCHMARK.json`` once, on the card of this machine.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout. The last line of standard output is the
result (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` ``breakdown``; the compared numbers with their limits
last, under ``checks``), and the compared numbers are the last lines of
standard error. Exits with 1 and prints no result without enough CUDA
cards, and with 3 if JAX or the JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    from portbench import harness
    cell = harness.load_cell(args.workload)
    harness.set_cache_dirs()
    import torch
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); {cards} "
              "found", file=sys.stderr)
        return 1
    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                              "cuda", T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    harness.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
