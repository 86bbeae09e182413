"""The comparison's control and planted faults, at a cell's own size.

    python3 portbench/control.py --workload <cell> --mode <tf32|half_batch> \
        --seeds <n> [<n> ...]

puts the plain reference in the program's place and prints, for each seed,
one JSON line of the numbers ``compare.py`` computes against the reference
in float32, with the cell's limits beside them:

* ``tf32``: the reference with every matrix product's inputs rounded to
  TensorFloat-32, the precision below the configurations' float32 (the
  control, which has to come out as not correct);
* ``half_batch``: a training cell's reference with each minibatch's loss
  taken over its first half (a planted fault);
* ``alter_action``: the reference serving, or sampling in its rollout, the
  next action instead of its draw every ``ALTER``-th step (a planted
  fault: an answer altered where it is produced).

The benchmark's own runs do not run this; ``tests/test_portbench_harness.py``
runs it at a small size.
"""
import argparse
import json
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from portbench import compare, harness, serve, train  # noqa: E402
from portbench.reference import model as ref_model  # noqa: E402
from portbench.reference.envs import make_env  # noqa: E402
from portbench.reference.ppo import Trainer  # noqa: E402

MODES = ("tf32", "half_batch", "alter_action")
# A planted altered action every this many steps.
ALTER = 37


def training(cell, seed: int, mode: str, device) -> tuple:
    with tempfile.TemporaryDirectory() as tmp:
        cfg = train.build_config(cell, seed, tmp)
    env = make_env(cfg["environment"], 1, "cpu")
    weights = ref_model.make_weights(ref_model.param_spec(
        cfg, env.observation_shape, env.action_branches), seed, device)
    n = cell.traffic["follow_updates"]
    steps = cell.traffic["follow_steps"]
    stand_in = Trainer(cfg, weights, seed, device, tf32=mode == "tf32",
                       half_batch=mode == "half_batch", watch_steps=steps,
                       alter=ALTER if mode == "alter_action" else 0)
    runs, starts = [], [None]
    for u in range(n):
        runs.append(stand_in.run_update())
        if u + 1 < n:
            starts.append(stand_in.state())
    record = dict(updates=runs, starts=starts,
                  ends=[r["params_end"] for r in runs],
                  step_stats=stand_in.step_stats,
                  first_grad=stand_in.first_grad,
                  params_watched=stand_in.params_watched,
                  stats=[r["stats"] for r in runs],
                  first_stats=[r["first_stats"] for r in runs])
    ref = Trainer(cfg, weights, seed, device, watch_steps=steps)
    return compare.training(record, train.follow(ref, record), ref, weights)


def serving(cell, seed: int, mode: str, device, ticks: int = 2000) -> tuple:
    if mode == "half_batch":
        raise SystemExit("a serving cell has no minibatch")
    cfg = dict(cell.config["config"], **cell.overrides)
    t = cell.traffic
    env = make_env(cfg["environment"], 1, "cpu")
    weights = ref_model.make_weights(ref_model.param_spec(
        cfg, env.observation_shape, env.action_branches), seed, device)
    traffic = serve.Traffic(t, seed, env.observation_shape)
    for _ in range(t["warmup_ticks"] + ticks):
        traffic.ended()
        traffic.advance()
    traffic.ended()
    sample = serve.sample_episodes(traffic.finished, t["sample_episodes"],
                                   seed)
    stand_in = serve.replay(cfg, weights, traffic, sample, seed, device,
                            tf32=mode == "tf32",
                            alter=ALTER if mode == "alter_action" else 0)
    # The stand-in's actions where the program's would be served.
    served = torch.zeros((traffic.tick, t["streams"],
                          len(env.action_branches)), dtype=torch.long,
                         device=device)
    valid = stand_in["valid"]
    served[stand_in["ticks"][valid],
           stand_in["streams"][:, None].expand_as(valid)[valid]] = (
        stand_in["actions"][valid])
    replayed = serve.replay(cfg, weights, traffic, sample, seed, device,
                            served)
    return compare.serving(stand_in["values"], replayed), {}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--mode", choices=MODES,
                        required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    cell = harness.load_cell(args.workload)
    stand_in = {"train": training, "serve": serving}[cell.traffic["driver"]]
    for seed in args.seeds:
        numbers, readings = stand_in(cell, seed, args.mode, args.device)
        print(json.dumps(dict(workload=args.workload, mode=args.mode,
                              seed=seed, correct=compare.judge(
                                  numbers, cell.limits),
                              numbers=numbers, readings=readings)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
