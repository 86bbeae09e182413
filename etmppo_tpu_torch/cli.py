"""Command-line entry points (counterpart of ``etmppo_tpu/cli.py``).

Train:  python -m etmppo_tpu_torch.cli [--config=<yaml or json>] \
            [--run-id=<id>] [--cpu] [--resume] [--updates=N] \
            [--profile=DIR] [--seeds=N] [--debug-nans]
Enjoy:  python -m etmppo_tpu_torch.enjoy --model=<path> [--episodes=N] \
            [--cpu] [--no-render] [--render-dir=DIR]

Both run on the CUDA device unless ``--cpu`` is given; without a GPU and
without ``--cpu`` it raises. A ``.json`` config needs no PyYAML; without
``--config`` the CLI trains ``config.POC_MEMORY``, the JAX CLI's default
``poc_memory_env.yaml`` as a dict. ``--resume``
continues from the run's latest checkpoint (``checkpoint_interval > 0``);
the final model is saved as ``<checkpoint_dir>/<run-id>.nn``. ``--profile``
writes a torch.profiler Chrome trace of training to
``DIR/<run-id>/trace.json``, and turns the trainer's phase clock on
(``PPOTrainer(phase_clock=True)``, ``utils/profiling.PhaseClock``), whose
record it writes beside the trace as ``DIR/<run-id>/phases.json``: each
update's phase seconds on the device (the rollout's policy, env step,
reset paths and GAE, the PPO update's preparation, losses and steps, the
outputs), each launch's host spans, the trainer's set-up spans and
``capture``, the fused loop's capture record (its seconds, graph nodes,
pool bytes and env reset-kernel launches; empty on the eager route).
``--seeds N``
trains seeds ``seed .. seed + N - 1`` one after another as
``<run-id>_s<seed>`` and prints the mean and std of their final
``reward_mean``. ``--debug-nans`` (``jax_debug_nans``) raises
``FloatingPointError`` at the first NaN or infinity of a forward output, a
backward function or a parameter after an optimizer step
(``utils/runtime.set_debug_nans``), and turns the checks off at the end.

Data parallelism: with ``num_devices: N > 1`` in the config the CLI spawns
N ranks itself (``parallel.mesh.spawn``: nccl, a card a rank; gloo on the
CPU with ``--cpu``) and trains each seed on all of them; under torchrun
(``WORLD_SIZE`` set) this process is one rank
(``parallel.multihost.initialize_multihost``):

    torchrun --nproc_per_node=N -m etmppo_tpu_torch.cli --config=x.json

Only rank 0 writes the summaries, the checkpoints and the model and prints;
``--profile`` traces rank 0 and writes its phases.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os


def _read_config(path):
    from .config import POC_MEMORY, config_from_dict, load_config
    if path is None:
        return config_from_dict(POC_MEMORY)
    if path.endswith(".json"):
        with open(path) as f:
            return config_from_dict(json.load(f))
    return load_config(path)


def train_main(argv=None):
    """Returns the last seed's training result."""
    parser = argparse.ArgumentParser(
        description="Train a TrXL PPO agent with PyTorch")
    parser.add_argument("--config", default=None,
                        help="Path to a yaml or json config file (default: "
                             "PocMemory, etmppo_tpu_torch.config.POC_MEMORY)")
    parser.add_argument("--run-id", default="run", dest="run_id",
                        help="Tag for the summaries and the saved model")
    parser.add_argument("--cpu", action="store_true",
                        help="Train on the CPU instead of the GPU")
    parser.add_argument("--resume", action="store_true",
                        help="Resume from the latest checkpoint for this run-id")
    parser.add_argument("--updates", type=int, default=None,
                        help="Override the config's number of updates")
    parser.add_argument("--profile", metavar="DIR", default=None,
                        help="Write a torch.profiler trace of training and "
                             "the phase clock's record to DIR")
    parser.add_argument("--seeds", type=int, default=1,
                        help="Train N seeds one after another; models saved "
                             "as <run-id>_s<seed>.nn")
    parser.add_argument("--debug-nans", action="store_true",
                        help="Raise FloatingPointError at the first NaN or "
                             "infinity (checks that sync with the device)")
    args = parser.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    if "WORLD_SIZE" in os.environ:         # torchrun: this process is a rank
        import torch.distributed as dist

        from .parallel.mesh import make_mesh
        from .parallel.multihost import initialize_multihost
        initialize_multihost(backend="gloo" if args.cpu else None)
        try:
            mesh = make_mesh(_read_config(args.config).num_devices, device)
            return train_rank(mesh, args)
        finally:
            dist.destroy_process_group()
    num_devices = _read_config(args.config).num_devices
    if num_devices > 1:
        from .parallel.mesh import spawn
        # No deadline on the whole run, which may take days; a hung rank
        # fails the others' collectives (``collective_timeout``).
        return spawn(train_rank, num_devices, (args,), device=device,
                     timeout=None)[0]
    return train_rank(None, args)


def train_rank(mesh, args):
    """One rank's training (all of it on one device, ``mesh`` None):
    returns the last seed's training result."""
    if not args.debug_nans:
        return _train_seeds(args, mesh)
    from .utils.runtime import set_debug_nans
    set_debug_nans(True)
    try:
        return _train_seeds(args, mesh)
    finally:
        set_debug_nans(False)


def _train_seeds(args, mesh=None):
    """Trains ``args.seeds`` seeds one after another; returns the last
    seed's training result."""
    from .training.trainer import PPOTrainer
    from .utils.profiling import PHASES_FILE, trace

    primary = mesh is None or mesh.is_primary
    base = _read_config(args.config)
    if args.updates is not None:
        base = dataclasses.replace(base, updates=args.updates)
    results = []
    for i in range(args.seeds):
        config = (base if args.seeds == 1
                  else dataclasses.replace(base, seed=base.seed + i))
        run_id = (args.run_id if args.seeds == 1
                  else f"{args.run_id}_s{config.seed}")
        trainer = PPOTrainer(config, run_id=run_id,
                             device="cpu" if args.cpu else "cuda", mesh=mesh,
                             phase_clock=bool(args.profile))
        if args.resume:
            resumed = trainer.resume_from_checkpoint()
            if primary:
                print(f"Resumed from checkpoint at update {trainer.update}"
                      if resumed else "No checkpoint found; starting fresh")
        try:
            with (trace(os.path.join(args.profile, run_id))
                  if args.profile and primary else contextlib.nullcontext()):
                result = trainer.run_training()
            if args.profile and primary:
                loop = trainer.fused_loop
                trainer.clock.write(
                    os.path.join(args.profile, run_id, PHASES_FILE),
                    capture=dict(loop.capture) if loop is not None else {})
        finally:
            trainer.close()
        results.append(result)
        if not primary:
            continue
        print(f"env steps/s: {result['env_steps_per_second']:,.0f}")
        if "env_steps_per_second_steady" in result:
            print(f"env steps/s (steady, without the first launch): "
                  f"{result['env_steps_per_second_steady']:,.0f}")
    if len(results) > 1 and primary:
        import numpy as np
        rewards = [r.get("reward_mean", float("nan")) for r in results]
        print(f"[{len(results)} seeds] final reward_mean: "
              f"{np.nanmean(rewards):.3f} +/- {np.nanstd(rewards):.3f}")
    return results[-1]


def enjoy_main(argv=None):
    """Runs a trained model's episodes (``enjoy.run_episodes``); returns
    their returns."""
    parser = argparse.ArgumentParser(description="Run a trained model")
    parser.add_argument("--model", default="./models/run.nn",
                        help="Path to the trained model")
    parser.add_argument("--episodes", type=int, default=1)
    parser.add_argument("--cpu", action="store_true",
                        help="Run on the CPU instead of the GPU")
    parser.add_argument("--no-render", action="store_true")
    parser.add_argument("--render-dir", default=None,
                        help="Where image-env episode GIFs are written "
                             "(default: renders/<model-stem>/)")
    args = parser.parse_args(argv)

    from .enjoy import run_episodes
    return run_episodes(args.model, episodes=args.episodes,
                        render=not args.no_render,
                        render_dir=args.render_dir,
                        device="cpu" if args.cpu else "cuda")


if __name__ == "__main__":
    train_main()
