"""Command-line entry point (counterpart of ``etmppo_tpu/cli.py:train_main``).

    python -m etmppo_tpu_torch.cli --config=<yaml or json> --run-id=<id> [--cpu]

Training runs on the CUDA device unless ``--cpu`` is given; without a GPU and
without ``--cpu`` it raises. A ``.json`` config needs no PyYAML.
"""
from __future__ import annotations

import argparse
import dataclasses
import json


def _read_config(path: str):
    from .config import config_from_dict, load_config
    if path.endswith(".json"):
        with open(path) as f:
            return config_from_dict(json.load(f))
    return load_config(path)


def train_main(argv=None):
    parser = argparse.ArgumentParser(
        description="Train a TrXL PPO agent with PyTorch")
    parser.add_argument("--config", required=True,
                        help="Path to a yaml or json config file")
    parser.add_argument("--run-id", default="run", dest="run_id",
                        help="Tag for the summaries")
    parser.add_argument("--cpu", action="store_true",
                        help="Train on the CPU instead of the GPU")
    parser.add_argument("--updates", type=int, default=None,
                        help="Override the config's number of updates")
    args = parser.parse_args(argv)

    from .training.trainer import PPOTrainer

    config = _read_config(args.config)
    if args.updates is not None:
        config = dataclasses.replace(config, updates=args.updates)
    trainer = PPOTrainer(config, run_id=args.run_id,
                         device="cpu" if args.cpu else "cuda")
    try:
        result = trainer.run_training()
    finally:
        trainer.close()
    print(f"env steps/s: {result['env_steps_per_second']:,.0f}")
    return result


if __name__ == "__main__":
    train_main()
