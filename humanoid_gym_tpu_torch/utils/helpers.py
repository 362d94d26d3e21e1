"""CLI parsing + checkpoint path resolution.

The port's own copy of humanoid_gym_tpu/utils/helpers.py (pure Python, no
array library): the same flag surface (--task/--resume/--experiment_name/
--run_name/--load_run/--checkpoint/--headless/--num_envs/--seed/
--max_iterations/--log_root) plus --device, which defaults to the card,
and --backend, the process group's backend when the script runs as one
rank of several under `torchrun`. Checkpoint discovery (get_load_path)
orders runs by mtime.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Optional


def get_args(argv=None):
    p = argparse.ArgumentParser("humanoid_gym_tpu_torch")
    p.add_argument("--task", type=str, default="humanoid_ppo")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--experiment_name", type=str, default=None)
    p.add_argument("--run_name", type=str, default=None)
    p.add_argument("--load_run", type=str, default=None, help="-1 / name of run to load")
    p.add_argument("--checkpoint", type=int, default=-1, help="-1 = latest")
    p.add_argument("--headless", action="store_true")
    p.add_argument("--num_envs", type=int, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--max_iterations", type=int, default=None)
    p.add_argument("--log_root", type=str, default=None)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; 'cuda' (default) needs a card, 'cpu' runs the plain versions")
    p.add_argument("--backend", type=str, default=None, choices=("nccl", "gloo"),
                   help="process-group backend under torchrun (WORLD_SIZE set): nccl (default on "
                        "the card, one card per rank) or gloo (CPU ranks, ranks sharing a card)")
    return p.parse_args(argv)


def update_cfg_from_args(env_cfg, train_cfg, args):
    """Apply the CLI override whitelist (reference helpers.py:141-164)."""
    if env_cfg is not None and args.num_envs is not None:
        env_cfg.env.num_envs = args.num_envs
    if train_cfg is not None:
        if args.seed is not None:
            train_cfg.seed = args.seed
        if args.max_iterations is not None:
            train_cfg.runner.max_iterations = args.max_iterations
        if args.resume:
            train_cfg.runner.resume = True
        if args.experiment_name is not None:
            train_cfg.runner.experiment_name = args.experiment_name
        if args.run_name is not None:
            train_cfg.runner.run_name = args.run_name
        if args.load_run is not None:
            train_cfg.runner.load_run = args.load_run
        if args.checkpoint is not None:
            train_cfg.runner.checkpoint = args.checkpoint
    return env_cfg, train_cfg


def get_load_path(root: str, load_run=-1, checkpoint: int = -1) -> str:
    """Resolve a checkpoint path (reference helpers.py:110-138): pick the
    last run (by mtime) unless load_run names one; pick the highest-numbered
    model_*.ckpt unless checkpoint gives an iteration."""
    runs = sorted(
        (d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d))),
        key=lambda d: os.path.getmtime(os.path.join(root, d)),
    )
    if "exported" in runs:
        runs.remove("exported")
    if not runs:
        raise ValueError(f"no runs in {root}")
    run = runs[-1] if load_run in (-1, "-1", None) else str(load_run)
    run_dir = os.path.join(root, run)

    ckpts = [f for f in os.listdir(run_dir) if f.startswith("model_") and f.endswith(".ckpt")]
    if not ckpts:
        raise ValueError(f"no checkpoints in {run_dir}")
    if checkpoint == -1:
        ckpts.sort(key=lambda f: int(f.split("_")[1].split(".")[0]))
        model = ckpts[-1]
    else:
        model = f"model_{checkpoint}.ckpt"
    return os.path.join(run_dir, model)


def class_to_dict(obj) -> dict:
    """Recursive config -> dict bridge (reference helpers.py:44-59), for
    dataclass config trees."""
    if dataclasses.is_dataclass(obj):
        return {
            f.name: class_to_dict(getattr(obj, f.name))
            for f in dataclasses.fields(obj)
        }
    if isinstance(obj, (list, tuple)):
        return type(obj)(class_to_dict(v) for v in obj)
    return obj


def update_class_from_dict(obj, d: dict):
    """dict -> config tree update (reference helpers.py:62-69)."""
    for k, v in d.items():
        attr = getattr(obj, k, None)
        if dataclasses.is_dataclass(attr) and isinstance(v, dict):
            update_class_from_dict(attr, v)
        else:
            setattr(obj, k, v)
    return obj


def resolve_log_dir(
    train_cfg, root: Optional[str] = None, timestamp: Optional[str] = None
) -> str:
    """logs/<experiment_name>/<date>_<run_name> (task_registry.py:124-130)."""
    import datetime

    root = root or os.path.join(os.getcwd(), "logs", train_cfg.runner.experiment_name)
    ts = timestamp or datetime.datetime.now().strftime("%b%d_%H-%M-%S")
    name = ts + ("_" + train_cfg.runner.run_name if train_cfg.runner.run_name else "")
    return os.path.join(root, name)
