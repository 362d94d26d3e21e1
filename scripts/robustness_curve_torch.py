"""Sim2sim robustness curve of a port training run (the counterpart of
scripts/robustness_curve.py): the native eval farm on every checkpoint.

For each model_N.ckpt (N > 0) of the run directory that has no line yet,
exports the actor (`export/policy_export.py` `export_checkpoint`) and runs the native MuJoCo eval farm on
flat ground (`humanoid_gym_tpu_torch/export/native_eval.py`, built into
build/native/), appending one JSON line per checkpoint to
<run_dir>/robustness_curve.jsonl:

    {"ckpt": N, "survived": k, "rollouts": n, "mean_distance_x": d, "duration_s": s}

Checkpoint selection for deployment reads this file. It runs on the host's
CPU (MuJoCo; the GPU machine has no `mujoco`), so it can watch a run that
trains on the card. The runner writes a checkpoint under a temporary name
and renames it, so a listed checkpoint is complete.

Usage:
    python scripts/robustness_curve_torch.py --run_dir logs/XBot_ppo/<run> \
        [--watch] [--rollouts 16] [--duration 20]
"""

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from humanoid_gym_tpu_torch import XBOT_MJCF  # noqa: E402


def eval_ckpt(ckpt_path: str, rollouts: int, duration: float, threads=None):
    """The native farm's summary for the actor of a port checkpoint."""
    from humanoid_gym_tpu_torch.export import export_checkpoint
    from humanoid_gym_tpu_torch.export.native_eval import run_eval_farm

    with tempfile.TemporaryDirectory() as d:
        export_checkpoint(ckpt_path, d)
        out = run_eval_farm(XBOT_MJCF, os.path.join(d, "policy.bin"), rollouts=rollouts,
                            duration=duration, threads=threads)
    return out["summary"]


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--run_dir", required=True)
    p.add_argument("--rollouts", type=int, default=16)
    p.add_argument("--duration", type=float, default=20.0)
    p.add_argument("--threads", type=int, default=None)
    p.add_argument("--watch", action="store_true")
    p.add_argument("--poll_s", type=float, default=60.0)
    args = p.parse_args(argv)

    out_path = os.path.join(args.run_dir, "robustness_curve.jsonl")
    done = set()
    if os.path.exists(out_path):
        for line in open(out_path):
            done.add(json.loads(line)["ckpt"])

    while True:
        ckpts = sorted(
            int(f.split("_")[1].split(".")[0])
            for f in os.listdir(args.run_dir)
            if f.startswith("model_") and f.endswith(".ckpt")
        )
        for c in [c for c in ckpts if c not in done and c > 0]:
            summary = eval_ckpt(os.path.join(args.run_dir, f"model_{c}.ckpt"), args.rollouts,
                                args.duration, args.threads)
            rec = {
                "ckpt": c,
                "survived": summary["survived"],
                "rollouts": summary["rollouts"],
                "mean_distance_x": summary["mean_distance_x"],
                "duration_s": summary["duration_s"],
            }
            with open(out_path, "a") as f:
                f.write(json.dumps(rec) + "\n")
            print(json.dumps(rec), flush=True)
            done.add(c)
        if not args.watch:
            break
        time.sleep(args.poll_s)


if __name__ == "__main__":
    main()
