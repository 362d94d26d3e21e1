"""Render learning curves from a port run's metrics.jsonl to PNG (the
counterpart of scripts/plot_curves.py; the port's runner logs the same
scalar names).

Usage: python scripts/plot_curves_torch.py --run_dir logs/XBot_ppo/<run> [--out f.png]
Panels: mean episode reward/length, per-term episode rewards, losses, lr/std,
fps, and (if present) the sim2sim robustness curve.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--run_dir", required=True)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    lines = [json.loads(l) for l in open(os.path.join(args.run_dir, "metrics.jsonl"))]
    it = np.asarray([l["iter"] for l in lines])

    def col(k, default=0.0):
        return np.asarray([l.get(k, default) for l in lines])

    fig, axs = plt.subplots(2, 3, figsize=(18, 9))

    a = axs[0, 0]
    a.plot(it, col("Train/mean_reward"))
    a.set(title="Mean episode reward", xlabel="iteration")
    b = a.twinx()
    b.plot(it, col("Train/mean_episode_length"), color="tab:orange", alpha=0.6)
    b.set_ylabel("episode length (steps)", color="tab:orange")

    a = axs[0, 1]
    for k in (
        "Episode/rew_tracking_lin_vel",
        "Episode/rew_feet_contact_number",
        "Episode/rew_orientation",
        "Episode/rew_joint_pos",
        "Episode/rew_feet_air_time",
        "Episode/rew_base_height",
    ):
        a.plot(it, col(k), label=k.split("rew_")[1])
    a.set(title="Per-term episode rewards (/s)", xlabel="iteration")
    a.legend(fontsize=8)

    a = axs[0, 2]
    a.plot(it, col("Loss/value_function"), label="value")
    a.plot(it, np.abs(col("Loss/surrogate")), label="|surrogate|")
    a.set(title="Losses", xlabel="iteration", yscale="log")
    a.legend()

    a = axs[1, 0]
    a.plot(it, col("Loss/learning_rate"), label="lr")
    a.set(title="Adaptive LR", xlabel="iteration", yscale="log")
    b = a.twinx()
    b.plot(it, col("Policy/mean_noise_std"), color="tab:green")
    b.set_ylabel("action std", color="tab:green")

    a = axs[1, 1]
    a.plot(it, col("Perf/total_fps"))
    a.set(title="Throughput (env steps/s)", xlabel="iteration")

    a = axs[1, 2]
    rc = os.path.join(args.run_dir, "robustness_curve.jsonl")
    if os.path.exists(rc):
        recs = [json.loads(l) for l in open(rc)]
        cks = [r["ckpt"] for r in recs]
        a.plot(cks, [r["survived"] / r["rollouts"] for r in recs], "o-", label="survival")
        b = a.twinx()
        b.plot(cks, [r["mean_distance_x"] for r in recs], "s--", color="tab:red")
        b.set_ylabel("distance [m]", color="tab:red")
        a.set(title="Zero-shot sim2sim robustness", xlabel="checkpoint", ylim=(0, 1.05))
        a.legend()
    else:
        a.axis("off")

    fig.tight_layout()
    out = args.out or os.path.join(args.run_dir, "curves.png")
    fig.savefig(out, dpi=110)
    plt.close(fig)
    print(out)
    return out


if __name__ == "__main__":
    main()
