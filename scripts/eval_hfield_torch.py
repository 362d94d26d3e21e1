"""Evaluate port checkpoints on the MuJoCo uneven-terrain hfield (the
counterpart of scripts/eval_hfield.py; the checkpoints are the port's
`torch.save` files, model_N.ckpt).

The flat-ground robustness curve (`scripts/robustness_curve.py`, native
farm) measures engine transfer; this measures FOOTING transfer on the
deployment terrain (XBot-L-terrain.xml / uneven.png: 1 m cells up to
0.35 m — reference sim2sim.py:170-183).

Protocol v4 (round 3, VERDICT item 2 — "the hfield eval is gameable and
underpowered"):
  * rollouts are spawned at seeded random hfield positions, cmd vx
    cycling {0.4, 0.2, 0.0} across rollouts (unchanged from v3; the
    first 24 spawn seeds are identical to v3's so curves remain
    comparable);
  * a rollout SCORES only if it survived AND, when cmd > 0, it tracked
    at least 50% of the commanded distance — standing still can no
    longer buy points during commanded-walk rollouts;
  * rollouts run in a multiprocessing pool, so N scales to >=96 for
    binomial CIs that actually separate policies (24 rollouts give ~+-4
    noise on an 18-vs-12 comparison).

Usage:
  python scripts/eval_hfield_torch.py --run_dir logs/.../<run> \
      [--rollouts 24] [--duration 10] [--stride 4] [--ckpt N] [--watch]
  python scripts/eval_hfield_torch.py --policy <file.npz|file.pt> --rollouts 96

`--watch` polls the run dir while training is still writing checkpoints
(MuJoCo on the host's CPU: it can run beside a training job on the card;
the GPU machine itself has no `mujoco`) and evaluates every `stride`-th
checkpoint as it appears; after `--max_idle_s` with nothing new it scores
the final checkpoint and exits. The runner writes each checkpoint under a
temporary name and renames it, so a listed checkpoint is complete. Writes
hfield_curve.jsonl into the run dir. `--procs` sets the pool's size in
both modes.
"""

from __future__ import annotations

import argparse
import glob
import json
import multiprocessing as mp
import os
import re
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from humanoid_gym_tpu_torch import XBOT_TERRAIN_MJCF as TERRAIN_MJCF  # noqa: E402

CMD_CYCLE = (0.4, 0.2, 0.0)
TRACK_GATE = 0.5  # must cover >=50% of commanded distance when cmd > 0

_WORKER_POLICY = None
_WORKER_ROBOT = "l"


def _pool_init(policy_path: str, robot: str = "l"):
    global _WORKER_POLICY, _WORKER_ROBOT
    from humanoid_gym_tpu_torch.export import load_policy

    _WORKER_POLICY = load_policy(policy_path)
    _WORKER_ROBOT = robot


def _run_one(task):
    """One rollout in a pool worker: (idx, spawn_xy, cmd, duration)."""
    idx, spawn_xy, cmd, duration = task
    from humanoid_gym_tpu_torch.export.sim2sim import (
        Sim2SimCfg, run_mujoco, xbots_sim2sim_cfg,
    )

    if _WORKER_ROBOT == "s":
        # Froude-scaled morphology on the Froude-scaled hfield: gains /
        # cycle time / fall threshold from xbots_sim2sim_cfg; cmd is
        # already velocity-scaled by the caller.
        from humanoid_gym_tpu_torch import XBOT_S_TERRAIN_MJCF

        cfg = xbots_sim2sim_cfg(
            mujoco_model_path=XBOT_S_TERRAIN_MJCF,
            sim_duration=duration,
            cmd_vx=cmd,
            spawn_xy=spawn_xy,
        )
    else:
        cfg = Sim2SimCfg(
            mujoco_model_path=TERRAIN_MJCF,
            sim_duration=duration,
            cmd_vx=cmd,
            spawn_xy=spawn_xy,
        )
    out = run_mujoco(_WORKER_POLICY, cfg)
    return idx, cmd, out["fallen_at_s"], out["distance_x"]


def eval_policy_path(policy_path: str, rollouts: int, duration: float,
                     procs: int | None = None, robot: str = "l"):
    import numpy as np

    # Froude scaling for the S morphology: spawns sample the same RELATIVE
    # area of the (scaled) hfield, commands the same relative velocity
    # (v x sqrt(s)); the tracking gate is applied to the scaled command.
    if robot == "s":
        from humanoid_gym_tpu_torch.config.xbots import SCALE

        spawn_scale, cmd_scale = SCALE, SCALE ** 0.5
        # Froude TIME also scales by sqrt(s) (ADVICE r4): at the nominal L
        # duration the S robot would traverse ~17% more terrain cells per
        # rollout (v ~ sqrt(s) but cells ~ s). Scaling the duration keeps
        # the relative traversal — and hence survival odds — comparable
        # across morphologies (protocol *_xbots_v2; v1 used nominal time).
        duration = duration * cmd_scale
    else:
        spawn_scale, cmd_scale = 1.0, 1.0

    # Seeded spawn sequence: rng.uniform((N, 2)) is row-for-row identical
    # for any prefix, so the first 24 rollouts reproduce protocol v3's
    # spawns exactly and larger N only appends.
    rng = np.random.default_rng(12345)
    spawns = rng.uniform(-8.0, 8.0, size=(rollouts, 2)) * spawn_scale
    cmds = tuple(round(c * cmd_scale, 6) for c in CMD_CYCLE)
    tasks = [
        (r, (float(spawns[r, 0]), float(spawns[r, 1])),
         cmds[r % len(cmds)], duration)
        for r in range(rollouts)
    ]
    procs = procs or max(1, min(3, (os.cpu_count() or 2) - 1))
    if procs == 1:
        _pool_init(policy_path, robot)
        results = [_run_one(t) for t in tasks]
    else:
        ctx = mp.get_context("spawn")  # a fork would copy torch's threads and state
        with ctx.Pool(procs, initializer=_pool_init,
                      initargs=(policy_path, robot)) as pool:
            results = pool.map(_run_one, tasks)

    survived, scored, dists = 0, 0, []
    per_cmd = {c: {"n": 0, "survived": 0, "scored": 0, "dist": []}
               for c in cmds}
    for _, cmd, fallen_at, dist in results:
        ok = fallen_at is None
        tracked = cmd == 0.0 or dist >= TRACK_GATE * cmd * duration
        s = per_cmd[cmd]
        s["n"] += 1
        s["survived"] += ok
        s["scored"] += ok and tracked
        s["dist"].append(dist)
        survived += ok
        scored += ok and tracked
        dists.append(dist)
    return {
        "survived": survived,
        "scored": scored,  # survived AND tracked >=50% of commanded dist
        "rollouts": rollouts,
        "mean_distance_x": round(float(np.mean(dists)), 3),
        "per_cmd": {
            str(c): {
                "n": s["n"],
                "survived": s["survived"],
                "scored": s["scored"],
                "mean_distance_x": round(float(np.mean(s["dist"])), 3),
            }
            for c, s in per_cmd.items() if s["n"]
        },
        "duration_s": duration,
        # v4 = v3's seeded spawns + triangulated local-ground fall
        # detection + the 50%-tracking progress gate. Earlier tags:
        # spawn_v3_triangulated (no gate), spawn_v2, none.
        "protocol": "spawn_v4_gated" + ("_xbots_v2" if robot == "s" else ""),
        "robot": robot,
    }


def eval_ckpt(ckpt_path: str, rollouts: int, duration: float,
              robot: str = "l", procs: int | None = None):
    import tempfile

    from humanoid_gym_tpu_torch.export import export_checkpoint

    with tempfile.TemporaryDirectory() as d:
        export_checkpoint(ckpt_path, d)
        return eval_policy_path(os.path.join(d, "policy.npz"), rollouts, duration,
                                procs=procs, robot=robot)


def main(argv=None):
    p = argparse.ArgumentParser()
    g = p.add_mutually_exclusive_group(required=True)
    g.add_argument("--run_dir", help="evaluate a training run's checkpoints")
    g.add_argument("--policy", help="evaluate one policy file (.npz or "
                   "TorchScript .pt — e.g. the reference's shipped "
                   "policy_example.pt) instead of a run dir")
    p.add_argument("--rollouts", type=int, default=24)
    p.add_argument("--duration", type=float, default=10.0)
    p.add_argument("--stride", type=int, default=5)
    p.add_argument("--procs", type=int, default=None)
    p.add_argument("--ckpt", type=int, default=None, help="single checkpoint")
    p.add_argument("--watch", action="store_true",
                   help="poll run_dir for new checkpoints (concurrent with "
                        "training); exit after --max_idle_s of no new ckpt")
    p.add_argument("--poll_s", type=float, default=120.0)
    p.add_argument("--max_idle_s", type=float, default=1800.0)
    p.add_argument("--robot", choices=("l", "s"), default="l",
                   help="'s' = XBot-S morphology on the Froude-scaled "
                        "hfield (XBot-S-terrain.xml), commands x sqrt(s), "
                        "spawns x s")
    args = p.parse_args(argv)

    if args.policy:
        res = {"policy": args.policy,
               **eval_policy_path(args.policy, args.rollouts, args.duration,
                                  args.procs, args.robot)}
        print(json.dumps(res))
        return

    out_path = os.path.join(args.run_dir, "hfield_curve.jsonl")
    seen = set()
    if os.path.exists(out_path):
        for line in open(out_path):
            seen.add(json.loads(line)["ckpt"])

    def list_ckpts():
        return sorted(
            (int(re.search(r"model_(\d+)\.ckpt", f).group(1)), f)
            for f in glob.glob(os.path.join(args.run_dir, "model_*.ckpt"))
        )

    def score(n, f, fh):
        seen.add(n)
        res = {"ckpt": n, **eval_ckpt(f, args.rollouts, args.duration,
                                      args.robot, args.procs)}
        fh.write(json.dumps(res) + "\n")
        fh.flush()
        print(json.dumps(res), flush=True)

    if not args.watch:
        ckpts = list_ckpts()
        if args.ckpt is not None:
            ckpts = [(n, f) for n, f in ckpts if n == args.ckpt]
            if not ckpts:
                raise SystemExit(f"no model_{args.ckpt}.ckpt in {args.run_dir}")
            # an explicitly requested checkpoint re-scores even if a prior
            # (possibly lower-N) row exists — silent skips here cost a
            # debugging session
            seen.discard(args.ckpt)
        else:
            ckpts = ckpts[:: args.stride] + ([ckpts[-1]] if ckpts else [])
        with open(out_path, "a") as fh:
            for n, f in ckpts:
                if n not in seen:
                    score(n, f, fh)
        return

    # watch mode: stride by checkpoint RANK in the save sequence (rank =
    # n // save_gap, stable as new checkpoints appear), so the subsample
    # matches what a post-hoc `--stride` pass would have picked.
    import time

    last_new = time.time()
    high_water = -1
    with open(out_path, "a") as fh:
        while True:
            ckpts = [(n, f) for n, f in list_ckpts() if n > 0]
            if ckpts and ckpts[-1][0] > high_water:
                high_water = ckpts[-1][0]
                last_new = time.time()  # training is alive (even off-stride)
            gap = min(
                (b - a for (a, _), (b, _) in zip(ckpts, ckpts[1:]) if b > a),
                default=None,
            )
            for n, f in ckpts:
                if n in seen or gap is None or (n // gap) % args.stride:
                    continue
                last_new = time.time()
                score(n, f, fh)
            if time.time() - last_new > args.max_idle_s:
                # training is done (or stalled): score the final checkpoint
                # even if it is off-stride, then exit.
                if ckpts and ckpts[-1][0] not in seen:
                    score(*ckpts[-1], fh)
                print("watch: idle past max_idle_s, exiting", flush=True)
                return
            time.sleep(args.poll_s)


if __name__ == "__main__":
    main()
