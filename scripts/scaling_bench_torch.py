"""Scaling study: PPO throughput against the number of ranks (the
counterpart of scripts/scaling_bench.py).

`measure(ranks, envs_per_rank, iters, T, device)` runs the flat
`humanoid_ppo` training iteration (solver mega on the card, apgd on the
CPU) env-sharded over `ranks` processes, started by `parallel/launch.py`'s
spawner as gloo ranks (CPU ranks, or ranks sharing the one card), and
returns env steps per second. Each rank times itself after one warm-up
iteration, from a barrier to a barrier, so process start, the kernel
library's load and the env build stay outside the window; the slowest
rank's window counts.

Three protocols, as the JAX script's:
  fixed_host  the weak-scaling sweep (1, 2, 4, ... ranks at a fixed
              envs_per_rank), median of --repeats with the spread; the
              ranks share the host's cores, each with cores / ranks threads;
  pinned      CPU only: rank r pinned (os.sched_setaffinity) to core r with
              one thread, the closest to "each rank its own hardware";
  control     the same total batch over max_ranks ranks against 1 process,
              on the same cores: a ratio below 1 is what sharding costs
              (collectives, per-rank launches), compute parallelism cancels.

On the card every rank time-shares the one H100 (the GPU machine has one),
so the weak-scaling sweep measures time-sharing, not scaling; only
`control` at 2 ranks says something there: what two processes feeding one
card cost against one. The artifact names this.

Usage:
    python scripts/scaling_bench_torch.py --repeats 5                 # sweep
    python scripts/scaling_bench_torch.py --control --max_ranks 2 \
        --envs_per_rank 2048 --horizon 60 --repeats 3                 # control on the card
    python scripts/scaling_bench_torch.py --artifact out.json --device cpu
        # all three protocols into a new file (never docs/scaling_emulated.json)
"""

import argparse
import json
import os
import statistics
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# the JAX package's committed artifact: this script writes its own files only
JAX_ARTIFACT = os.path.join(REPO, "docs", "scaling_emulated.json")


def _rank_worker(work: str, envs_per_rank: int, iters: int, T: int, device_name: str,
                 threads: int, pin: bool) -> int:
    """One rank: build the env and the iteration, warm up, time `iters`
    iterations between two barriers, write rank<r>.json into `work`."""
    import torch

    rank = int(os.environ["RANK"])
    if pin:
        os.sched_setaffinity(0, {rank % os.cpu_count()})
    torch.set_num_threads(threads)

    from humanoid_gym_tpu_torch import registry
    from humanoid_gym_tpu_torch.algo.networks import actor_critic_from_cfg
    from humanoid_gym_tpu_torch.algo.ppo import PPOConfig, init_train_state, make_train_iter
    from humanoid_gym_tpu_torch.parallel.mesh import make_env_group, replicate
    from humanoid_gym_tpu_torch.utils.platform import synchronize

    group = make_env_group("gloo", device=device_name, init_method=f"file://{work}/rdv")
    try:
        device = group.device
        num_envs = group.world * envs_per_rank

        def overrides(c):
            c.sim.solver.solver_type = "apgd" if device.type == "cpu" else "mega"

        env, cfg = registry.make_env("humanoid_ppo", num_envs=num_envs, cfg_overrides=overrides,
                                     device=device, seed=0, group=group)
        tcfg = registry.get_task("humanoid_ppo").make_train_cfg()
        net = actor_critic_from_cfg(cfg.env, tcfg.policy, seed=0).to(device)
        replicate(list(net.parameters()), group)
        algo = PPOConfig.from_cfg(tcfg.algorithm)
        algo.num_steps_per_env = T
        ts = init_train_state(net, algo.learning_rate)
        state = env.init_state()
        obs = torch.zeros((env.num_envs, cfg.env.num_observations), device=device)
        priv = torch.zeros((env.num_envs, cfg.env.num_privileged_obs), device=device)
        train_iter = make_train_iter(env, net, algo, num_envs, group, perm_seed=0)
        gen = torch.Generator(device=device)
        gen.manual_seed(1 + group.rank)
        ts, state, obs, priv, _ = train_iter(ts, state, obs, priv, gen)
        synchronize(device)
        group.barrier()
        t0 = time.perf_counter()
        for _ in range(iters):
            ts, state, obs, priv, metrics = train_iter(ts, state, obs, priv, gen)
        synchronize(device)
        group.barrier()
        seconds = time.perf_counter() - t0
        out = {"rank": group.rank, "seconds": seconds, "value_loss": float(metrics["value_loss"])}
    finally:
        group.close()
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    return 0


def _threads(ranks: int, pin: bool) -> int:
    return 1 if pin else max(1, (os.cpu_count() or 1) // ranks)


def measure(ranks: int, envs_per_rank: int, iters: int, T: int, device="cuda", pin: bool = False,
            timeout_s: float = 1800.0) -> float:
    """Env steps per second of `ranks` gloo ranks x `envs_per_rank` envs,
    horizon T, over `iters` timed iterations (the slowest rank's window)."""
    from humanoid_gym_tpu_torch.parallel.launch import RankJob
    from humanoid_gym_tpu_torch.utils.platform import resolve_device

    device = resolve_device(device)
    if pin and device.type != "cpu":
        raise ValueError("the pinned protocol runs CPU ranks only")
    threads = _threads(ranks, pin)
    with tempfile.TemporaryDirectory(prefix="hgt_scaling_") as work:
        argv = [sys.executable, os.path.abspath(__file__), "--rank-worker", work,
                "--envs_per_rank", str(envs_per_rank), "--iters", str(iters),
                "--horizon", str(T), "--device", "cuda:0" if device.type == "cuda" else "cpu",
                "--threads", str(threads)] + (["--pin"] if pin else [])
        env = dict(os.environ, OMP_NUM_THREADS=str(threads))
        RankJob(argv, ranks, env).wait(timeout_s)
        seconds = []
        for r in range(ranks):
            with open(os.path.join(work, f"rank{r}.json")) as f:
                seconds.append(json.load(f)["seconds"])
    return T * ranks * envs_per_rank * iters / max(seconds)


def measure_stats(ranks, envs_per_rank, iters, T, repeats, device, pin=False):
    """Median of `repeats` measurements, with their spread."""
    vals = [measure(ranks, envs_per_rank, iters, T, device, pin) for _ in range(repeats)]
    med = statistics.median(vals)
    return {
        "steps_per_sec": med,
        "repeats": repeats,
        "min": min(vals),
        "max": max(vals),
        "cv": statistics.pstdev(vals) / med if med else None,
    }


def _sizes(max_ranks: int):
    return [n for n in (1, 2, 4, 8, 16, 32) if n <= max_ranks]


def run_sweep(args, pin=False):
    """Weak scaling over 1, 2, 4, ... ranks (pinned: one core each)."""
    points, base = [], None
    for n in _sizes(args.max_ranks):
        st = measure_stats(n, args.envs_per_rank, args.iters, args.horizon, args.repeats,
                           args.device, pin)
        st.update(ranks=n, envs=n * args.envs_per_rank)
        if base is None:
            base = st["steps_per_sec"]
        st["scaling_efficiency"] = st["steps_per_sec"] / (base * n)
        points.append(st)
        print(json.dumps(st), flush=True)
    return points


def run_control(args):
    """The same total envs over max_ranks ranks against 1 process."""
    n = args.max_ranks
    total = n * args.envs_per_rank
    unsharded = measure_stats(1, total, args.iters, args.horizon, args.repeats, args.device)
    sharded = measure_stats(n, args.envs_per_rank, args.iters, args.horizon, args.repeats,
                            args.device)
    out = {
        "total_envs": total,
        "ranks_sharded": n,
        "unsharded_steps_per_sec": unsharded,
        "sharded_steps_per_sec": sharded,
        "sharded_over_unsharded": sharded["steps_per_sec"] / unsharded["steps_per_sec"],
    }
    print(json.dumps(out), flush=True)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--envs_per_rank", type=int, default=16)
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--horizon", type=int, default=8)
    p.add_argument("--max_ranks", type=int, default=None,
                   help="default: 2 on the card, min(8, cores) on the CPU")
    p.add_argument("--repeats", type=int, default=5)
    p.add_argument("--control", action="store_true", help="serialization control only")
    p.add_argument("--pinned", action="store_true", help="rank-per-core sweep only (CPU)")
    p.add_argument("--artifact", type=str, default=None,
                   help="run all the protocols the device allows, write the JSON artifact here")
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--rank-worker", type=str, default=None, help=argparse.SUPPRESS)
    p.add_argument("--threads", type=int, default=1, help=argparse.SUPPRESS)
    p.add_argument("--pin", action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.rank_worker:
        sys.exit(_rank_worker(args.rank_worker, args.envs_per_rank, args.iters, args.horizon,
                              args.device, args.threads, args.pin))

    from humanoid_gym_tpu_torch.utils.platform import card_line, resolve_device

    device = resolve_device(args.device)
    if args.max_ranks is None:
        args.max_ranks = 2 if device.type == "cuda" else min(8, os.cpu_count() or 1)
    on_card = device.type == "cuda"
    if args.artifact:
        if os.path.abspath(args.artifact) == JAX_ARTIFACT:
            raise SystemExit(f"{JAX_ARTIFACT} is the JAX package's artifact; write another file")
        artifact = {
            "protocol": {
                "workload": "flat humanoid_ppo training iteration (rollout T=%d + update), "
                            "%d envs/rank, weak scaling" % (args.horizon, args.envs_per_rank),
                "host": f"{os.cpu_count()} CPU cores; ranks are processes started by "
                        "parallel/launch.py, gloo, timed after a warm-up from barrier to barrier",
                "device": card_line(device) or "no card",
                "stat": f"median of {args.repeats}, spread as min/max/cv per point",
                "fixed_host": "the ranks share the host's cores, each with cores / ranks threads"
                              + ("; on the card every rank time-shares the one H100, so this "
                                 "sweep measures time-sharing, not scaling" if on_card else ""),
                "pinned": "rank r pinned (os.sched_setaffinity) to core r with one thread"
                          + ("; CPU only: not run on the card" if on_card else ""),
                "control": "same total envs over max_ranks ranks against 1 process on the same "
                           "hardware: compute parallelism cancels; a ratio below 1 is what "
                           "sharding costs" + ("; on the card at 2 ranks, what two processes "
                                               "feeding one card cost against one" if on_card
                                               else ""),
            },
            "fixed_host": run_sweep(args),
            "control": run_control(args),
            "pinned": None if on_card else run_sweep(args, pin=True),
        }
        with open(args.artifact, "w") as f:
            json.dump(artifact, f, indent=1)
        print(f"wrote {args.artifact}", flush=True)
        return artifact
    if args.control:
        return run_control(args)
    if args.pinned:
        if on_card:
            raise SystemExit("--pinned runs CPU ranks only: pass --device cpu")
        return run_sweep(args, pin=True)
    return run_sweep(args)


if __name__ == "__main__":
    main()
