"""One joint XBot-L + XBot-S training iteration at 16,384 envs on the
deployment heightfield, and its memory (the counterpart of
scripts/config4_dryrun.py).

`humanoid_joint_deploy` (8,192 XBot-L + 8,192 XBot-S envs, the recipe's
nets with the estimator head) through the registry's `make_env` and
`make_train_iter` (captured on the card, `algo.capture.compiled_train_iter`,
the JAX script's `jax.jit`: one CUDA graph at one rank, graphs cut at each
all-reduce under several; captured in the warm-up iteration, and the
graphs' memory pool is in the peak): one warm-up iteration, then one timed one with the mega
launch counters zeroed just before it and read just after. The JAX script
ran T = 4 on 8 emulated CPU devices and projected T = 60; the card holds
the production horizon itself, so `--horizon` defaults to 60 there (8 on
the CPU, the JAX script's default). Solver mega on the card (B1t, two
launches a policy step, one per robot at 8,192 envs each), apgd on the CPU.

Memory: the env-state bytes (every tensor of the state), the rollout
storage at T by the JAX formula, per rank the live bytes after set-up and
after the iteration (`torch.cuda.memory_allocated` on the card; on the CPU
the bytes of the live tensors' storages) and the peak
(`max_memory_allocated`, on the card only), the host's peak RSS, and the
JAX formula's T = 60 projection per rank beside the measured T = 60 peak.

`--ranks K` splits the envs over K processes (`parallel/launch.py`), gloo
ranks sharing the one card (or CPU ranks with `--device cpu`), meeting
through a file in a temporary directory.

Usage:
    python scripts/config4_dryrun_torch.py [--envs 16384] [--ranks 1] [--horizon 60]
        [--out result.json] [--device cuda|cpu]
The last line is one JSON object.
"""

import argparse
import dataclasses
import gc
import json
import os
import resource
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

TASK = "humanoid_joint_deploy"


def tensor_tree_bytes(obj) -> int:
    """Bytes of every tensor in a state: a tensor, a dataclass of them
    (nested) or a list of such states."""
    import torch

    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if isinstance(obj, (list, tuple)):
        return sum(tensor_tree_bytes(x) for x in obj)
    if dataclasses.is_dataclass(obj):
        return sum(tensor_tree_bytes(getattr(obj, f.name)) for f in dataclasses.fields(obj))
    return 0


def live_bytes(device) -> int:
    """Bytes allocated on `device`: the caching allocator's count on the
    card; on the CPU the storages of the tensors the process still holds
    (each storage once)."""
    import torch

    if device.type == "cuda":
        return torch.cuda.memory_allocated(device)
    gc.collect()
    seen, total = set(), 0
    for obj in gc.get_objects():
        # type(), not isinstance(): isinstance reads `__class__`, which
        # some module-level proxies answer with a deprecation warning
        if issubclass(type(obj), torch.Tensor) and obj.device.type == "cpu":
            st = obj.untyped_storage()
            if st.data_ptr() not in seen:
                seen.add(st.data_ptr())
                total += st.nbytes()
    return total


def rollout_row_floats(num_obs: int, num_priv: int, num_actions: int) -> int:
    """Floats of one rollout sample by the JAX script's formula: obs + priv +
    3 x actions (action, mean, std) + 4 scalars."""
    return num_obs + num_priv + 3 * num_actions + 4


def projection_t60_per_rank(state_bytes_total: int, envs: int, row: int, ranks: int) -> float:
    """The JAX formula: per rank, the env-state shard + the T = 60 rollout
    shard + one permuted copy of it."""
    return (state_bytes_total + 2 * envs * 60 * row * 4) / ranks


def run_rank(envs: int, horizon: int, device, group=None) -> dict:
    """One rank's part of the dry run (seed 0): set-up, a warm-up iteration,
    a timed one; its bytes, times, launches and value loss."""
    import torch

    from humanoid_gym_tpu_torch import registry
    from humanoid_gym_tpu_torch.algo.networks import actor_critic_from_cfg
    from humanoid_gym_tpu_torch.algo.capture import compiled_train_iter
    from humanoid_gym_tpu_torch.algo.ppo import PPOConfig, check_minibatch_split, init_train_state
    from humanoid_gym_tpu_torch.parallel.mesh import replicate
    from humanoid_gym_tpu_torch.physics.mega import mega_kernel_launch
    from humanoid_gym_tpu_torch.utils.platform import synchronize

    solver = "apgd" if device.type == "cpu" else "mega"

    def overrides(c):
        c.sim.solver.solver_type = solver

    t0 = time.perf_counter()
    env, cfg = registry.make_env(TASK, num_envs=envs, cfg_overrides=overrides, device=device,
                                 seed=0, group=group)
    tcfg = registry.get_task(TASK).make_train_cfg()
    ec = cfg.env
    net = actor_critic_from_cfg(ec, tcfg.policy, seed=0).to(device)
    replicate(list(net.parameters()), group)
    algo = PPOConfig.from_cfg(tcfg.algorithm)
    algo.num_steps_per_env = horizon
    ts = init_train_state(net, algo.learning_rate)
    state = env.init_state()
    n_local = env.num_envs
    obs = torch.zeros((n_local, ec.num_observations), device=device)
    priv = torch.zeros((n_local, ec.num_privileged_obs), device=device)
    train_iter = compiled_train_iter(env, net, algo, envs, group, perm_seed=0)
    gen = torch.Generator(device=device)
    gen.manual_seed(1 + (group.rank if group is not None else 0))
    synchronize(device)
    setup_s = time.perf_counter() - t0
    state_bytes = tensor_tree_bytes(state)
    after_setup = live_bytes(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    t0 = time.perf_counter()
    ts, state, obs, priv, _ = train_iter(ts, state, obs, priv, gen)
    synchronize(device)
    warmup_s = time.perf_counter() - t0
    mega_kernel_launch.launches = mega_kernel_launch.terrain_launches = 0
    t0 = time.perf_counter()
    ts, state, obs, priv, metrics = train_iter(ts, state, obs, priv, gen)
    value_loss = float(metrics["value_loss"])
    iter_s = time.perf_counter() - t0
    check_minibatch_split(metrics)
    launches = {"flat": mega_kernel_launch.launches, "terrain": mega_kernel_launch.terrain_launches}
    return {
        "rank": group.rank if group is not None else 0,
        "envs_local": n_local,
        "setup_s": setup_s, "warmup_s": warmup_s, "iter_s": iter_s,
        "value_loss": value_loss,
        "env_state_bytes": state_bytes,
        "live_bytes_after_setup": after_setup,
        "live_bytes_after_iter": live_bytes(device),
        "peak_bytes": torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None,
        "host_peak_rss_bytes": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024,
        "mega_launches": launches,
        "row_floats": rollout_row_floats(ec.num_observations, ec.num_privileged_obs,
                                         ec.num_actions),
        "solver": solver,
    }


def _rank_worker(work: str, envs: int, horizon: int, device_name: str) -> int:
    """One rank under the spawner: join the group through `work`, run, and
    write rank<r>.json there."""
    from humanoid_gym_tpu_torch.parallel.mesh import make_env_group

    group = make_env_group("gloo", device=device_name, init_method=f"file://{work}/rdv")
    try:
        out = run_rank(envs, horizon, group.device, group)
    finally:
        group.close()
    with open(os.path.join(work, f"rank{out['rank']}.json"), "w") as f:
        json.dump(out, f)
    return 0


def dryrun(envs: int = 16384, ranks: int = 1, horizon=None, device="cuda",
           timeout_s: float = 1800.0) -> dict:
    """The dry run's record: one rank in this process, or `ranks` spawned
    ranks (gloo) sharing the device."""
    import torch

    from humanoid_gym_tpu_torch.utils.platform import card_line, resolve_device

    device = resolve_device(device)
    if horizon is None:
        horizon = 60 if device.type == "cuda" else 8
    if envs % (2 * ranks):
        raise ValueError(f"--envs {envs} must split evenly over 2 robots x {ranks} ranks")
    if ranks == 1:
        per_rank = [run_rank(envs, horizon, device, None)]
        mesh = f"1 process on {device}"
    else:
        from humanoid_gym_tpu_torch.parallel.launch import RankJob

        dev_name = "cuda:0" if device.type == "cuda" else "cpu"
        with tempfile.TemporaryDirectory(prefix="hgt_config4_") as work:
            argv = [sys.executable, os.path.abspath(__file__), "--rank-worker", work,
                    "--envs", str(envs), "--horizon", str(horizon), "--device", dev_name]
            env = dict(os.environ, OMP_NUM_THREADS=os.environ.get("OMP_NUM_THREADS", "1"))
            RankJob(argv, ranks, env).wait(timeout_s)
            per_rank = []
            for r in range(ranks):
                with open(os.path.join(work, f"rank{r}.json")) as f:
                    per_rank.append(json.load(f))
        mesh = f"{ranks} gloo ranks " + ("sharing cuda:0" if device.type == "cuda" else "on the CPU")
    card = card_line(device)
    total_memory = torch.cuda.get_device_properties(device).total_memory if card else None
    row = per_rank[0]["row_floats"]
    state_total = sum(r["env_state_bytes"] for r in per_rank)
    proj = projection_t60_per_rank(state_total, envs, row, ranks)
    peak = max(r["peak_bytes"] for r in per_rank) if device.type == "cuda" else None
    where = (f"of the card's {total_memory / 2**30:.2f} GiB ({card}, "
             "torch.cuda.get_device_properties(0).total_memory)" if total_memory
             else "(a CPU run: no card read)")
    return {
        "task": TASK,
        "envs": envs,
        "ranks": ranks,
        "mesh": mesh,
        "horizon": horizon,
        "solver": per_rank[0]["solver"],
        "value_loss": per_rank[0]["value_loss"],
        "setup_s": max(r["setup_s"] for r in per_rank),
        "warmup_s": max(r["warmup_s"] for r in per_rank),
        "iter_s": max(r["iter_s"] for r in per_rank),
        "env_state_bytes_total": state_total,
        "env_state_bytes_per_env": state_total / envs,
        "rollout_bytes_total_at_T": envs * horizon * row * 4,
        "per_rank_live_bytes_after_setup": {str(r["rank"]): r["live_bytes_after_setup"]
                                            for r in per_rank},
        "per_rank_live_bytes_after_iter": {str(r["rank"]): r["live_bytes_after_iter"]
                                           for r in per_rank},
        "per_rank_peak_bytes": {str(r["rank"]): r["peak_bytes"] for r in per_rank},
        "host_peak_rss_bytes": max(r["host_peak_rss_bytes"] for r in per_rank),
        "projection_T60_per_device_bytes": proj,
        "measured_T60_peak_bytes": peak if horizon == 60 else None,
        "mega_launches": {k: sum(r["mega_launches"][k] for r in per_rank)
                          for k in ("flat", "terrain")},
        "device": card or "cpu",
        "card_total_memory_bytes": total_memory,
        "projection_note": (
            "per-rank persistent bytes at production T=60 = env-state shard + rollout shard + "
            "one permuted epoch copy (the JAX formula); at {} envs over {} rank(s) this is "
            "~{:.2f} GiB {}").format(envs, ranks, proj / 2**30, where),
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--envs", type=int, default=16384)
    ap.add_argument("--ranks", type=int, default=1)
    ap.add_argument("--horizon", type=int, default=None,
                    help="rollout length (default 60 on the card, 8 on the CPU)")
    ap.add_argument("--out", type=str, default=None)
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--rank-worker", type=str, default=None, help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    if a.rank_worker:
        sys.exit(_rank_worker(a.rank_worker, a.envs, a.horizon, a.device))
    out = dryrun(a.envs, a.ranks, a.horizon, a.device)
    if a.out:
        with open(a.out, "w") as f:
            json.dump(out, f, indent=1)
        print(f"# wrote {a.out}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
