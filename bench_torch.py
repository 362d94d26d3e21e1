"""Headline benchmark of the PyTorch/CUDA port: PPO env steps/s at 4096 envs
(XBot-L). The counterpart of bench.py.

Runs the training iteration of `algo.ppo.make_train_iter` (a T-step
rollout through the 1 kHz contact physics, GAE, the minibatched PPO update),
captured on the card (`algo.capture`, bench.py's `jax.jit`: one CUDA graph
at world size 1, graphs cut at each all-reduce under several ranks;
captured in the first warm-up iteration), eagerly on the CPU,
and reports value = T * N / iteration time, the runner's Perf/total_fps.
vs_baseline is reported against bench.py's nominal 60,000 steps/s (an Isaac
Gym humanoid-gym figure on a desktop GPU at 4096 envs), and mfu is the
iteration's FLOPs (`utils/roofline.py` `iteration_flops`) over the time at
the H100's bf16 peak; both only for the flat task.

Timing, after three warm-up iterations:
  pipelined (default)  max(HGT_BENCH_ITERS, 5) iterations dispatched back to
                       back; each iteration's value_loss is fetched after
                       the next one is dispatched (the runner's
                       double-buffered logging), one hard fetch closes the
                       window; host clock, mean iteration;
  HGT_BENCH_SYNC=1     HGT_BENCH_ITERS iterations, each closed by a fetch;
                       the median.

Environment (bench.py's variables):
  HGT_BENCH_ENVS     envs (default 4096)
  HGT_BENCH_ITERS    timed iterations (default 3)
  HGT_BENCH_TASK     a registered task instead of flat XBot-L
  HGT_BENCH_MESH=N   the run env-sharded over N ranks (`parallel/`): at N = 1
                     one process in a group of its own (nccl on the card,
                     gloo on the CPU); for N > 1 one process per rank, each
                     on a card of its own (CPU ranks over gloo on the CPU)
  HGT_BENCH_PROFILE  a directory: a torch.profiler Chrome trace of the
                     timed window is written there
  HGT_SOLVER         the contact solver (mega on the card, apgd on the CPU)
  HGT_BENCH_DEVICE   cuda (default) or cpu; without a card cuda raises

Prints one JSON line to stdout with bench.py's keys: metric, value, unit,
solver, mesh_devices (with a mesh), vs_baseline and mfu (flat task only);
a `# bench:` line on stderr names the protocol and the device. Unlike
bench.py there is no fallback ladder: the requested solver runs, or the
script exits non-zero with its error, so a failing kernel is never hidden
behind another solver.

    python bench_torch.py                                       # on the card
    HGT_BENCH_DEVICE=cpu HGT_BENCH_ENVS=8 python bench_torch.py # plain versions
"""

import json
import os
import statistics
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

NOMINAL_REFERENCE_FPS = 60_000.0
FLAT_TASK = "humanoid_ppo"  # XBotLCfg + XBotLCfgPPO, bench.py's default run
WARMUP_ITERS = 3
MFU_HORIZON = 60  # the roofline census behind mfu counts the recipe's T


def measure(task: str, num_envs: int, iters: int, solver: str, sync: bool, device,
            group=None, profile_dir=None, horizon=None) -> dict:
    """Time `task`'s training iteration at `num_envs` (global) envs with
    `solver`, under the pipelined or the sync protocol, with a rollout of
    `horizon` steps (default: the recipe's T). Returns T, the iteration
    time dt (s), the warm-up's seconds and the last value_loss."""
    import torch

    from humanoid_gym_tpu_torch import registry
    from humanoid_gym_tpu_torch.algo.networks import actor_critic_from_cfg
    from humanoid_gym_tpu_torch.algo.capture import compiled_train_iter
    from humanoid_gym_tpu_torch.algo.ppo import PPOConfig, check_minibatch_split, init_train_state
    from humanoid_gym_tpu_torch.parallel.mesh import replicate
    from humanoid_gym_tpu_torch.parallel.multihost import rank_seed
    from humanoid_gym_tpu_torch.physics import mega as MG
    from humanoid_gym_tpu_torch.runner.on_policy_runner import (
        start_fetch,
        start_profile,
        stop_profile,
    )

    def overrides(c):
        c.sim.solver.solver_type = solver

    env, cfg = registry.make_env(task, num_envs=num_envs, cfg_overrides=overrides, device=device,
                                 seed=0, group=group)
    tcfg = registry.get_task(task).make_train_cfg()
    net = actor_critic_from_cfg(cfg.env, tcfg.policy, seed=0).to(device)
    replicate(list(net.parameters()), group)
    algo = PPOConfig.from_cfg(tcfg.algorithm)
    algo.num_steps_per_env = T = horizon or tcfg.runner.num_steps_per_env
    ts = init_train_state(net, algo.learning_rate)
    train_iter = compiled_train_iter(env, net, algo, num_envs, group, perm_seed=0)
    state = env.init_state()
    obs = torch.zeros((env.num_envs, cfg.env.num_observations), device=device)
    priv = torch.zeros((env.num_envs, cfg.env.num_privileged_obs), device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(rank_seed(1, group))

    def fetch(metrics, event=None):
        if event is not None:
            event.synchronize()
        check_minibatch_split(metrics)
        return float(metrics["value_loss"])

    t0 = time.perf_counter()
    for _ in range(WARMUP_ITERS):
        ts, state, obs, priv, metrics = train_iter(ts, state, obs, priv, gen)
        fetch(metrics)
    warm_s = time.perf_counter() - t0

    MG.mega_kernel_launch.launches = MG.mega_kernel_launch.terrain_launches = 0
    prof = start_profile(device) if profile_dir else None
    try:
        if sync:
            times = []
            for _ in range(iters):
                t0 = time.perf_counter()
                ts, state, obs, priv, metrics = train_iter(ts, state, obs, priv, gen)
                value_loss = fetch(metrics)
                times.append(time.perf_counter() - t0)
            dt = statistics.median(times)
        else:
            n = max(iters, 5)
            pending = None
            t0 = time.perf_counter()
            for _ in range(n):
                ts, state, obs, priv, metrics = train_iter(ts, state, obs, priv, gen)
                nxt = start_fetch(metrics, device)
                if pending is not None:
                    fetch(*pending)
                pending = nxt
            value_loss = fetch(*pending)
            dt = (time.perf_counter() - t0) / n
    finally:
        if prof is not None:
            rank = f"_rank{group.rank}" if group is not None and group.world > 1 else ""
            protocol = "sync" if sync else "pipelined"
            path = os.path.join(profile_dir, f"bench_{protocol}{rank}.json")
            stop_profile(prof, device, path)
            print(f"# profile trace written to {path}", file=sys.stderr, flush=True)
    # the mega kernel's launches in the timed window (the wrappers count
    # them on the card; the plain versions on the CPU count none)
    launches = {"mega": MG.mega_kernel_launch.launches,
                "mega_terrain": MG.mega_kernel_launch.terrain_launches}
    return {"T": T, "dt": dt, "warm_s": warm_s, "value_loss": value_loss,
            "iters": iters if sync else max(iters, 5), "launches": launches}


def _one_process_group(device, work: str):
    """This process as rank 0 of a group of its own (file rendezvous in
    `work`): nccl on the card, gloo on the CPU."""
    from humanoid_gym_tpu_torch.parallel.mesh import make_env_group

    backend = "nccl" if device.type == "cuda" else "gloo"
    return make_env_group(backend, device=device, init_method=f"file://{work}/rdv", rank=0,
                          world=1)


def _ranks(mesh: int, kwargs: dict, device) -> dict:
    """`measure` over `mesh` processes, one rank each (`parallel/launch.py`),
    on cuda:<rank> or the CPU; the slowest rank's iteration time."""
    import torch

    from humanoid_gym_tpu_torch.parallel.launch import RankJob

    if device.type == "cuda" and torch.cuda.device_count() < mesh:
        raise RuntimeError(f"HGT_BENCH_MESH={mesh} needs {mesh} cards, found "
                           f"{torch.cuda.device_count()} (one rank a card)")
    with tempfile.TemporaryDirectory(prefix="hgt_bench_") as work:
        argv = [sys.executable, os.path.abspath(__file__), "--rank-worker", work,
                json.dumps(dict(kwargs, device=device.type))]
        env = dict(os.environ)
        if device.type == "cpu":  # the ranks share the host's cores
            env.setdefault("OMP_NUM_THREADS", str(max(1, (os.cpu_count() or 1) // mesh)))
        RankJob(argv, mesh, env).wait(timeout_s=3600)
        res = [json.load(open(os.path.join(work, f"rank{r}.json"))) for r in range(mesh)]
    return max(res, key=lambda r: r["dt"])


def _rank_worker(work: str, kwargs: str) -> int:
    from humanoid_gym_tpu_torch.parallel.mesh import make_env_group

    kw = json.loads(kwargs)
    backend = "nccl" if kw["device"] == "cuda" else "gloo"
    group = make_env_group(backend, device=None if backend == "nccl" else "cpu",
                           init_method=f"file://{work}/rdv")
    try:
        res = measure(kw["task"], kw["num_envs"], kw["iters"], kw["solver"], kw["sync"],
                      group.device, group, kw["profile_dir"], kw["horizon"])
    finally:
        group.close()
    with open(os.path.join(work, f"rank{group.rank}.json"), "w") as f:
        json.dump(res, f)
    return 0


def run(num_envs: int = 4096, iters: int = 3, solver=None, task=None, mesh: int = 0,
        sync: bool = False, device="cuda", profile_dir=None) -> dict:
    """The benchmark: build and time the run, print the `# bench:` line to
    stderr and the JSON line to stdout; returns the JSON object. `task`
    None is the flat XBot-L run (`humanoid_ppo`), whose T must be the 60
    that mfu's census counts."""
    from humanoid_gym_tpu_torch import registry
    from humanoid_gym_tpu_torch.utils.platform import resolve_device
    from humanoid_gym_tpu_torch.utils.roofline import PEAK_BF16_FLOPS, iteration_flops

    device = resolve_device(device)
    solver = solver or ("mega" if device.type == "cuda" else "apgd")
    name = task or FLAT_TASK
    T = registry.get_task(name).make_train_cfg().runner.num_steps_per_env
    if not task and T != MFU_HORIZON:
        raise ValueError(f"mfu's census (utils/roofline.py iteration_flops) is of the flat recipe "
                         f"at T={MFU_HORIZON}; this run has T={T}")
    # the ranks of a mesh take T from here, so every rank runs this recipe's
    kwargs = dict(task=name, num_envs=num_envs, iters=iters, solver=solver, sync=sync,
                  profile_dir=profile_dir, horizon=T)
    if mesh > 1:
        res = _ranks(mesh, kwargs, device)
    elif mesh == 1:
        with tempfile.TemporaryDirectory(prefix="hgt_bench_") as work:
            group = _one_process_group(device, work)
            try:
                res = measure(device=device, group=group, **kwargs)
            finally:
                group.close()
    else:
        res = measure(device=device, **kwargs)
    T, dt = res["T"], res["dt"]
    fps = T * num_envs / dt
    protocol = (f"sync median of {iters}" if sync
                else f"pipelined mean of {max(iters, 5)}")
    launches = res["launches"]
    print(f"# bench: {num_envs} envs, T={T}, solver={solver}, iter_time {dt:.3f}s, "
          f"warm-up {res['warm_s']:.1f}s ({WARMUP_ITERS} iterations), {protocol}, "
          f"mega launches {launches['mega']} terrain {launches['mega_terrain']} in "
          f"{res['iters']} timed iterations, device={device}" + (f", task={task}" if task else "")
          + (f", mesh={mesh} (env-sharded ranks)" if mesh else ""), file=sys.stderr, flush=True)
    out = {
        "metric": "ppo_env_steps_per_sec_per_chip" + (f"[{task}]" if task else ""),
        "value": round(fps, 1),
        "unit": "env_steps/s",
        "solver": solver,
    }
    if mesh:
        out["mesh_devices"] = mesh
    if not task:
        out["vs_baseline"] = round(fps / NOMINAL_REFERENCE_FPS, 4)
        out["mfu"] = round(iteration_flops(num_envs, T=T) / (dt * PEAK_BF16_FLOPS), 4)
    print(json.dumps(out), flush=True)
    return out


def main() -> int:
    if sys.argv[1:2] == ["--rank-worker"]:
        return _rank_worker(*sys.argv[2:4])
    run(
        num_envs=int(os.environ.get("HGT_BENCH_ENVS", 4096)),
        iters=int(os.environ.get("HGT_BENCH_ITERS", 3)),
        solver=os.environ.get("HGT_SOLVER"),
        task=os.environ.get("HGT_BENCH_TASK") or None,
        mesh=int(os.environ.get("HGT_BENCH_MESH", "0")),
        sync=bool(os.environ.get("HGT_BENCH_SYNC")),
        device=os.environ.get("HGT_BENCH_DEVICE", "cuda"),
        profile_dir=os.environ.get("HGT_BENCH_PROFILE") or None,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
