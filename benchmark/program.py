"""The system under test, driven as `scripts/train_torch.py` drives it:
`registry.make_env` -> `OnPolicyRunner` -> `learn`, and the spans the
benchmark takes around its calls into each layer.

Nothing of the program is edited. The harness wraps three of the runner's
own bound methods on the instance (`_train_iter`, `_log`, `save`) to read
host times, and records the rollout buffers the training iteration writes
(`algo.ppo.Rollout`) so that the reference can judge what the timed path
produced.

The window. One `learn` call runs every iteration: iteration 0 captures
the iteration as a CUDA graph, and it and iteration 1 (`FOLLOW`) are copied
to the host for the correctness check. The program's set-up ends at the
dispatch of the next iteration (the copies' host time left out). Replays then go on, neither set-up nor
window, until `STEADY_AFTER_START_S` seconds after the process started:
for up to ~51 s after its start a process may find the card replaying the
same graph ~0.35 us a kernel slower, and the window opens on steady
replays. The window opens at the next dispatch and closes at the fetch of
the last iteration whose metrics the runner has consumed once `seconds`
have passed. The dispatch after that raises `WindowClosed` out of `learn`,
so the closing checkpoint of `learn` is not taken (users pay it once in a
run of thousands of iterations). Every iteration inside the window goes
through `learn`'s own loop: dispatch, the double-buffered metrics fetch,
the console and `metrics.jsonl` logging, and a checkpoint every
`save_interval` iterations.
"""

from __future__ import annotations

import dataclasses
import time

import torch

# the iterations copied to the host for the correctness check
FOLLOW = 2
# the window opens no earlier than this many seconds after the process
# started: in 69 of 70 logged runs on an H100 the card's slow replays had
# ended by 51.3 s
STEADY_AFTER_START_S = 55.0


class WindowClosed(Exception):
    """Raised from the wrapped dispatch once the window has closed."""


def _host(x):
    """A copy of a tensor tree on the host (a dataclass, dict, list or
    tuple of tensors; anything else is kept)."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    if dataclasses.is_dataclass(x):
        return {f.name: _host(getattr(x, f.name)) for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {k: _host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_host(v) for v in x) if not hasattr(x, "_fields") else \
            {k: _host(v) for k, v in x._asdict().items()}
    return x


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def check_config(cfg: dict, env_cfg, train_cfg) -> None:
    """Raise if the program's resolved task config is not the
    configuration the benchmark's file states: its fixed keys, and each key
    of the file's optional `"policy"` and `"algorithm"` objects against the
    attribute of that name of `train_cfg.policy` and `train_cfg.algorithm`
    (a configuration's own widths, such as a memory's size)."""
    est_dim = getattr(train_cfg.policy, "estimator_dim", 0)
    got = {
        "num_obs": env_cfg.env.num_observations,
        "num_privileged_obs": env_cfg.env.num_privileged_obs,
        "num_actions": env_cfg.env.num_actions,
        "actor_hidden": list(train_cfg.policy.actor_hidden_dims),
        "critic_hidden": list(train_cfg.policy.critic_hidden_dims),
        "estimator_dim": est_dim,
        "estimator_coef": float(getattr(train_cfg.algorithm, "estimator_coef", 0.0)),
        "decimation": env_cfg.control.decimation,
        "sim_dt": env_cfg.sim.dt,
        "solver_iterations": env_cfg.sim.solver.solver_iterations,
        "learning_epochs": train_cfg.algorithm.num_learning_epochs,
        "mini_batches": train_cfg.algorithm.num_mini_batches,
        "steps_per_env": train_cfg.runner.num_steps_per_env,
        "save_interval": train_cfg.runner.save_interval,
    }
    if est_dim:
        got["estimator_hidden"] = list(train_cfg.policy.estimator_hidden_dims)
    bad = {k: (v, cfg[k]) for k, v in got.items() if v != cfg[k]}
    for group in ("policy", "algorithm"):
        section = getattr(train_cfg, group)
        for k, want in cfg.get(group, {}).items():
            if not hasattr(section, k):
                bad[f"{group}.{k}"] = ("no such attribute", want)
                continue
            v = getattr(section, k)
            v = list(v) if isinstance(v, tuple) else v  # JSON holds a tuple as a list
            if v != want:
                bad[f"{group}.{k}"] = (v, want)
    if bad:
        raise RuntimeError(f"the program's config departs from {cfg['name']}.json "
                           f"(program, file): {bad}")


class RolloutRecorder:
    """Keeps the rollout buffers of the iteration the runner replays: the
    `Rollout` made while a CUDA graph is being captured (the graph writes
    each replay's rollout into those tensors), or on the CPU the newest
    one."""

    def __init__(self, ppo_module):
        self.module = ppo_module
        self.original = ppo_module.Rollout
        self.roll = None
        original = self.original
        recorder = self

        def record(*args, **kw):
            roll = original(*args, **kw)
            if roll.obs.device.type != "cuda" or torch.cuda.is_current_stream_capturing():
                recorder.roll = roll
            return roll

        self.record = record

    def __enter__(self):
        self.module.Rollout = self.record
        return self

    def __exit__(self, *exc):
        self.module.Rollout = self.original


def run(wl: dict, cfg: dict, seed: int, seconds: float, trace: bool, device: torch.device,
        t_start: float, steps_per_env: int, log_root: str, steady_after_s: float) -> dict:
    """Set up, wait for steady replays until `steady_after_s` after
    `t_start`, time the window, and (with `trace`) time single replays and
    profile two; returns the measurements and the snapshots the correctness
    check reads."""
    from humanoid_gym_tpu_torch import registry
    from humanoid_gym_tpu_torch.algo import ppo
    from humanoid_gym_tpu_torch.algo.capture import launch_counts
    from humanoid_gym_tpu_torch.runner.on_policy_runner import OnPolicyRunner

    ctx = {"device": device, "steps_per_env": steps_per_env}
    torch.manual_seed(seed)
    if device.type == "cuda":
        from humanoid_gym_tpu_torch.physics.cuda_build import kernel_library

        t = time.perf_counter()
        kernel_library()
        ctx["setup_build_s"] = time.perf_counter() - t

    envs = sum(wl["envs_per_robot"])

    def overrides(c):
        c.sim.solver.solver_type = cfg["solver"]

    t = time.perf_counter()
    env, env_cfg = registry.make_env(cfg["task"], num_envs=envs, cfg_overrides=overrides,
                                     device=device, seed=seed)
    _sync(device)
    ctx["setup_env_s"] = time.perf_counter() - t
    counts = [e.num_envs for e in env.envs] if hasattr(env, "envs") else [env.num_envs]
    if counts != list(wl["envs_per_robot"]):
        raise RuntimeError(f"the registry split {envs} envs as {counts}, the workload states "
                           f"{wl['envs_per_robot']}")
    train_cfg = registry.get_task(cfg["task"]).make_train_cfg()
    check_config(cfg, env_cfg, train_cfg)
    train_cfg.runner.num_steps_per_env = steps_per_env

    snaps = {}
    launches, logged, saves, events = [], [], [], []
    # `check_s`: host seconds of the snapshot copies, which are the check's
    # and are left out of the set-up times
    state = {"calls": 0, "t0": None, "warm": None, "check_s": 0.0, "setup_end": None}

    t_runner = time.perf_counter()
    with RolloutRecorder(ppo) as recorder:
        runner = OnPolicyRunner(env, train_cfg, log_dir=log_root, seed=seed)
        real_iter, real_log, real_save = runner._train_iter, runner._log, runner.save

        def train_iter(ts, env_state, obs, priv_obs, gen):
            i = state["calls"]
            now = time.perf_counter()
            if i == FOLLOW:
                state["setup_end"] = now
                ctx["setup_s"] = time.time() - t_start - state["check_s"]
                ctx["setup_capture_s"] = now - t_runner - state["check_s"]
                ctx["check_copy_s"] = state["check_s"]
            if state["t0"] is None and i > FOLLOW and time.time() - t_start >= steady_after_s:
                state["t0"], state["warm"] = now, i
                ctx["settle_s"] = now - state["setup_end"]
            elif state["t0"] is not None and now - state["t0"] >= seconds and \
                    any(p >= state["warm"] for p, _, _ in logged):
                raise WindowClosed
            warm = state["warm"]
            if i < FOLLOW:
                _sync(device)
                t = time.perf_counter()
                snaps[i] = {
                    "params": _host(dict(ts.net.named_parameters())),
                    "opt_mu": _host(ts.opt_mu), "opt_nu": _host(ts.opt_nu),
                    "opt_count": int(ts.opt_count), "lr": float(ts.lr),
                    "iteration": ts.iteration,
                    "env_state": _host(env_state), "obs": _host(obs), "priv_obs": _host(priv_obs),
                    "env_gen": [g.get_state() for g in env.generators()],
                }
                state["check_s"] += time.perf_counter() - t
            launches.append(sum(launch_counts()))
            if device.type == "cuda" and warm is not None:
                ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                ev[0].record()
            out = real_iter(ts, env_state, obs, priv_obs, gen)
            if device.type == "cuda" and warm is not None:
                ev[1].record()
                events.append(ev)
            if i < FOLLOW:
                _sync(device)
                t = time.perf_counter()
                snaps[i].update({
                    "rollout": _host(recorder.roll),
                    "metrics": _host(out[4]),
                    "params_after": _host(dict(ts.net.named_parameters())),
                    "opt_mu_after": _host(ts.opt_mu),
                    "last_priv_obs": _host(out[3]),
                })
                state["check_s"] += time.perf_counter() - t
            state["calls"] += 1
            return out

        def log(it, *args, **kw):
            logged.append((it, time.perf_counter(), args[3]))  # (it, time, dispatch dt)
            return real_log(it, *args, **kw)

        def save(path, *args, **kw):
            t = time.perf_counter()
            real_save(path, *args, **kw)
            saves.append(time.perf_counter() - t)

        runner._train_iter, runner._log, runner.save = train_iter, log, save
        try:
            runner.learn(10 ** 9, init_at_random_ep_len=True)
        except WindowClosed:
            pass
        finally:
            runner._train_iter, runner._log, runner.save = real_iter, real_log, real_save
    _sync(device)

    warm = state["warm"]
    inside = [(it, t, dt) for it, t, dt in logged if it >= warm]
    ctx["window_s"] = inside[-1][1] - state["t0"]
    ctx["window_iters"] = len(inside)
    ctx["iter_dt_s"] = [dt for it, _, dt in inside if it > warm]
    ctx["env_steps_per_iter"] = steps_per_env * envs
    # the kernel wrappers' launch counters, read at each dispatch: the
    # iterations warm .. warm + window_iters - 1 ran between these two reads
    ctx["launches_per_iter"] = (launches[warm + len(inside)] - launches[warm]) / len(inside)
    ctx["saves_s"] = saves
    ctx["memory_peak_bytes"] = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    # each window iteration's stream time, dispatch to its end: its device
    # work plus any wait of the stream for the host
    ctx["window_stream_ms"] = [a.elapsed_time(b) for a, b in events[:len(inside)]]

    if trace:
        measure_replays(ctx, runner, real_iter, device)
    runner.close()
    ctx["snaps"] = snaps
    del runner, env, recorder
    return ctx


def measure_replays(ctx: dict, runner, train_iter, device, n_timed: int = 5,
                    n_profiled: int = 2) -> None:
    """After the window: single iterations through the runner's own
    (captured) call, each timed alone by CUDA events, then `n_profiled`
    back to back under torch.profiler (the runner's `start_profile`), whose
    events are read in memory."""
    from humanoid_gym_tpu_torch.runner.on_policy_runner import start_profile

    def one():
        ts, es, obs, pobs, _ = train_iter(runner.train_state, runner.env_state, runner.obs,
                                          runner.priv_obs, runner.gen)
        runner.train_state, runner.env_state, runner.obs, runner.priv_obs = ts, es, obs, pobs

    ms = []
    for _ in range(n_timed):
        if device.type == "cuda":
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            one()
            b.record()
            b.synchronize()
            ms.append(a.elapsed_time(b))
        else:
            t = time.perf_counter()
            one()
            ms.append((time.perf_counter() - t) * 1e3)
    ctx["replay_ms"] = ms
    _sync(device)
    prof = start_profile(device)
    t = time.perf_counter()
    for _ in range(n_profiled):
        one()
    _sync(device)
    ctx["trace_window_s"] = time.perf_counter() - t
    prof.stop()
    ctx["profiled_iters"] = n_profiled
    ctx["profile"] = prof
