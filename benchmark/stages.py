"""The training iteration's stages, read from the program's stage stamps
(humanoid_gym_tpu_torch/utils/tracing.py) in a phase of their own.

The phase runs in `--trace 1` runs only, once, when the first stage metric
is read: after the window, the timed and profiled replays and the check,
none of which it changes (they run the unstamped graph). It builds the
cell's env and runner again from the run's seed (the one `program.run` gave
`torch.manual_seed`) and turns tracing on (`OnPolicyRunner.set_tracing`).
On the card it first replays the new stamped graph until it runs steady
(`settle`: a graph fresh from its capture can replay ~0.35 us a kernel
slower for seconds, as the window's first replays do). It then runs
`learn(K)` through the runner's own loop: K = 30 on the card, 3 in the CPU
rehearsal, the first `SKIP` iterations left out of every reading. On the
card it then times 5 stamped
single iterations between CUDA events, as `program.measure_replays` times
the unstamped ones, and profiles 2 (the runner's `start_profile`), in which
each kernel is assigned to the innermost stage whose `hgt_stamp` kernels
bracket it on the stream. It prints its tables on standard error and keeps
in `ctx["stages"]`:

- `ms`: mean ms an iteration of each (stage, robot) from the stamps,
  profiler off (a stage's time includes its child stages');
- `covered`: the mean share of an iteration's span (first stamp to last)
  that the stages directly under the root and after it cover;
- `gaps`: (ms, runner span open at its start) of each gap from the last
  stamp of an iteration to the first of the next;
- on the card, `stamped_replay_ms` and `profile` (per stage the profiled
  replays' own stamps, the CUPTI times of the same stamp kernels, the
  device ms and count of the operations inside it (kernels, copies and
  fills: a graph captured after a profiler session has run may show some
  copies as copies and not as kernels), its top operations), the ten
  largest operations and the stages that hold them, the CUPTI-minus-stamp
  offset and the `%globaltimer` step.

A program without the stage tracer gives None, and every reader of this
module then reports nothing.
"""

from __future__ import annotations

import bisect
import re
import shutil
import statistics
import sys
import tempfile
import time

import numpy as np
import torch

ITERATIONS = {"cuda": 30, "cpu": 3}
SKIP = 2
N_TIMED, N_PROFILED = 5, 2
# settled: SETTLE_RUN replays in a row within SETTLE_SLACK of the window's
# median single replay (`replay_ms`, unstamped; the stamps cost 0.5-1.4 %,
# the slow replays 12-16 %), or SETTLE_S seconds gone
SETTLE_RUN, SETTLE_SLACK, SETTLE_S = 3, 1.04, 60.0
STAMP = re.compile(r"\bhgt_stamp\b")


def _key(name: str, robot) -> str:
    return name if robot is None else f"{name}@{robot}"


def short(kernel: str, width: int = 90) -> str:
    """A kernel's name without the namespaces and return type that every
    PyTorch kernel shares."""
    for noise in ("void ", "at::native::", "(anonymous namespace)::", "std::"):
        kernel = kernel.replace(noise, "")
    return kernel[:width]


def first_capture(ctx: dict):
    """The host spans (name -> seconds) of the first capture in this process:
    the window's, which tracing never touches; None without one or without
    the tracer."""
    if "capture_spans" not in ctx:
        try:
            from humanoid_gym_tpu_torch.utils.tracing import CAPTURE_SPANS
        except ImportError:
            CAPTURE_SPANS = []
        ctx["capture_spans"] = ({k: (b - a) * 1e-9 for k, (a, b) in CAPTURE_SPANS[0].items()}
                                if CAPTURE_SPANS else None)
    return ctx["capture_spans"]


def measure(ctx: dict):
    """`ctx["stages"]`, measured at the first call (module docstring)."""
    if "stages" not in ctx:
        first_capture(ctx)
        ctx["stages"] = _measure(ctx)
        if ctx["stages"] is not None:
            report(ctx["stages"], ctx)
    return ctx["stages"]


def ms_of(ctx: dict, *names: str):
    """The summed stamp ms an iteration of the stages `names` over every
    robot, or None where the program has no tracer or none of them ran."""
    st = measure(ctx)
    if st is None:
        return None
    hits = [v for (name, _), v in st["ms"].items() if name in names]
    return sum(hits) if hits else None


def _measure(ctx: dict):
    try:
        from humanoid_gym_tpu_torch.utils.tracing import StageTracer  # noqa: F401
    except ImportError:
        return None
    from humanoid_gym_tpu_torch import registry
    from humanoid_gym_tpu_torch.runner.on_policy_runner import OnPolicyRunner

    device, cfg = ctx["device"], ctx["config"]
    seed = torch.initial_seed()

    def overrides(c):
        c.sim.solver.solver_type = cfg["solver"]

    log_root = tempfile.mkdtemp(prefix="hgt_stages_")
    try:
        env, _ = registry.make_env(cfg["task"], num_envs=sum(ctx["envs_per_robot"]),
                                   cfg_overrides=overrides, device=device, seed=seed)
        train_cfg = registry.get_task(cfg["task"]).make_train_cfg()
        train_cfg.runner.num_steps_per_env = ctx["steps_per_env"]
        runner = OnPolicyRunner(env, train_cfg, log_dir=log_root, seed=seed)
        runner.set_tracing(True)
        tracer = runner.tracer
        settled = settle(runner, ctx) if device.type == "cuda" else None
        runner.learn(ITERATIONS[device.type], init_at_random_ep_len=True)
        its = tracer.iterations[SKIP:]
        out = {"ms": tracer.stage_ms(first=SKIP), "iterations": len(its),
               "covered": statistics.mean(i.covered_ns / (i.end - i.start) for i in its),
               "spans_ms": [(i.end - i.start) * 1e-6 for i in its],
               "gaps": [(ns * 1e-6, name) for ns, name in tracer.gaps(first=SKIP)],
               "clock": tracer.clock, "slots": tracer.slots, "settle": settled}
        if device.type == "cuda":
            offset, _, at = tracer.read_clock()
            out["clock_drift_ppm"] = (offset - tracer.clock[0]) / (at - tracer.clock_at) * 1e6
            out.update(_replays(runner, tracer, device))
        del runner, env
    finally:
        shutil.rmtree(log_root, ignore_errors=True)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def _one(runner) -> None:
    """One iteration through the runner's own (captured) call, its tracer
    active (the first call captures)."""
    with runner.tracer.activate():
        ts, es, obs, pobs, _ = runner._train_iter(runner.train_state, runner.env_state,
                                                  runner.obs, runner.priv_obs, runner.gen)
    runner.train_state, runner.env_state, runner.obs, runner.priv_obs = ts, es, obs, pobs


def _timed(runner) -> float:
    """`_one` between CUDA events: its ms."""
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    _one(runner)
    b.record()
    b.synchronize()
    return a.elapsed_time(b)


def settle(runner, ctx: dict) -> dict:
    """Capture the stamped iteration and replay it until SETTLE_RUN
    replays in a row run within SETTLE_SLACK of the window's median single
    replay, or SETTLE_S seconds have gone: {seconds, replays, first and
    last ms, whether it settled}."""
    target = statistics.median(ctx["replay_ms"]) * SETTLE_SLACK
    t0, ms, run = time.perf_counter(), [], 0
    while run < SETTLE_RUN and time.perf_counter() - t0 < SETTLE_S:
        ms.append(_timed(runner))
        run = run + 1 if ms[-1] <= target else 0
    return {"seconds": time.perf_counter() - t0, "replays": len(ms), "first_ms": ms[1:2],
            "last_ms": ms[-1], "settled": run >= SETTLE_RUN}


def _replays(runner, tracer, device) -> dict:
    """Stamped single iterations through the runner's captured call: timed
    between CUDA events, then profiled, each profiled replay's stamps read
    after it."""
    from benchmark.devtrace import DeviceTrace
    from humanoid_gym_tpu_torch.runner.on_policy_runner import start_profile

    ms = [_timed(runner) for _ in range(N_TIMED)]
    torch.cuda.synchronize(device)
    prof = start_profile(device)
    raw = []
    for _ in range(N_PROFILED):
        _one(runner)
        raw.append(tracer.stamps().cpu().numpy().astype(np.int64))
    torch.cuda.synchronize(device)
    prof.stop()
    out = {"stamped_replay_ms": statistics.median(ms)}
    out.update(assign(DeviceTrace(prof, N_PROFILED), tracer.stages, raw))
    return out


def assign(trace, stages, raw: list) -> dict:
    """Per stage of the map `stages` over the profiled replays whose stamps
    are `raw` (one array a replay): its mean ms from those stamps and from
    the CUPTI times of the same stamp kernels, the device ms and count of
    the operations inside it (the innermost stage open between the stamps
    that bracket them), and its top operations; the ten largest operations
    and the stages that hold them; the CUPTI-minus-stamp offsets and the
    stamps' step. Empty where the trace does not hold the replays' stamp
    kernels."""
    slots = len(raw[0])
    stamps = [k for k in trace.kernels if STAMP.search(k[0])]
    if len(stamps) != slots * len(raw):
        print(f"stages: {len(stamps)} stamp kernels in the profile, not "
              f"{slots * len(raw)}: no kernel assignment", file=sys.stderr)
        return {}
    n = len(raw)
    raws = np.stack(raw)
    cupti = np.array([s for _, s, _, _ in stamps], dtype=np.int64).reshape(n, slots)
    offset = cupti - raws
    # the innermost stage open after each slot's stamp
    open_after, stack = [], []
    events = sorted([(r.enter, True, r) for r in stages] + [(r.exit, False, r) for r in stages],
                    key=lambda e: e[0])
    for _, entering, r in events:
        if entering:
            stack.append(r)
        else:
            stack.pop()
        open_after.append(_key(stack[-1].name, stack[-1].robot) if stack else None)
    prof, where = {}, {}

    def row(key):
        return prof.setdefault(key, {"stamp_ms": 0.0, "cupti_ms": 0.0, "busy_ms": 0.0,
                                     "ops": 0.0, "by_op": {}})

    for r in stages:
        k = _key(r.name, r.robot)
        row(k)["stamp_ms"] += float((raws[:, r.exit] - raws[:, r.enter]).sum()) * 1e-6 / n
        row(k)["cupti_ms"] += float((cupti[:, r.exit] - cupti[:, r.enter]).sum()) * 1e-6 / n
    for name, s, e, kind in trace.ops:
        if STAMP.search(name):
            continue
        j = int(np.searchsorted(cupti[:, 0], s, side="right")) - 1
        if j < 0:
            continue
        i = bisect.bisect_right(cupti[j], s) - 1
        if i >= slots - 1:
            continue  # after the replay's last stamp: between iterations
        key = open_after[i] or "(none)"
        ms = (e - s) * 1e-6 / n
        row(key)["busy_ms"] += ms
        row(key)["ops"] += 1.0 / n
        row(key)["by_op"][name] = row(key)["by_op"].get(name, 0.0) + ms
        where.setdefault(name, {})
        where[name][key] = where[name].get(key, 0.0) + ms
    for v in prof.values():
        v["top"] = sorted(v.pop("by_op").items(), key=lambda x: -x[1])[:3]
    kernels = sorted(where.items(), key=lambda x: -sum(x[1].values()))[:10]
    steps = np.diff(np.sort(raws.ravel()))
    steps = steps[steps > 0]
    # CUPTI's times against the stamps: a constant offset and a rate, and
    # what the straight line leaves
    x, y = (raws - raws.min()).ravel().astype(np.float64), offset.ravel().astype(np.float64)
    rate, at0 = np.polyfit(x, y, 1)
    resid = y - (at0 + rate * x)
    # from one stamp to the next within a replay: CUPTI's interval minus the stamps'
    jitter = np.abs(np.diff(offset, axis=1)).ravel()
    return {"profile": prof,
            "top_ops": [(name, sum(by.values()), sorted(by.items(), key=lambda x: -x[1])[:3])
                            for name, by in kernels],
            "offset_ns": {"median": float(np.median(y)), "range": float(y.max() - y.min()),
                          "rate_ppm": float(rate * 1e6),
                          "residual_iqr": float(np.subtract(*np.percentile(resid, [75, 25]))),
                          "residual_p01_p99": float(np.subtract(*np.percentile(resid, [99, 1]))),
                          "residual_range": float(resid.max() - resid.min()),
                          "step_p50_p99_max": [float(np.percentile(jitter, 50)),
                                               float(np.percentile(jitter, 99)),
                                               float(jitter.max())]},
            "timer_step_ns": {"min": int(steps.min()) if steps.size else None,
                              "gcd": int(np.gcd.reduce(steps)) if steps.size else None}}


def report(st: dict, ctx: dict) -> None:
    """The stage tables on standard error."""
    err = sys.stderr
    prof = st.get("profile", {})
    spans = st["spans_ms"]
    print(f"stages: settle {st['settle']}; {st['iterations']} stamped iterations read "
          f"({st['slots']} stamps each, spans {min(spans):.3f} / {statistics.median(spans):.3f} / "
          f"{max(spans):.3f} ms); the stages under the root cover {st['covered'] * 100:.3f} % of an "
          f"iteration's span; clock offset {st['clock'][0]} ns read in a bracket of "
          f"{st['clock'][1]} ns", file=err)
    print("stages: stage | ms (stamps) | ms (profile, CUPTI) | ms (profiled stamps) | busy ms | "
          "ops | top ops (ms)", file=err)
    for (name, robot), ms in sorted(st["ms"].items(), key=lambda x: -x[1]):
        k = _key(name, robot)
        p = prof.get(k, {})
        top = "; ".join(f"{short(n, 70)} ({t:.3f})" for n, t in p.get("top", []))
        print(f"stages: {k} | {ms:.4f} | {p.get('cupti_ms', float('nan')):.4f} | "
              f"{p.get('stamp_ms', float('nan')):.4f} | {p.get('busy_ms', float('nan')):.4f} | "
              f"{p.get('ops', float('nan')):.1f} | {top}", file=err)
    by_span = {}
    for ms, name in st["gaps"]:
        by_span[name] = by_span.get(name, 0.0) + ms
    longest = sorted(st["gaps"], reverse=True)[:5]
    print(f"stages: gaps between iterations, ms by runner span {by_span}; longest {longest}",
          file=err)
    if "stamped_replay_ms" in st:
        base = ctx.get("replay_ms")
        base = statistics.median(base) if base else float("nan")
        print(f"stages: stamped replay {st['stamped_replay_ms']:.4f} ms beside replay_ms "
              f"{base:.4f} ({(st['stamped_replay_ms'] / base - 1) * 100:+.3f} %)", file=err)
    for name, ms, by in st.get("top_ops", []):
        split = ", ".join(f"{k} {v:.3f}" for k, v in by)
        print(f"stages: op {short(name)} | {ms:.3f} ms an iteration | in {split}", file=err)
    if "offset_ns" in st:
        print(f"stages: CUPTI minus stamp offset (ns) {st['offset_ns']}; %globaltimer steps "
              f"(ns) {st['timer_step_ns']}; card clock against the host's over the learn: "
              f"{st['clock_drift_ppm']:+.2f} ppm", file=err)

