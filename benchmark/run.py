"""The training-throughput benchmark of humanoid_gym_tpu_torch on the card.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. It reads the cell `benchmark/workloads/<name>.json`,
its configuration `benchmark/configs/<config>.json` and the metrics
`BENCHMARK.json` lists for it, each computed by `benchmark/metrics/<metric>.py`;
so a cell, a configuration or a metric is added as files. It drives the
program as `scripts/train_torch.py` does (`benchmark/program.py`), times
`--seconds` of `OnPolicyRunner.learn`, then checks what the timed path
produced against the plain reference under `benchmark/reference/` (the
module the configuration names, `follow` where it names none;
`benchmark/correct.py`), and prints one JSON line last: with `--trace 0`
the cell's end-to-end metrics, with `--trace 1` its per-layer metrics, read
from a profile of two replays after the window.

Without a CUDA card, or with fewer cards than the cell asks for, it exits 2
and prints no result. `--cpu-rehearsal` runs the same path on the CPU at a
few envs, with the kernels' plain versions, for the tests: its line names
the CPU and a workload that is no cell's.
"""

from __future__ import annotations


def _process_start() -> float:
    """The wall time this process started, from /proc; now where that
    cannot be read."""
    import time

    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f if line.startswith("btime"))
        import os

        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


T_START = _process_start()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
# the modules that may not be loaded in the process that prints a result
FORBIDDEN = ("jax", "jaxlib", "flax", "humanoid_gym_tpu")
# kept out of the process as well: TensorBoard's optional TensorFlow
# backend loads JAX where both are installed
REFUSED = FORBIDDEN + ("tensorflow",)
REHEARSAL_ENVS, REHEARSAL_T = 4, 4


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_workload(name: str) -> tuple:
    """(workload, config) of a cell, found by name."""
    wl = load_json(BENCH_DIR, "workloads", f"{name}.json")
    cfg = load_json(BENCH_DIR, "configs", f"{wl['config']}.json")
    return wl, cfg


def metric_reader(name: str):
    """`read(ctx)` of benchmark/metrics/<name>.py."""
    path = os.path.join(BENCH_DIR, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def reference_module(cfg: dict):
    """The configuration's reference module (`benchmark.reference.module`),
    refused where it follows another number of env steps than the one
    `correct.NUMBERS` names gaps for."""
    from benchmark import correct
    from benchmark.reference import module

    mod = module(cfg)
    steps = getattr(mod, "STEPS", None)
    if steps != correct.STEPS:
        raise RuntimeError(f"{mod.__name__} follows STEPS = {steps} env steps; the check "
                           f"compares {correct.STEPS}")
    return mod


def cell_metrics(bench: dict, workload: str, trace: bool) -> list:
    """The entries of BENCHMARK.json this run reports: the end-to-end
    metrics, or with `trace` the per-layer ones, each where its
    `workloads` (if it has one) names the cell."""
    entries = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in entries if workload in m.get("workloads", [workload])]


def forbidden_modules() -> list:
    return sorted(m for m, mod in sys.modules.items()
                  if mod is not None and m.split(".")[0] in FORBIDDEN)


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--cpu-rehearsal", action="store_true",
                   help="run on the CPU at a few envs (tests only; never a cell's numbers)")
    p.add_argument("--calibrate", action="store_true",
                   help="also print the control's and the faults' readings on standard error "
                        "(the window opens without waiting for steady replays)")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    os.environ["HGT_WANDB"] = "0"  # no network sink
    os.environ["USE_FLAX"] = "0"
    for name in REFUSED:  # an import of a name mapped to None fails as a missing module
        sys.modules.setdefault(name, None)
    build = os.path.join(ROOT, "build")
    # compile caches at fixed places in the checkout (the kernel library
    # builds into build/kernels/ there by itself)
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)

    bench = load_json(ROOT, "BENCHMARK.json")
    wl, cfg = load_workload(args.workload)
    chips = next((w["chips"] for w in bench["workloads"] if w["name"] == args.workload), 1)

    import torch

    if args.cpu_rehearsal:
        device = torch.device("cpu")
        wl = dict(wl, envs_per_robot=[REHEARSAL_ENVS] * len(wl["envs_per_robot"]))
        steps = REHEARSAL_T
        torch.set_num_threads(2)
    else:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            print(f"needs {chips} CUDA device(s); found "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
        steps = cfg["steps_per_env"]

    from benchmark import correct, program
    from benchmark.devtrace import DeviceTrace

    ref_module = reference_module(cfg)
    log_root = tempfile.mkdtemp(prefix="hgt_bench_")
    try:
        # the control's and the rehearsal's readings need no steady card
        steady = 0.0 if args.cpu_rehearsal or args.calibrate else program.STEADY_AFTER_START_S
        ctx = program.run(wl, cfg, args.seed, args.seconds, bool(args.trace), device, T_START,
                          steps, log_root, steady)
    finally:
        shutil.rmtree(log_root, ignore_errors=True)
    ctx.update(workload=wl, config=cfg, envs_per_robot=wl["envs_per_robot"])
    ctx["trace"] = None
    if args.trace and device.type == "cuda":
        tr = DeviceTrace(ctx.pop("profile"), ctx["profiled_iters"])
        ctx["trace"] = tr if tr.kernels else None
    ctx.pop("profile", None)

    # the check, once the program's state is freed
    snaps = ctx.pop("snaps")
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ref = ref_module.Reference(cfg, wl, args.seed, device, steps)
    ref_start = ref.start()
    start = {k: snaps[0][k] for k in ("params", "obs", "priv_obs")}
    ref_out = correct.reference_outputs(ref, snaps, "stated")
    prog_out = correct.program_outputs(snaps, ref)
    numbers = correct.gaps(prog_out, ref_out, snaps, start, ref_start)
    if args.calibrate:
        for variant in ("control", "half"):
            got = correct.gaps(correct.reference_outputs(ref, snaps, variant), ref_out, snaps,
                               ref.start(variant), ref_start)
            print("calibration " + json.dumps({"variant": variant, **got}), file=sys.stderr)
        shifted = [correct.rows(ref, s, correct.shifted_rows(s["rollout"])) for s in snaps.values()]
        shifted = {k: max(r[k] for r in shifted) for k in shifted[0]}
        print("calibration " + json.dumps({"variant": "row_shift", **shifted}), file=sys.stderr)
        print("calibration " + json.dumps({"variant": "program", **numbers}), file=sys.stderr)
        print("step outliers (envs over 1e-3, of them done flipped, whole-batch gap): "
              f"{correct.step_outliers(prog_out, ref_out)}", file=sys.stderr)
    ref.close()
    ok, rows = correct.verdict(numbers, wl.get("limits", {}))

    metrics = {}
    for m in cell_metrics(bench, args.workload, bool(args.trace)):
        value = metric_reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    found = forbidden_modules()
    if found:
        print(f"modules that may not be loaded here: {found}", file=sys.stderr)
        return 3

    device_info = {
        "platform": "gpu" if device.type == "cuda" else "cpu",
        "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "count": 1,
        "memory_peak_bytes": ctx["memory_peak_bytes"],
    }
    result = {"workload": args.workload + ("@cpu-rehearsal" if args.cpu_rehearsal else ""),
              "correct": ok, "attempted": ctx["window_iters"], "failed": 0, "metrics": metrics,
              "device": device_info}
    if args.trace and ctx["trace"] is not None:
        tr = ctx["trace"]
        device_info.update(busy_s=tr.busy_s(), window_s=ctx["trace_window_s"])
        result["breakdown"] = {"device_ops": tr.top_ops(), "idle_gaps": tr.idle_gaps()}
    print(f"settle: {ctx['settle_s']:.4f} s of replays after set-up, before the window; "
          f"the check's copies took {ctx['check_copy_s']:.4f} s of set-up, left out of it",
          file=sys.stderr)
    print(f"window: {ctx['window_iters']} iterations in {ctx['window_s']:.4f} s; "
          f"{len(ctx['iter_dt_s'])} dispatch-to-dispatch samples; "
          f"{ctx['launches_per_iter']:.1f} kernel launches a window iteration; "
          f"saves {ctx['saves_s']}; stream ms an iteration {ctx['window_stream_ms']}",
          file=sys.stderr)
    result["compared"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    for k, v, lim in rows:
        print(f"compared {k}: {v!r} limit {lim!r}" + (" (not compared)" if lim is None else ""),
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
