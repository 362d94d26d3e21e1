"""bench_torch.py, the port's counterpart of bench.py, on the CPU at 8 envs.

The recipe's T (60) makes one CPU iteration take tens of seconds, so the
runs here override the registered recipes' `num_steps_per_env` to 4; the
CLI itself has no T switch, as bench.py has none."""

import json
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import bench_torch as B  # noqa: E402
from humanoid_gym_tpu_torch import registry  # noqa: E402

torch.set_num_threads(1)

N, T = 8, 4
# bench.py's JSON keys (bench.py:237-272)
TASK_KEYS = {"metric", "value", "unit", "solver"}
FLAT_KEYS = TASK_KEYS | {"vs_baseline", "mfu"}


@pytest.fixture
def short_recipes(monkeypatch):
    """Every registered task's train config at T = 4; returns the
    iteration times `measure` reported, in order."""
    for name in registry.task_names():
        spec = registry.get_task(name)

        def make(spec=spec):
            cfg = spec.make_train_cfg()
            cfg.runner.num_steps_per_env = T
            return cfg

        monkeypatch.setitem(registry._REGISTRY, name, spec._replace(make_train_cfg=make))
    dts = []
    real = B.measure

    def measured(*a, **k):
        res = real(*a, **k)
        dts.append(res["dt"])
        return res

    monkeypatch.setattr(B, "measure", measured)
    return dts


@pytest.mark.parametrize("task,mesh,sync", [
    ("humanoid_ppo_terrain_robust", 0, False),
    ("humanoid_ppo", 1, False),
    ("humanoid_ppo", 0, True),
    ("humanoid_ppo", 2, True),
], ids=["terrain-pipelined", "flat-mesh1", "flat-sync", "flat-mesh2"])
def test_run_prints_bench_py_line(short_recipes, task, mesh, sync, capsys, monkeypatch):
    """A named task at 8 envs and T = 4 (the terrain task, the flat task
    through a world-size-1 gloo group, the sync protocol): one JSON line
    with bench.py's keys for a task run (no vs_baseline, no mfu;
    mesh_devices with a mesh), value = T x N / dt, and the `# bench:` line
    naming the protocol and the device. At mesh 2 the ranks are two CPU
    processes over gloo, each timing itself; the slower one's time counts."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # a mesh's rank processes: one thread each
    out = B.run(num_envs=N, iters=2, task=task, mesh=mesh, sync=sync, device="cpu")
    printed = capsys.readouterr()
    assert json.loads(printed.out.strip().splitlines()[-1]) == out
    assert set(out) == TASK_KEYS | ({"mesh_devices"} if mesh else set())
    assert out["metric"] == f"ppo_env_steps_per_sec_per_chip[{task}]"
    assert out["unit"] == "env_steps/s" and out["solver"] == "apgd"
    assert out.get("mesh_devices", 0) == mesh
    if mesh < 2:  # the ranks of a mesh measure in their own processes
        (dt,) = short_recipes
        assert out["value"] == round(T * N / dt, 1)
    assert out["value"] > 0
    protocol = "sync median of 2" if sync else "pipelined mean of 5"
    assert f"# bench: {N} envs, T={T}, solver=apgd" in printed.err
    assert protocol in printed.err and "device=cpu" in printed.err
    # the plain versions launch no kernel
    assert f"mega launches 0 terrain 0 in {2 if sync else 5} timed iterations" in printed.err


def test_flat_run_needs_the_census_horizon(short_recipes):
    """The flat run's mfu counts the recipe's T = 60; at T = 4 the run
    raises before it builds anything (bench.py asserts it, after timing)."""
    with pytest.raises(ValueError, match="T=60"):
        B.run(num_envs=N, device="cpu")
    assert short_recipes == []


def test_flat_line_formulas(monkeypatch, capsys):
    """The flat line at the recipe's T = 60: bench.py's keys, vs_baseline
    against the nominal 60,000 steps/s, mfu = iteration_flops / (dt x the
    H100's bf16 peak). `measure` is replaced by a fixed time: a CPU
    iteration at T = 60 takes tens of seconds."""
    from humanoid_gym_tpu_torch.utils.roofline import PEAK_BF16_FLOPS, iteration_flops

    monkeypatch.setattr(B, "measure", lambda **k: {
        "T": 60, "dt": 0.5, "warm_s": 1.0, "iters": 5, "launches": {"mega": 300, "mega_terrain": 0}})
    out = B.run(num_envs=4096, device="cpu")
    assert set(out) == FLAT_KEYS
    assert out["metric"] == "ppo_env_steps_per_sec_per_chip"
    fps = 60 * 4096 / 0.5
    assert out["value"] == round(fps, 1)
    assert out["vs_baseline"] == round(fps / 60_000.0, 4)
    assert out["mfu"] == round(iteration_flops(4096, T=60) / (0.5 * PEAK_BF16_FLOPS), 4)
    assert 0 < out["mfu"] < 1
    assert "pipelined mean of 5" in capsys.readouterr().err


def test_unavailable_solver_exits_nonzero_without_fallback(tmp_path):
    """HGT_SOLVER naming a solver the port does not run: the CLI exits
    non-zero with the error and prints no JSON line; no other solver runs
    in its place (bench.py falls back down a ladder)."""
    env = dict(os.environ, HGT_BENCH_DEVICE="cpu", HGT_BENCH_ENVS="4",
               HGT_SOLVER="mega_interpret", OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, os.path.join(ROOT, "bench_torch.py")],
                         capture_output=True, text=True, timeout=300, env=env, cwd=str(tmp_path))
    assert res.returncode != 0
    assert res.stdout.strip() == ""
    assert "mega_interpret" in res.stderr and "# bench:" not in res.stderr


def test_cuda_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        B.run(num_envs=N, device="cuda")


def test_profile_dir_gets_a_trace_of_the_timed_window(short_recipes, tmp_path, capsys):
    """HGT_BENCH_PROFILE: the runner's profiler code writes one Chrome trace
    of the timed window, named by the protocol."""
    B.run(num_envs=N, iters=1, task="humanoid_ppo", sync=True, device="cpu",
          profile_dir=str(tmp_path))
    assert os.listdir(tmp_path) == ["bench_sync.json"]
    trace = json.load(open(tmp_path / "bench_sync.json"))
    assert trace["traceEvents"]
    printed = capsys.readouterr()
    assert f"# profile trace written to {tmp_path / 'bench_sync.json'}" in printed.err
    assert len(printed.out.strip().splitlines()) == 1  # stdout holds the JSON line only
