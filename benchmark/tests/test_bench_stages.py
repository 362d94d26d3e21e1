"""The stage metrics (benchmark/stages.py and its readers): reported by a
traced CPU rehearsal of each cell's configuration and by no untraced run;
silent, without raising, on a program that has no stage tracer; and the
kernel -> stage assignment of a profiled replay, on a made-up trace."""

import json
import sys

import numpy as np
import pytest

from conftest import ROOT  # noqa: F401  (the repo root on sys.path)

SEED = 2 ** 31 + 91
STAGE_METRICS = ["stage_policy_ms", "stage_physics_ms", "stage_terrain_ms", "stage_env_ms",
                 "stage_rewards_ms", "stage_obs_ms", "stage_gae_ms", "stage_update_ms",
                 "stage_adam_ms", "between_iters_ms"]
CAPTURE_METRICS = ["setup_warmup_s", "setup_record_s"]


def _run(capsys, workload, trace):
    from benchmark import run

    assert run.main(["--workload", workload, "--seed", str(SEED), "--seconds", "1", "--trace",
                     trace, "--cpu-rehearsal"]) == 0
    out, err = capsys.readouterr()
    return json.loads(out.strip().splitlines()[-1]), err


@pytest.mark.parametrize("workload", ["flat_4096", "deploy_4096"])
def test_traced_rehearsal_reports_the_stage_metrics(workload, capsys):
    """`--trace 1` reports all ten stage metrics (the terrain patches on the
    deploy cell only), each positive, and prints the stage table; the CPU
    has no capture, so the capture spans are not reported there."""
    d, err = _run(capsys, workload, "1")
    want = [m for m in STAGE_METRICS if m != "stage_terrain_ms" or workload == "deploy_4096"]
    got = [m for m in d["metrics"] if m in STAGE_METRICS + CAPTURE_METRICS]
    assert got == want
    assert all(d["metrics"][m]["value"] > 0 for m in want)
    assert all(d["metrics"][m]["unit"] == "ms" for m in want)
    assert d["correct"] is True
    assert "stages: stage | ms (stamps)" in err
    assert "stages: gaps between iterations" in err
    assert err.strip().splitlines()[-1].startswith("compared ")


def test_untraced_run_reports_none_of_them(capsys):
    d, err = _run(capsys, "flat_4096", "0")
    assert not set(d["metrics"]) & set(STAGE_METRICS + CAPTURE_METRICS)
    assert "stages:" not in err


def test_a_program_without_the_tracer_reports_nothing(monkeypatch):
    """Where the program has no stage tracer (the parent of the change that
    added it), every new reader returns None and none raises."""
    from benchmark import run

    monkeypatch.setitem(sys.modules, "humanoid_gym_tpu_torch.utils.tracing", None)
    ctx = {"device": None, "config": {}, "envs_per_robot": [4], "steps_per_env": 4}
    for name in STAGE_METRICS + CAPTURE_METRICS:
        assert run.metric_reader(name)(ctx) is None, name


class _Stage:
    def __init__(self, name, robot, depth, enter, exit):
        self.name, self.robot, self.depth, self.enter, self.exit = name, robot, depth, enter, exit


class _Trace:
    """A DeviceTrace's `kernels` and `ops`: (name, start, end, kind)."""

    def __init__(self, ops):
        self.ops = sorted(ops, key=lambda o: o[1])
        self.kernels = [o for o in self.ops if o[3] == "kernel"]


def test_kernels_go_to_the_innermost_stage_bracketing_them():
    """Two replays of a map root(a, b(c)): each operation (kernel or copy)
    is charged to the innermost stage open between the stamp kernels
    around it; one after a replay's last stamp (between replays) or before
    the first replay to none; the CUPTI spans and the stamps' own spans per
    stage, and their offset."""
    from benchmark import stages

    # slots: 0 root in, 1 a in, 2 a out, 3 b in, 4 c in, 5 c out, 6 b out, 7 root out
    stage_map = [_Stage("iter", None, 0, 0, 7), _Stage("a", None, 1, 1, 2),
                 _Stage("b", 0, 1, 3, 6), _Stage("c", 0, 2, 4, 5)]
    ops, raw = [], []
    for base in (1000, 5000):
        at = [base + 100 * k for k in range(8)]
        ops += [("hgt_stamp(unsigned long*, int)", t, t + 2, "kernel") for t in at]
        raw.append(np.array(at, dtype=np.int64) - 7)  # the card's clock, 7 ns behind
        ops += [("gemm_a", base + 110, base + 150, "kernel"),      # in a
                ("mul_b", base + 310, base + 330, "kernel"),       # in b, before c
                ("gather_c", base + 410, base + 480, "kernel"),    # in c
                ("Memcpy HtoD", base + 520, base + 530, "memcpy"),  # in b, after c
                ("add_root", base + 250, base + 260, "kernel"),    # between a and b
                ("copy_after", base + 900, base + 950, "kernel")]  # after the root
    ops.append(("perm_draw", 100, 200, "kernel"))  # before the first replay
    out = stages.assign(_Trace(ops), stage_map, raw)
    p = out["profile"]
    assert p["a"]["busy_ms"] == pytest.approx(40e-6) and p["a"]["ops"] == 1
    assert p["b@0"]["busy_ms"] == pytest.approx(30e-6) and p["b@0"]["ops"] == 2
    assert p["c@0"]["busy_ms"] == pytest.approx(70e-6)
    assert p["iter"]["busy_ms"] == pytest.approx(10e-6)
    assert p["c@0"]["top"] == [("gather_c", pytest.approx(70e-6))]
    assert p["b@0"]["cupti_ms"] == pytest.approx(300e-6) == p["b@0"]["stamp_ms"]
    assert p["iter"]["cupti_ms"] == pytest.approx(700e-6)
    assert "(none)" not in p
    name, ms, split = out["top_ops"][0]
    assert name == "gather_c" and split == [("c@0", pytest.approx(70e-6))]
    assert out["offset_ns"]["median"] == 7 and out["offset_ns"]["range"] == 0
    assert out["offset_ns"]["rate_ppm"] == pytest.approx(0, abs=1e-6)
    assert out["timer_step_ns"]["min"] == 100


def test_assignment_needs_every_stamp_kernel(capsys):
    from benchmark import stages

    stage_map = [_Stage("iter", None, 0, 0, 1)]
    trace = _Trace([("hgt_stamp(unsigned long*, int)", 10, 12, "kernel")])
    assert stages.assign(trace, stage_map, [np.array([10, 20])]) == {}
    assert "no kernel assignment" in capsys.readouterr().err
