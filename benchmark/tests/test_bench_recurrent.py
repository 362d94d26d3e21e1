"""The recurrent cell `flat_lstm_4096` (configuration `xbotl_flat_lstm`,
judged by `benchmark/reference/recurrent.py`): its traced CPU rehearsal
reports the memory's and the scans' stage metrics and is correct, an
untraced one reports neither, the three new readers and `mfu` on made-up
contexts (a number with the stamps, None and no raise without the
tracer), the
configuration's checked keys, its nets' census, and the control and a
planted fault failing the cell's limits."""

import json
import sys

import pytest
import torch

from conftest import ROOT  # noqa: F401  (the repo root on sys.path)

SEED = 2 ** 31 + 133
WORKLOAD = "flat_lstm_4096"
NEW = ["stage_memory_ms", "stage_bptt_ms", "bptt_roofline"]


def _run(capsys, trace, calibrate=False, main=None):
    from benchmark import run

    argv = ["--workload", WORKLOAD, "--seed", str(SEED), "--seconds", "1", "--trace", trace,
            "--cpu-rehearsal"] + (["--calibrate"] if calibrate and main is None else [])
    assert (main or run.main)(argv) == 0
    out, err = capsys.readouterr()
    return json.loads(out.strip().splitlines()[-1]), err


def test_traced_rehearsal_reports_the_memory_stages(capsys):
    """`--trace 1` on the CPU: stage_memory_ms and stage_bptt_ms positive,
    the device shares (roofline, mfu) not read off the card, correct."""
    d, err = _run(capsys, "1")
    assert d["workload"] == f"{WORKLOAD}@cpu-rehearsal" and d["correct"] is True
    assert all(d["metrics"][m]["value"] > 0 and d["metrics"][m]["unit"] == "ms"
               for m in ("stage_memory_ms", "stage_bptt_ms"))
    assert "bptt_roofline" not in d["metrics"] and "mfu" not in d["metrics"]
    assert "stages: rollout.memory |" in err and "stages: update.bptt |" in err


def test_untraced_rehearsal_reports_none_of_them(capsys):
    d, err = _run(capsys, "0")
    assert d["correct"] is True
    assert not set(d["metrics"]) & set(NEW)
    assert {"env_steps_per_s", "setup_s"} <= set(d["metrics"])


def _ctx(device, ms=None):
    from benchmark import run

    wl, cfg = run.load_workload(WORKLOAD)
    ctx = {"device": torch.device(device), "config": cfg, "envs_per_robot": [4096],
           "steps_per_env": 60, "window_s": 50.0, "window_iters": 250}
    if ms is not None:
        ctx["stages"] = {"ms": {(k, None): v for k, v in ms.items()}}
    return ctx


def test_readers_on_a_made_up_context():
    """With the stamps present each reader returns a number: the stage ms
    as stamped, the roofline the reference's least time over the stage's,
    the mfu the census over the window's mean iteration."""
    from benchmark import census, run
    from benchmark.reference import recurrent

    ctx = _ctx("cuda", {"rollout.memory": 7.5, "update.bptt": 60.0, "update.grad": 80.0})
    read = {m: run.metric_reader(m)(ctx) for m in NEW + ["mfu"]}
    assert read["stage_memory_ms"] == 7.5 and read["stage_bptt_ms"] == 60.0
    cfg = dict(ctx["config"], steps_per_env=60)
    assert read["bptt_roofline"] == pytest.approx(
        recurrent.bptt_least_s(cfg, 4096) / 60e-3 * 100)
    assert read["mfu"] == pytest.approx(census.iteration_least_s(cfg, [4096]) / 0.2 * 100)
    assert 0 < read["bptt_roofline"] < 100 and 0 < read["mfu"] < 100


def test_readers_without_the_tracer_report_nothing(monkeypatch):
    """Where the program has no stage tracer, or no such stage was stamped,
    the stage readers and the roofline return None and none raises; off
    the card the shares are not read."""
    from benchmark import run

    monkeypatch.setitem(sys.modules, "humanoid_gym_tpu_torch.utils.tracing", None)
    ctx = _ctx("cuda")
    for m in ("stage_memory_ms", "stage_bptt_ms", "bptt_roofline"):
        assert run.metric_reader(m)(ctx) is None, m
    ctx = _ctx("cuda", {"rollout.policy": 12.0})
    for m in ("stage_memory_ms", "stage_bptt_ms", "bptt_roofline"):
        assert run.metric_reader(m)(ctx) is None, m
    assert run.metric_reader("mfu")(_ctx("cpu")) is None
    assert run.metric_reader("bptt_roofline")(_ctx("cpu", {"update.bptt": 1.0})) is None


def test_the_configuration_is_the_programs():
    """check_config holds the file's fixed keys and its policy block
    (rnn_type, rnn_hidden_size, rnn_num_layers, init_noise_std) against the
    registry's task; a changed width is refused."""
    from benchmark import program, run
    from humanoid_gym_tpu_torch import registry

    _, cfg = run.load_workload(WORKLOAD)
    spec = registry.get_task(cfg["task"])
    env_cfg, train_cfg = spec.make_env_cfg(), spec.make_train_cfg()
    program.check_config(cfg, env_cfg, train_cfg)
    assert run.reference_module(cfg).__name__ == "benchmark.reference.recurrent"
    bad = dict(cfg, policy=dict(cfg["policy"], rnn_hidden_size=128))
    with pytest.raises(RuntimeError, match="rnn_hidden_size"):
        program.check_config(bad, env_cfg, train_cfg)


def test_the_nets_census():
    """net_flops counts both LSTMs and their heads: 0.55 MFLOP of forward
    matmuls a sample against the MLP actor-critic's 1.85."""
    from benchmark import census, run
    from benchmark.reference import recurrent

    _, cfg = run.load_workload(WORKLOAD)
    cfg = dict(cfg, steps_per_env=60)
    actor = 4 * 64 * (705 + 64) + 64 * 32 + 32 * 12
    critic = 4 * 64 * (219 + 64) + 64 * 32 + 32 * 1
    n, T = 4096, 60
    want = n * T * 2 * (actor + critic) + n * 2 * critic + n * T * 2 * 3 * 2 * (actor + critic)
    assert census.nets_census(cfg) is recurrent.net_flops
    assert recurrent.net_flops(cfg, n) == want
    assert 2 * (actor + critic) == 547_648
    work = recurrent.bptt_work(cfg, n)
    # the observations take no gradient: their matmuls count twice, the
    # recurrent ones three times, in each of the 2 epochs
    assert work["matmul_flops"] == n * T * 2 * 2 * 4 * 64 * (2 * (705 + 219) + 3 * (64 + 64))


def test_control_and_a_planted_fault_fail_the_limits(capsys):
    """The reference at the precisions below the stated ones, and with the
    start state zeroed instead of carried (benchmark/calibrate_faults.py),
    each put in the program's place, fail a limit of the cell."""
    from benchmark import calibrate_faults, correct, run

    d, err = _run(capsys, "0", calibrate=True, main=calibrate_faults.main)
    assert d["correct"] is True
    limits = run.load_workload(WORKLOAD)[0]["limits"]
    lines = {json.loads(line.split(" ", 1)[1])["variant"]: json.loads(line.split(" ", 1)[1])
             for line in err.splitlines() if line.startswith("calibration ")}
    assert {"control", "no_reset", "zero_start", "program"} <= set(lines)
    for variant in ("control", "zero_start"):
        got = dict(lines[variant])
        got.pop("variant")
        assert correct.verdict(got, limits)[0] is False, variant
