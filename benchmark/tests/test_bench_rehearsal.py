"""The whole run on the CPU at a few envs (the kernels' plain versions),
its refusal without a card, and the check's control and faults: with the
timed path broken underneath, `correct` comes out false."""

import dataclasses
import json
import subprocess
import sys

import pytest
import torch

from conftest import ROOT

SEED = 2 ** 31 + 77


def _line(text):
    return json.loads(text.strip().splitlines()[-1])


def _bench(*args, timeout=1200):
    return subprocess.run([sys.executable, "benchmark/run.py", *args], cwd=ROOT,
                          capture_output=True, text=True, timeout=timeout)


@pytest.mark.parametrize("workload,trace", [("flat_4096", "0"), ("deploy_4096", "1")])
def test_cpu_rehearsal_line_names_the_cpu(workload, trace):
    p = _bench("--workload", workload, "--seed", str(SEED), "--seconds", "1", "--trace", trace,
               "--cpu-rehearsal")
    assert p.returncode == 0, p.stderr[-3000:]
    d = _line(p.stdout)
    assert d["workload"] == f"{workload}@cpu-rehearsal"
    assert d["device"]["platform"] == "cpu" and d["device"]["kind"] == "cpu"
    assert d["correct"] is True and d["attempted"] >= 1 and d["failed"] == 0
    assert list(d)[-1] == "compared"
    assert p.stderr.strip().splitlines()[-1].startswith("compared ")


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = _bench("--workload", "flat_4096", "--seed", "1", "--seconds", "1", "--trace", "0",
               timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def _main(argv, capsys):
    from benchmark import run

    assert run.main(argv) == 0
    out, err = capsys.readouterr()
    return _line(out), err


def _rehearse(workload, capsys, calibrate=False):
    argv = ["--workload", workload, "--seed", str(SEED), "--seconds", "1", "--trace", "0",
            "--cpu-rehearsal"] + (["--calibrate"] if calibrate else [])
    return _main(argv, capsys)


def test_fault_state_unchanged(monkeypatch, capsys):
    """A step that returns the train state unchanged."""
    from humanoid_gym_tpu_torch.algo import ppo

    monkeypatch.setattr(ppo, "_adam_step", lambda ts, grads, lr, **kw: ts.opt_count.add_(1))
    d, _ = _rehearse("flat_4096", capsys)
    assert d["correct"] is False
    assert d["compared"]["change_gap"]["value"] > d["compared"]["change_gap"]["limit"]


class _HalfMinibatches:
    """torch, except that `split` keeps the first half of each piece: the
    update's minibatches lose half their rows, and the mean is taken over
    the rest."""

    def __getattr__(self, name):
        return getattr(torch, name)

    @staticmethod
    def split(t, size, *args, **kw):
        return tuple(c[: c.shape[0] // 2] for c in torch.split(t, size, *args, **kw))


@pytest.mark.parametrize("workload", ["flat_4096", "deploy_4096"])
def test_fault_half_of_the_batch(workload, monkeypatch, capsys):
    from humanoid_gym_tpu_torch.algo import ppo

    monkeypatch.setattr(ppo, "torch", _HalfMinibatches())
    d, _ = _rehearse(workload, capsys)
    assert d["correct"] is False


def test_fault_stale_rows(monkeypatch, capsys):
    """An env step whose observations from the rollout's third row on are
    the row before's (a stale buffer): the rows held to each other fail."""
    from humanoid_gym_tpu_torch.envs import env as env_mod

    real = env_mod.HumanoidEnv.step
    seen = {"calls": 0, "last": None}

    def stale(self, state, actions):
        new_state, tr = real(self, state, actions)
        seen["calls"] += 1
        if seen["calls"] > 2 and seen["last"] is not None:
            tr = dataclasses.replace(tr, obs=seen["last"])
        seen["last"] = tr.obs
        return new_state, tr

    monkeypatch.setattr(env_mod.HumanoidEnv, "step", stale)
    d, _ = _rehearse("flat_4096", capsys)
    assert d["correct"] is False
    assert d["compared"]["stack_gap"]["value"] > d["compared"]["stack_gap"]["limit"]


@pytest.mark.parametrize("workload", ["flat_4096", "deploy_4096"])
def test_control_fails_the_limits(workload, capsys):
    """The reference at the precisions below the stated ones (float8
    hidden-layer matmuls, TF32), put in the program's place, fails a
    limit of the cell."""
    from benchmark import correct, run

    d, err = _rehearse(workload, capsys, calibrate=True)
    assert d["correct"] is True
    control = next(json.loads(line.split(" ", 1)[1]) for line in err.splitlines()
                   if line.startswith("calibration ") and '"control"' in line)
    control.pop("variant")
    limits = run.load_workload(workload)[0]["limits"]
    assert correct.verdict(control, limits)[0] is False


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["flat_4096", "deploy_4096"])
def test_cell_on_the_card_and_its_control(card, workload):
    """A short run of the cell at its own size: correct, on the card; the
    control's readings from the same run fail the cell's limits."""
    from benchmark import correct, run

    p = _bench("--workload", workload, "--seed", str(SEED), "--seconds", "3", "--trace", "0",
               "--calibrate")
    assert p.returncode == 0, p.stderr[-3000:]
    d = _line(p.stdout)
    assert d["correct"] is True and d["device"]["platform"] == "gpu"
    control = next(json.loads(line.split(" ", 1)[1]) for line in p.stderr.splitlines()
                   if line.startswith("calibration ") and '"control"' in line)
    control.pop("variant")
    assert correct.verdict(control, run.load_workload(workload)[0]["limits"])[0] is False
