"""scripts/scaling_bench_torch.py on the CPU: `measure` over 1 and 2 gloo
ranks started by parallel/launch.py, the artifact's keys, and the ratio
floors of the JAX package's tests/test_scaling_bench.py (slow)."""

import json
import os
import statistics
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from scripts import scaling_bench_torch as SB  # noqa: E402


@pytest.mark.parametrize("ranks", [1, 2])
def test_measure_gives_positive_steps_per_second(ranks):
    fps = SB.measure(ranks, envs_per_rank=4, iters=1, T=2, device="cpu")
    assert fps > 0


def test_artifact_keys(tmp_path, monkeypatch):
    """All three protocols at 1 and 2 ranks x 4 envs, one repeat, with
    `measure` (held above) standing in as a linear function of the batch:
    the JAX artifact's keys with ranks for devices, and its arithmetic."""
    calls = []

    def fake(ranks, envs_per_rank, iters, T, device, pin=False):
        calls.append((ranks, envs_per_rank, pin))
        return 100.0 * ranks * envs_per_rank

    monkeypatch.setattr(SB, "measure", fake)
    out = tmp_path / "scaling.json"
    SB.main(["--artifact", str(out), "--device", "cpu", "--max_ranks", "2", "--envs_per_rank", "4",
             "--iters", "1", "--horizon", "2", "--repeats", "1"])
    a = json.loads(out.read_text())
    assert set(a) == {"protocol", "fixed_host", "control", "pinned"}
    assert set(a["protocol"]) >= {"workload", "host", "stat", "fixed_host", "pinned", "control"}
    for points in (a["fixed_host"], a["pinned"]):
        assert [p["ranks"] for p in points] == [1, 2]
        for p in points:
            assert set(p) >= {"steps_per_sec", "repeats", "min", "max", "cv", "ranks", "envs",
                              "scaling_efficiency"} and p["steps_per_sec"] > 0
        assert [p["scaling_efficiency"] for p in points] == [1.0, 1.0]
    c = a["control"]
    assert (c["total_envs"], c["ranks_sharded"], c["sharded_over_unsharded"]) == (8, 2, 1.0)
    assert calls == [(1, 4, False), (2, 4, False), (1, 8, False), (2, 4, False), (1, 4, True),
                     (2, 4, True)]


def test_never_writes_the_jax_artifact():
    with pytest.raises(SystemExit, match="JAX package's artifact"):
        SB.main(["--artifact", SB.JAX_ARTIFACT, "--device", "cpu"])


@pytest.mark.slow
def test_sharded_matches_unsharded_same_batch():
    """The JAX test's control floor: the same 16 envs over 2 ranks against
    one process, median of 3, at least 0.75."""
    unsharded = statistics.median(SB.measure(1, 16, 2, 4, "cpu") for _ in range(3))
    sharded = statistics.median(SB.measure(2, 8, 2, 4, "cpu") for _ in range(3))
    assert sharded / unsharded >= 0.75


@pytest.mark.slow
def test_weak_scaling_efficiency():
    """The JAX test's weak-scaling floor, 1 -> 2 ranks, median of 3: 0.70."""
    fps1 = statistics.median(SB.measure(1, 8, 2, 4, "cpu") for _ in range(3))
    fps2 = statistics.median(SB.measure(2, 8, 2, 4, "cpu") for _ in range(3))
    assert fps2 / (2 * fps1) >= 0.70
