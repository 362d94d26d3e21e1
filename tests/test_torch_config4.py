"""scripts/config4_dryrun_torch.py on the CPU: humanoid_joint_deploy at 64
envs over 2 gloo ranks, horizon 2, through the registry and
make_train_iter; each rank's bytes, the value loss, the record's keys."""

import json
import math
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_two_rank_dry_run(tmp_path):
    out = tmp_path / "config4.json"
    run = subprocess.run([sys.executable, os.path.join(ROOT, "scripts", "config4_dryrun_torch.py"),
                          "--envs", "64", "--ranks", "2", "--horizon", "2", "--device", "cpu",
                          "--out", str(out)], capture_output=True, text=True, timeout=600, cwd=ROOT,
                         env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert run.returncode == 0, run.stderr[-3000:]
    d = json.loads(out.read_text())
    assert json.loads(run.stdout.strip().splitlines()[-1]) == d
    assert (d["task"], d["envs"], d["ranks"], d["horizon"], d["solver"]) == (
        "humanoid_joint_deploy", 64, 2, 2, "apgd")
    assert math.isfinite(d["value_loss"])
    for key in ("per_rank_live_bytes_after_setup", "per_rank_live_bytes_after_iter"):
        per = list(d[key].values())
        assert len(per) == 2 and max(per) < 2 * min(per), (key, per)
    assert d["rollout_bytes_total_at_T"] == 64 * 2 * 964 * 4
    assert 4000 < d["env_state_bytes_per_env"] < 6000  # the JAX artifact: 4900
    assert d["measured_T60_peak_bytes"] is None and d["device"] == "cpu"
    assert d["mega_launches"] == {"flat": 0, "terrain": 0}
