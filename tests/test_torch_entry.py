"""The port's train entry point, scripts/train_torch.py, on the CPU: a short
run writes its checkpoints, metrics and config; an unknown task and a
resume from an empty log root fail before the env is built."""

import glob
import importlib.util
import json
import os
import subprocess
import sys

import pytest
import torch

from humanoid_gym_tpu_torch import registry
from humanoid_gym_tpu_torch.utils.helpers import get_args

# The tensors here are tiny: one intra-op thread per process keeps parallel
# test workers from oversubscribing the cores (the default is one per core).
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "scripts", "train_torch.py")


def _train_fn():
    spec = importlib.util.spec_from_file_location("train_torch", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.train


def test_train_script_cpu_run(tmp_path):
    """`--task humanoid_ppo --num_envs 8 --max_iterations 2 --device cpu`:
    two console lines, model_0 / model_2 checkpoints, metrics.jsonl with two
    finite records, config.json recording the CPU default solver."""
    env = dict(os.environ, HGT_WANDB="0", OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    env.pop("HGT_SOLVER", None)
    res = subprocess.run(
        [sys.executable, SCRIPT, "--task", "humanoid_ppo", "--num_envs", "8",
         "--max_iterations", "2", "--device", "cpu", "--run_name", "probe",
         "--log_root", str(tmp_path)],
        capture_output=True, text=True, timeout=600, env=env, cwd=str(tmp_path),
    )
    assert res.returncode == 0, res.stderr[-2000:]
    assert "it 0/2" in res.stdout and "it 1/2" in res.stdout
    runs = glob.glob(str(tmp_path / "*_probe"))
    assert len(runs) == 1
    names = sorted(os.listdir(runs[0]))
    assert "model_0.ckpt" in names and "model_2.ckpt" in names
    assert "metrics.jsonl" in names and "config.json" in names
    lines = [json.loads(ln) for ln in open(os.path.join(runs[0], "metrics.jsonl"))]
    assert [ln["iter"] for ln in lines] == [0, 1]
    assert all(v == v and abs(v) != float("inf") for ln in lines for v in ln.values())
    cfg = json.load(open(os.path.join(runs[0], "config.json")))
    assert cfg["env"]["env"]["num_envs"] == 8
    assert cfg["env"]["sim"]["solver"]["solver_type"] == "apgd"
    assert cfg["train"]["runner"]["max_iterations"] == 2
    payload = torch.load(os.path.join(runs[0], "model_2.ckpt"), weights_only=True)
    assert payload["iter"] == 2 and payload["env_state"]["phys"]["qpos"].shape == (8, 19)


def test_unknown_task_raises_keyerror_naming_the_registered(tmp_path):
    args = get_args(["--task", "humanoid_ppo_terrain", "--device", "cpu",
                     "--log_root", str(tmp_path)])
    with pytest.raises(KeyError) as exc:
        _train_fn()(args)
    for name in ("humanoid_ppo", "humanoid_ppo_small", "humanoid_ppo_robust"):
        assert name in str(exc.value)
    assert registry.task_names() == ["humanoid_ppo", "humanoid_ppo_robust", "humanoid_ppo_small"]


def test_resume_on_empty_log_root_fails_before_env_build(tmp_path, monkeypatch):
    built = []
    monkeypatch.setattr(registry, "make_env", lambda *a, **k: built.append(1))
    args = get_args(["--task", "humanoid_ppo", "--resume", "--device", "cpu", "--num_envs", "8",
                     "--log_root", str(tmp_path)])
    with pytest.raises(ValueError, match="no runs in"):
        _train_fn()(args)
    assert not built


def test_cuda_device_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    args = get_args(["--task", "humanoid_ppo", "--log_root", str(tmp_path)])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA card"):
        _train_fn()(args)


def test_registry_make_env_applies_overrides():
    def ov(cfg):
        cfg.sim.solver.solver_type = "pgs"

    env, cfg = registry.make_env("humanoid_ppo_small", num_envs=2, cfg_overrides=ov, device="cpu")
    assert env.num_envs == 2 and cfg.sim.solver.solver_type == "pgs"
    assert cfg.env.episode_length_s == 12.0 and not env._kernel_fk
    _, rcfg = registry.make_env("humanoid_ppo_robust", num_envs=2, device="cpu",
                                cfg_overrides=lambda c: setattr(c.sim.solver, "solver_type", "apgd"))
    assert rcfg.domain_rand.randomize_contact_compliance
