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


def test_train_script_two_ranks_on_cpu(tmp_path):
    """The script as 2 ranks under the launcher's variables (RANK,
    WORLD_SIZE, MASTER_ADDR / MASTER_PORT, as torchrun sets them) with
    `--device cpu --backend gloo --num_envs 4`: one console line per
    iteration (rank 0's alone), one run directory, the final checkpoint with
    one env shard of 2 envs per rank."""
    from humanoid_gym_tpu_torch.parallel.launch import RankJob

    env = dict(os.environ, HGT_WANDB="0", OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    env.pop("HGT_SOLVER", None)
    outs = RankJob([sys.executable, SCRIPT, "--task", "humanoid_ppo", "--num_envs", "4",
                    "--max_iterations", "1", "--device", "cpu", "--backend", "gloo",
                    "--run_name", "ranks", "--log_root", str(tmp_path)], 2, env).wait(600)
    assert "it 0/1" in outs[0] and "it 0/1" not in outs[1]
    runs = glob.glob(str(tmp_path / "*_ranks"))
    assert len(runs) == 1
    assert sorted(f for f in os.listdir(runs[0]) if f.startswith("model_")) == [
        "model_0.ckpt", "model_1.ckpt", "model_1.ckpt.envshard0", "model_1.ckpt.envshard1"]
    payload = torch.load(os.path.join(runs[0], "model_1.ckpt"), weights_only=True)
    assert payload["env_shards"] == 2 and "env_state" not in payload
    for r in range(2):
        shard = torch.load(os.path.join(runs[0], f"model_1.ckpt.envshard{r}"), weights_only=True)
        assert shard["world"] == 2 and shard["env_state"]["phys"]["qpos"].shape == (2, 19)


TASKS = ["humanoid_joint_deploy", "humanoid_joint_ppo", "humanoid_ppo", "humanoid_ppo_deploy",
         "humanoid_ppo_robust", "humanoid_ppo_rubble", "humanoid_ppo_small", "humanoid_ppo_terrain",
         "humanoid_ppo_terrain_robust", "humanoid_s_ppo"]


def test_unknown_task_raises_keyerror_naming_the_registered(tmp_path):
    """A task name the registry does not hold raises a KeyError that names
    the registered ones: every task of the JAX package's registry, and the
    port's own recurrent-policy task."""
    from humanoid_gym_tpu import registry as jreg

    args = get_args(["--task", "humanoid_ppo_unknown", "--device", "cpu",
                     "--log_root", str(tmp_path)])
    with pytest.raises(KeyError) as exc:
        _train_fn()(args)
    for name in TASKS + ["humanoid_ppo_lstm"]:
        assert name in str(exc.value)
    assert registry.task_names() == sorted(TASKS + ["humanoid_ppo_lstm"])
    assert TASKS == jreg.task_names()


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


@pytest.mark.parametrize("task", ["humanoid_ppo_terrain", "humanoid_ppo_terrain_robust",
                                  "humanoid_ppo_rubble", "humanoid_ppo_deploy"])
def test_terrain_task_trains_on_cpu(task, tmp_path):
    """Each terrain task builds at 4 envs on the CPU (the full 20 x 20 map,
    2100 x 2100 nodes for the terrain tasks; 20 x 20 5 m rubble or
    deployment-field patches) as
    the reference registry builds it, and one PPO iteration (T cut to 4,
    solver mega: the plain terrain step) runs through OnPolicyRunner.learn
    with finite losses and levels in range."""
    from humanoid_gym_tpu import registry as jreg
    from humanoid_gym_tpu_torch.runner import OnPolicyRunner

    def ov(cfg):
        cfg.sim.solver.solver_type = "mega"

    env, cfg = registry.make_env(task, num_envs=4, cfg_overrides=ov, device="cpu")
    jcfg = jreg.get_task(task).make_env_cfg()
    for name in ("mesh_type", "curriculum", "style", "num_rows", "num_cols", "terrain_length",
                 "max_init_terrain_level", "terrain_proportions", "rubble_base", "rubble_span",
                 "curriculum_mode"):
        assert getattr(cfg.terrain, name) == getattr(jcfg.terrain, name), name
    assert vars(cfg.domain_rand) == vars(jcfg.domain_rand)
    assert vars(cfg.rewards.scales) == vars(jcfg.rewards.scales)
    assert env.terrain_map.height_field.shape == (
        cfg.terrain.num_rows * int(cfg.terrain.terrain_length / 0.1) + 500, 2100)
    tcfg = registry.get_task(task).make_train_cfg()
    assert tcfg.runner.experiment_name == jreg.get_task(task).make_train_cfg().runner.experiment_name
    tcfg.runner.num_steps_per_env = 4
    os.environ["HGT_WANDB"] = "0"
    runner = OnPolicyRunner(env, tcfg, log_dir=str(tmp_path), seed=0)
    runner.learn(1)
    line = json.loads(open(os.path.join(str(tmp_path), "metrics.jsonl")).readline())
    assert all(v == v and abs(v) != float("inf") for v in line.values())
    lv = runner.env_state.terrain_level
    assert 0 <= int(lv.min()) and int(lv.max()) < cfg.terrain.num_rows


def test_deploy_task_and_style_are_refused():
    """`humanoid_ppo_deploy` is registered with the reference's config, and
    the "deploy" terrain style refuses, where the map is built, a
    `deploy_mjcf` whose model has no hfield (the flat XBot-L MJCF)."""
    from humanoid_gym_tpu import registry as jreg
    from humanoid_gym_tpu_torch import XBOT_MJCF

    cfg = registry.get_task("humanoid_ppo_deploy").make_env_cfg()
    assert vars(cfg.terrain) == vars(jreg.get_task("humanoid_ppo_deploy").make_env_cfg().terrain)

    def ov(cfg):
        cfg.terrain.deploy_mjcf = XBOT_MJCF

    with pytest.raises(ValueError, match="hfield"):
        registry.make_env("humanoid_ppo_deploy", num_envs=2, cfg_overrides=ov, device="cpu")


def test_train_script_runs_the_joint_task(tmp_path, monkeypatch):
    """`train_torch.py --task humanoid_joint_ppo --num_envs 4 --device cpu`
    (T cut to 2 through the task's train config): the joint env from the
    registry's custom factory, 2 XBot-L + 2 XBot-S envs, one iteration with
    a finite estimator loss, and the final checkpoint holds the estimator
    head and one env state per sub-env."""
    spec = registry.get_task("humanoid_joint_ppo")

    def short():
        tc = spec.make_train_cfg()
        tc.runner.num_steps_per_env = 2
        return tc

    monkeypatch.setitem(registry._REGISTRY, "humanoid_joint_ppo", spec._replace(make_train_cfg=short))
    monkeypatch.setenv("HGT_WANDB", "0")
    monkeypatch.delenv("HGT_SOLVER", raising=False)
    args = get_args(["--task", "humanoid_joint_ppo", "--num_envs", "4", "--max_iterations", "1",
                     "--device", "cpu", "--run_name", "joint", "--log_root", str(tmp_path)])
    _train_fn()(args)
    run = glob.glob(str(tmp_path / "*_joint"))[0]
    line = json.loads(open(os.path.join(run, "metrics.jsonl")).readline())
    assert line["Loss/estimator"] > 0.0 and line["Loss/estimator"] == line["Loss/estimator"]
    payload = torch.load(os.path.join(run, "model_1.ckpt"), weights_only=True)
    assert [s["phys"]["qpos"].shape for s in payload["env_state"]] == [(2, 19), (2, 19)]
    assert "estimator.layers.2.weight" in payload["train_state"]["net"]
