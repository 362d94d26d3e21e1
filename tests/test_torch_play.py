"""scripts/play_torch.py, the port's play entry point: its rollout against
the JAX env over 20 noise-free steps from one converted state, the script
end to end on the CPU (export, the 13 traces of scripts/play.py, the
dashboard), and its explicit refusals.

The policy is the shipped `resources/policies/xbotl_walk_demo` actor; the
script's run directory holds one checkpoint whose actor is the demo's
(`actor_critic_from_npz` + `runner.save`)."""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from humanoid_gym_tpu.config.xbotl import XBotLCfg as JaxCfg
from humanoid_gym_tpu.envs import make_env as jax_make_env
from humanoid_gym_tpu_torch import HGT_ROOT_DIR, registry
from humanoid_gym_tpu_torch.algo.convert import actor_critic_from_npz, env_state_from_jax
from humanoid_gym_tpu_torch.config.xbotl import XBotLCfg as TorchCfg
from humanoid_gym_tpu_torch.envs import make_env as torch_make_env
from humanoid_gym_tpu_torch.export import load_policy
from humanoid_gym_tpu_torch.runner import OnPolicyRunner
from humanoid_gym_tpu_torch.utils.helpers import get_args

torch.set_num_threads(1)

DEMO_NPZ = os.path.join(HGT_ROOT_DIR, "resources", "policies", "xbotl_walk_demo.npz")


@pytest.fixture(scope="module")
def play_mod():
    path = os.path.join(HGT_ROOT_DIR, "scripts", "play_torch.py")
    spec = importlib.util.spec_from_file_location("play_torch_under_test", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def _no_wandb(monkeypatch):
    monkeypatch.setenv("HGT_WANDB", "0")


@pytest.fixture(scope="module")
def log_root(tmp_path_factory):
    """A log root with one run whose checkpoint carries the walk demo."""
    env, _ = registry.make_env("humanoid_ppo", num_envs=1, device="cpu",
                               cfg_overrides=lambda c: setattr(c.sim.solver, "solver_type", "apgd"))
    runner = OnPolicyRunner(env, registry.get_task("humanoid_ppo").make_train_cfg(), log_dir=None)
    actor_critic_from_npz(runner.net, DEMO_NPZ)
    root = tmp_path_factory.mktemp("logs")
    os.makedirs(root / "run0")
    runner.save(str(root / "run0" / "model_1.ckpt"))
    return str(root)


# trace key -> (JAX-side reading, tolerance). The two envs run solver apgd
# at its 8 iterations in the same DOF order; over 20 closed-loop steps the
# float32 differences of the two engines stay below 1e-5 in positions and
# base velocities, 1e-4 in joint velocities and 1e-3 N m in torques (CPU,
# this walk demo), well inside these bounds.
_JAX_READ = {
    "dof_pos_target": (lambda js, tr, a: float(a[0, 2]) * 0.25, 1e-4),
    "dof_pos": (lambda js, tr, a: float(js.phys.qpos[0, 9]), 1e-4),
    "dof_vel": (lambda js, tr, a: float(js.phys.qvel[0, 8]), 5e-4),
    "dof_torque": (lambda js, tr, a: float(js.phys.torques[0, 2]), 5e-3),
    "base_vel_x": (lambda js, tr, a: float(js.base_lin_vel[0, 0]), 1e-4),
    "base_vel_y": (lambda js, tr, a: float(js.base_lin_vel[0, 1]), 1e-4),
    "base_vel_z": (lambda js, tr, a: float(js.base_lin_vel[0, 2]), 1e-4),
    "base_vel_yaw": (lambda js, tr, a: float(js.base_ang_vel[0, 2]), 1e-4),
    "reward": (lambda js, tr, a: float(tr.reward[0]), 1e-5),
}


def test_play_rollout_matches_jax(play_mod):
    """From one state (the JAX env's reset, converted with
    env_state_from_jax) with the play overrides and observation noise off,
    20 steps of `play_rollout` in the port's env and of scripts/play.py's
    loop in the JAX env, both driven by the walk demo, give the same traces
    (tolerances above), the same commands and no fall."""
    def overrides(cfg):
        play_mod.play_overrides(cfg)
        cfg.noise.add_noise = False
        cfg.sim.solver.solver_type = "apgd"
        return cfg

    n = 20
    jenv = jax_make_env(overrides(JaxCfg()))
    tenv = torch_make_env(overrides(TorchCfg()), device="cpu", seed=0)
    js, jobs, _ = jenv.reset_all(jax.random.PRNGKey(0))
    pol = load_policy(DEMO_NPZ)
    _, _, ours, falls = play_mod.play_rollout(
        tenv, lambda o: torch.from_numpy(pol(o.numpy())), env_state_from_jax(js),
        torch.from_numpy(np.array(jobs)), n)
    assert falls == 0
    step = jax.jit(jenv.step)
    cmd = jnp.asarray([[play_mod.PLAY_VX, 0.0, 0.0, 0.0]])
    theirs = {k: [] for k in _JAX_READ}
    for _ in range(n):
        js = js.replace(commands=cmd)
        a = jnp.asarray(pol(np.asarray(jobs)))
        js, tr = step(js, a)
        jobs = tr.obs
        for k, (read, _) in _JAX_READ.items():
            theirs[k].append(read(js, tr, a))
    for k, (_, tol) in _JAX_READ.items():
        np.testing.assert_allclose(ours[k], theirs[k], atol=tol, err_msg=k)
    np.testing.assert_array_equal(ours["command_x"], np.full(n, 0.5))
    assert np.abs(ours["contact_forces_z"]).max() > 100.0


def test_play_script_on_the_cpu(play_mod, log_root, monkeypatch):
    """200 steps of play on the CPU with the script's own overrides
    (observation noise on): the exported policy.npz holds the demo's
    arrays, play_trace.npz has the 13 keys of scripts/play.py with their
    shapes, the trace is finite, the robot walks forward and never falls;
    the dashboard PNG is written when matplotlib is installed."""
    from importlib.util import find_spec

    monkeypatch.setenv("HGT_PLAY_VIDEO", "0")
    res = play_mod.play(get_args(["--task", "humanoid_ppo", "--log_root", log_root,
                                  "--device", "cpu"]), n_steps=200)
    assert res["checkpoint"] == os.path.join(log_root, "run0", "model_1.ckpt")
    exported = np.load(os.path.join(log_root, "exported", "policies", "policy.npz"))
    demo = np.load(DEMO_NPZ)
    for k in demo.files:
        np.testing.assert_array_equal(exported[k], demo[k])
    trace = np.load(res["trace"])
    assert tuple(trace.files) == play_mod.TRACE_KEYS
    for k in play_mod.TRACE_KEYS:
        want = (200, 2) if k == "contact_forces_z" else (200,)
        assert trace[k].shape == want, k
        assert np.isfinite(trace[k]).all(), k
    assert res["falls"] == 0
    assert trace["base_vel_x"][100:].mean() > 0.25
    assert (res["dashboard"] is not None) == (find_spec("matplotlib") is not None)
    if res["dashboard"] is not None:
        assert os.path.getsize(res["dashboard"]) > 10000
    assert res["video"] is None


def test_declined_outputs_are_named(play_mod, log_root, monkeypatch, capsys):
    """Without matplotlib / mujoco / cv2 (hidden here) play writes the
    export and the trace and names each output it did not write, with the
    reason, on a line of its own; HGT_PLAY_VIDEO=0 declines the video."""
    import importlib.util as iu

    real = iu.find_spec
    monkeypatch.setattr(iu, "find_spec",
                        lambda name, *a: None if name in ("matplotlib", "mujoco", "cv2")
                        else real(name, *a))
    monkeypatch.delenv("HGT_PLAY_VIDEO", raising=False)
    assert play_mod.declined_outputs() == {
        "dashboard": "matplotlib is not installed",
        "gait video": "mujoco and cv2 not installed (it runs MuJoCo on the host)"}
    monkeypatch.setenv("HGT_PLAY_VIDEO", "0")
    res = play_mod.play(get_args(["--task", "humanoid_ppo", "--log_root", log_root,
                                  "--device", "cpu"]), n_steps=2)
    out = capsys.readouterr().out.splitlines()
    assert "dashboard not written: matplotlib is not installed" in out
    assert "gait video not written: HGT_PLAY_VIDEO=0" in out
    assert res["dashboard"] is None and res["video"] is None
    assert os.path.exists(res["trace"])


def test_play_without_a_card_raises(play_mod, log_root):
    """On `cuda` (the default) with no card, play raises before it loads
    anything."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        play_mod.play(get_args(["--task", "humanoid_ppo", "--log_root", log_root]))
