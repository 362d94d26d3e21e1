"""The port's deployment tools against the JAX package's: the MuJoCo
sim2sim loop, the gait video, the MJCF export, the gait designer, the
native eval farm's front end and the live viewer (all NumPy / MuJoCo /
OpenCV code, so equal inputs must give equal outputs), plus the eval
scripts on a port run directory.

The policy is the shipped `resources/policies/xbotl_walk_demo` actor; a port
run directory is made by loading it into a runner's net
(`actor_critic_from_npz`) and saving a checkpoint. On the deployment
heightfield the flat-ground walk demo falls within 2 s in the JAX
package's script too (0 of its first 2 protocol-v4 rollouts), so the
heightfield evaluation runs the repo's footing policy
(`xbotl_footing_demo`, trained on that field), which survives them."""

import importlib.util
import json
import os
import socket
import threading
import time
import urllib.request

import mujoco
import numpy as np
import pytest
import torch

from humanoid_gym_tpu.export import native_eval as JN
from humanoid_gym_tpu.export import sim2sim as JS
from humanoid_gym_tpu.export.policy_export import load_policy as jax_load_policy
from humanoid_gym_tpu.export.video import GaitVideoRenderer as JaxRenderer
from humanoid_gym_tpu.physics.mjcf_export import model_to_mjcf as jax_mjcf
from humanoid_gym_tpu.utils import calculate_gait as JG
from humanoid_gym_tpu_torch import HGT_ROOT_DIR, XBOT_MJCF, XBOT_TERRAIN_MJCF, registry
from humanoid_gym_tpu_torch.algo.convert import actor_critic_from_npz
from humanoid_gym_tpu_torch.export import export_checkpoint, export_policy, load_policy
from humanoid_gym_tpu_torch.export import native_eval as TN
from humanoid_gym_tpu_torch.export import sim2sim as TS
from humanoid_gym_tpu_torch.export.live_viewer import LiveViewer
from humanoid_gym_tpu_torch.export.video import GaitVideoRenderer
from humanoid_gym_tpu_torch.physics.mjcf_export import model_to_mjcf
from humanoid_gym_tpu_torch.runner import OnPolicyRunner
from humanoid_gym_tpu_torch.utils import calculate_gait as TG

torch.set_num_threads(1)

POLICIES = os.path.join(HGT_ROOT_DIR, "resources", "policies")
DEMO_NPZ = os.path.join(POLICIES, "xbotl_walk_demo.npz")
DEMO_BIN = os.path.join(POLICIES, "xbotl_walk_demo.bin")
FOOTING_NPZ = os.path.join(POLICIES, "xbotl_footing_demo.npz")


def _load_script(name):
    path = os.path.join(HGT_ROOT_DIR, "scripts", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"{name}_under_test", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _make_run_dir(tmp_path_factory, npz):
    """A port run directory holding model_1.ckpt, whose actor is `npz`'s;
    returns (its path, the runner's net)."""
    env, _ = registry.make_env("humanoid_ppo", num_envs=1, device="cpu",
                               cfg_overrides=lambda c: setattr(c.sim.solver, "solver_type", "apgd"))
    runner = OnPolicyRunner(env, registry.get_task("humanoid_ppo").make_train_cfg(), log_dir=None)
    actor_critic_from_npz(runner.net, npz)
    d = tmp_path_factory.mktemp("run")
    runner.save(str(d / "model_1.ckpt"))
    return str(d), runner.net


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    return _make_run_dir(tmp_path_factory, DEMO_NPZ)


@pytest.fixture(scope="module")
def footing_run_dir(tmp_path_factory):
    return _make_run_dir(tmp_path_factory, FOOTING_NPZ)


# ------------------------------------------------------------ sim2sim loop


def _cfgs(mod):
    return {
        "flat": mod.Sim2SimCfg(mujoco_model_path=XBOT_MJCF, sim_duration=2.0),
        "terrain": mod.Sim2SimCfg(mujoco_model_path=XBOT_TERRAIN_MJCF, sim_duration=2.0,
                                  spawn_xy=(1.7, -2.3)),
        "xbots": mod.xbots_sim2sim_cfg(sim_duration=2.0),
    }


@pytest.mark.parametrize("case", ["flat", "terrain", "xbots"])
def test_run_mujoco_matches_jax(case):
    """The port's run_mujoco and the JAX package's give equal result dicts
    (and equal recorded states) for the shipped walk demo over 2 s: flat
    XBot-L, the deployment heightfield at a spawn off the origin, XBot-S."""
    ours = TS.run_mujoco(load_policy(DEMO_NPZ), _cfgs(TS)[case], record_states=True)
    theirs = JS.run_mujoco(jax_load_policy(DEMO_NPZ), _cfgs(JS)[case], record_states=True)
    np.testing.assert_array_equal(ours.pop("states"), theirs.pop("states"))
    assert ours == theirs
    assert ours["fallen_at_s"] is None


def test_run_mujoco_takes_a_torch_actor(run_dir):
    """run_mujoco takes any obs -> action callable: the port's actor wrapped
    to NumPy walks as the exported artifact does (same summary to 1e-3)."""
    _, net = run_dir

    def actor(obs):
        with torch.no_grad():
            return net.act(torch.as_tensor(obs, dtype=torch.float32)[None])[0][0].numpy()

    cfg = TS.Sim2SimCfg(mujoco_model_path=XBOT_MJCF, sim_duration=1.0)
    a, b = TS.run_mujoco(actor, cfg), TS.run_mujoco(load_policy(DEMO_NPZ), cfg)
    assert a["fallen_at_s"] is None and abs(a["distance_x"] - b["distance_x"]) < 1e-3


def test_gait_video_frames_match_jax(tmp_path):
    """GaitVideoRenderer.add_frame of both packages draws equal frames from
    one MjData (the flat model after 0.3 s of the walk demo), and `save`
    writes an mp4."""
    model = TS._load_mj_model(XBOT_MJCF)
    data = mujoco.MjData(model)
    ours, theirs = GaitVideoRenderer(model), JaxRenderer(model)
    mujoco.mj_step(model, data)
    for _ in range(3):
        for _ in range(100):
            data.qvel[0] = 0.5
            mujoco.mj_step(model, data)
        ours.add_frame(data, hud="t")
        theirs.add_frame(data, hud="t")
    assert len(ours.frames) == 3
    for a, b in zip(ours.frames, theirs.frames):
        assert a.shape == (540, 960, 3)
        np.testing.assert_array_equal(a, b)
    assert os.path.getsize(ours.save(str(tmp_path / "gait.mp4"))) > 1000


# ------------------------------------------------------------- MJCF, gait


def _xbots_models():
    from humanoid_gym_tpu.config.xbots import XBotSCfg as JCfg
    from humanoid_gym_tpu.physics.model import build_model_from_urdf as jbuild
    from humanoid_gym_tpu_torch.config.xbots import XBotSCfg as TCfg
    from humanoid_gym_tpu_torch.physics.model import build_model_from_urdf as tbuild

    def build(cfg, fn):
        return fn(cfg.asset.file, dof_order=list(cfg.init_state.default_joint_angles.keys()),
                  foot_name=cfg.asset.foot_name, knee_name=cfg.asset.knee_name,
                  termination_names=tuple(cfg.asset.terminate_after_contacts_on),
                  penalized_names=tuple(cfg.asset.penalize_contacts_on),
                  armature=cfg.asset.armature, mesh_dir=cfg.asset.mesh_dir)

    return build(JCfg(), jbuild), build(TCfg(), tbuild)


@pytest.mark.parametrize("case", ["l_oracle", "l_contacts", "l_slope", "s_deploy", "s_hfield"])
def test_model_to_mjcf_matches_jax(case):
    """model_to_mjcf of the port's RobotModel (torch tensors) writes the
    JAX package's string for the same URDF and arguments: the contact-free
    oracle model, contacts with friction and joint damping, a tilted plane,
    and the XBot-S deployment models of scripts/gen_xbots_mjcf.py."""
    if case.startswith("l"):
        from humanoid_gym_tpu.physics.model import build_xbot_model as jbuild
        from humanoid_gym_tpu_torch.physics.model import build_xbot_model as tbuild

        jm, tm = jbuild(), tbuild()
    else:
        jm, tm = _xbots_models()
    kd = np.full(12, 10.0)
    kw = {
        "l_oracle": {},
        "l_contacts": dict(with_contacts=True, friction=0.7, joint_damping=kd),
        "l_slope": dict(with_contacts=True, friction=0.7, joint_damping=kd,
                        plane_zaxis=[-0.104, 0.0, 0.9946]),
        "s_deploy": dict(armature=0.01, with_contacts=True, friction=0.9, joint_damping=kd,
                         deployable=True, base_z=0.71),
        "s_hfield": dict(with_contacts=True, friction=0.9, deployable=True, base_z=0.71,
                         hfield_png="../../XBot-L/terrain/uneven.png",
                         hfield_size=(36.4, 36.4, 0.25, 0.07)),
    }[case]
    ours = model_to_mjcf(tm, **kw)
    assert ours == jax_mjcf(jm, **kw)
    if case != "s_hfield":  # the hfield's PNG path is relative to the asset directory
        mujoco.MjModel.from_xml_string(ours)


def test_calculate_gait_matches_jax():
    c = TG.get_coefficients()
    np.testing.assert_array_equal(c, JG.get_coefficients())
    t = np.linspace(0.0, TG.T_SWING, 11)
    np.testing.assert_array_equal(TG.evaluate(c, t), JG.evaluate(c, t))
    assert abs(TG.evaluate(c, np.asarray(TG.T_SWING / 2)) - TG.H_SWING) < 1e-12


# -------------------------------------------------------- native eval farm


def test_native_farm_walks_the_demo(monkeypatch):
    """The port's front end builds native/sim2sim_eval.cpp into build/native/
    (nothing under native/ changes), the shipped walk demo survives 4 of 4
    rollouts of 3 s and walks over 0.5 m on average, and the JAX front end
    gives the same summary on the same file (pointed at the same binary, so
    that it builds nothing of its own)."""
    native = os.path.join(HGT_ROOT_DIR, "native")
    before = sorted(os.listdir(native))
    binary = TN.ensure_built()
    assert binary == os.path.join(HGT_ROOT_DIR, "build", "native", "hgt_sim2sim_eval")
    assert os.access(binary, os.X_OK)
    out = TN.run_eval_farm(XBOT_MJCF, DEMO_BIN, rollouts=4, duration=3.0)
    assert sorted(os.listdir(native)) == before
    s = out["summary"]
    assert s["survived"] == 4 and s["mean_distance_x"] > 0.5, out
    assert len(out["rollouts"]) == 4
    monkeypatch.setattr(JN, "BINARY", binary)
    theirs = JN.run_eval_farm(XBOT_MJCF, DEMO_BIN, rollouts=4, duration=3.0)
    assert out == theirs


def test_native_build_uses_the_makefile_flags():
    """The front end compiles with native/Makefile's CXXFLAGS."""
    text = open(os.path.join(HGT_ROOT_DIR, "native", "Makefile")).read()
    line = next(ln for ln in text.splitlines() if ln.startswith("CXXFLAGS"))
    assert tuple(line.split("?=")[1].split()) == TN.CXXFLAGS


# ------------------------------------------------------------ live viewer
# (the three cases of tests/test_live_viewer.py, on the port's LiveViewer)


def _make_viewer(fps=25):
    policy = lambda obs: np.zeros(12)  # noqa: E731 — PD holds default pose
    return LiveViewer(policy, TS.Sim2SimCfg(mujoco_model_path=XBOT_MJCF, sim_duration=1.0),
                      fps=fps)


def test_viewer_step_render_and_keys():
    v = _make_viewer()
    v.step_policy_window()
    assert v.sim_time == pytest.approx(1 / 25, abs=2e-3)
    jpg = v.render_jpeg()
    assert jpg[:3] == b"\xff\xd8\xff" and len(jpg) > 5000
    for k in ("ArrowUp", "ArrowUp", "ArrowRight", "q"):
        v.apply_key(k)
    assert np.allclose(v.cmd, [0.2, -0.1, 0.2])
    v.apply_key(" ")
    assert np.allclose(v.cmd, 0.0)
    v.apply_key("v")
    assert v.paused
    v.apply_key("v")
    assert not v.paused
    v.apply_key("Escape")
    assert not v.running


def test_viewer_reset_and_push():
    v = _make_viewer()
    for _ in range(10):
        v.step_policy_window()
    qpos_moved = np.array(v.data.qpos)
    v.apply_key("p")
    v.step_policy_window()
    v.apply_key("r")
    v.step_policy_window()
    assert np.linalg.norm(v.data.qpos - v._init_qpos) < np.linalg.norm(
        qpos_moved - v._init_qpos) + 1e-9
    assert v.sim_time == pytest.approx(1 / 25, abs=2e-3)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_viewer_http_stream_serves_mjpeg():
    v = _make_viewer()
    port = _free_port()
    t = threading.Thread(target=v.serve, kwargs={"port": port}, daemon=True)
    t.start()
    try:
        for _ in range(100):
            if v._frame_jpeg is not None:
                break
            time.sleep(0.05)
        page = urllib.request.urlopen(f"http://127.0.0.1:{port}/", timeout=5).read()
        assert b"viewer" in page
        chunk = urllib.request.urlopen(f"http://127.0.0.1:{port}/stream", timeout=5).read(40000)
        assert b"--frame" in chunk and b"\xff\xd8\xff" in chunk
        urllib.request.urlopen(f"http://127.0.0.1:{port}/key?k=Escape", timeout=5)
    finally:
        v.stop()
        t.join(timeout=5)
    assert not v.running


# ------------------------------------------------- checkpoints and scripts


def test_export_checkpoint_equals_export_policy(run_dir, tmp_path):
    """The artifacts written from a port checkpoint equal those written from
    the net it saved: policy.bin byte for byte, the npz arrays equal."""
    d, net = run_dir
    a = export_checkpoint(os.path.join(d, "model_1.ckpt"), str(tmp_path / "a"))
    b = export_policy(net, str(tmp_path / "b"), torchscript=False)
    assert [os.path.basename(p) for p in a] == [os.path.basename(p) for p in b]
    assert open(a[1], "rb").read() == open(b[1], "rb").read()
    za, zb = np.load(a[0]), np.load(b[0])
    assert za.files == zb.files
    for k in za.files:
        np.testing.assert_array_equal(za[k], zb[k])
    demo = np.load(DEMO_NPZ)
    np.testing.assert_array_equal(za["W0"], demo["W0"])


def test_eval_hfield_script_on_a_port_run(footing_run_dir):
    """scripts/eval_hfield_torch.py on a port run directory: one line in
    hfield_curve.jsonl with the keys of scripts/eval_hfield.py, protocol
    v4; the footing demo survives 2 of 2 rollouts of 2 s, and the record
    equals the JAX script's on the same actor's npz."""
    d, _ = footing_run_dir
    _load_script("eval_hfield_torch").main(
        ["--run_dir", d, "--rollouts", "2", "--duration", "2", "--procs", "1"])
    lines = [json.loads(ln) for ln in open(os.path.join(d, "hfield_curve.jsonl"))]
    assert len(lines) == 1
    rec = lines[0]
    assert set(rec) == {"ckpt", "survived", "scored", "rollouts", "mean_distance_x", "per_cmd",
                        "duration_s", "protocol", "robot"}
    assert rec["ckpt"] == 1 and rec["rollouts"] == 2 and rec["survived"] == 2
    assert rec["protocol"] == "spawn_v4_gated" and set(rec["per_cmd"]) == {"0.4", "0.2"}
    jax_script = _load_script("eval_hfield")
    assert {k: v for k, v in rec.items() if k != "ckpt"} == jax_script.eval_policy_path(
        FOOTING_NPZ, 2, 2.0, procs=1)


def test_robustness_curve_script_on_a_port_run(run_dir):
    """scripts/robustness_curve_torch.py on a port run directory: one line
    in robustness_curve.jsonl with the keys of scripts/robustness_curve.py,
    and the walk demo survives 2 of 2 native-farm rollouts of 2 s."""
    d, _ = run_dir
    _load_script("robustness_curve_torch").main(
        ["--run_dir", d, "--rollouts", "2", "--duration", "2"])
    lines = [json.loads(ln) for ln in open(os.path.join(d, "robustness_curve.jsonl"))]
    assert len(lines) == 1
    assert set(lines[0]) == {"ckpt", "survived", "rollouts", "mean_distance_x", "duration_s"}
    assert lines[0]["ckpt"] == 1 and lines[0]["survived"] == 2


def test_sim2sim_and_view_scripts_load_the_policy(run_dir):
    """scripts/sim2sim_torch.py walks the exported demo; scripts/view_torch.py
    reads a port run directory's newest checkpoint into the demo's actor."""
    d, _ = run_dir
    res = _load_script("sim2sim_torch").main(["--load_model", DEMO_NPZ, "--duration", "1"])
    assert res["fallen_at_s"] is None and res["distance_x"] > 0.1
    view = _load_script("view_torch")
    assert view.latest_checkpoint(d) == (1, os.path.join(d, "model_1.ckpt"))
    obs = np.random.default_rng(0).normal(size=705).astype(np.float32)
    np.testing.assert_allclose(view.load_viewer_policy(None, d)(obs),
                               load_policy(DEMO_NPZ)(obs), atol=1e-6)


def test_gen_xbots_mjcf_reproduces_the_committed_assets(tmp_path):
    """scripts/gen_xbots_mjcf_torch.py writes the committed XBot-S models
    (resources/robots/XBot-S/mjcf) byte for byte."""
    written = _load_script("gen_xbots_mjcf_torch").main(["--out_dir", str(tmp_path)])
    assert [os.path.basename(p) for p in written] == ["XBot-S.xml", "XBot-S-terrain.xml"]
    for p in written:
        committed = os.path.join(HGT_ROOT_DIR, "resources", "robots", "XBot-S", "mjcf",
                                 os.path.basename(p))
        assert open(p, "rb").read() == open(committed, "rb").read(), p


def test_plot_curves_renders_a_port_run(tmp_path):
    """scripts/plot_curves_torch.py renders metrics.jsonl lines with the
    runner's scalar names (and a robustness curve) to a PNG."""
    pytest.importorskip("matplotlib")
    keys = ("Train/mean_reward", "Train/mean_episode_length", "Loss/value_function",
            "Loss/surrogate", "Loss/learning_rate", "Policy/mean_noise_std", "Perf/total_fps",
            "Episode/rew_tracking_lin_vel")
    with open(tmp_path / "metrics.jsonl", "w") as f:
        for it in range(5):
            f.write(json.dumps({"iter": it, **{k: 0.1 * (it + 1) for k in keys}}) + "\n")
    with open(tmp_path / "robustness_curve.jsonl", "w") as f:
        f.write(json.dumps({"ckpt": 1, "survived": 2, "rollouts": 2, "mean_distance_x": 1.0,
                            "duration_s": 2.0}) + "\n")
    out = _load_script("plot_curves_torch").main(["--run_dir", str(tmp_path)])
    assert out == str(tmp_path / "curves.png") and os.path.getsize(out) > 10000
