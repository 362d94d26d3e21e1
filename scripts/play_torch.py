"""Evaluate and export a trained policy with the PyTorch port (the
counterpart of scripts/play.py, reference humanoid/scripts/play.py).

Usage:
    python scripts/play_torch.py --task humanoid_ppo --log_root logs/XBot_ppo \
        [--load_run RUN] [--checkpoint N] [--device cpu]

Loads a port checkpoint (`model_N.ckpt`: the last run and its newest
checkpoint unless --load_run / --checkpoint name others), exports its actor
to `<log_root>/exported/policies/` (policy.npz, policy.bin, policy_jit.pt),
then runs the reference's rollout: 1200 policy steps (12 s) at one env on
flat ground with the command fixed at vx = 0.5, observation noise on and
no pushes, friction or mass randomization, action delay or action noise
(play.py:35-46). It writes `<log_root>/exported/play_trace.npz` with the
13 traces of play.py:69-95, then the dashboard `play_dashboard.png` (needs
matplotlib), then the gait video `gait.mp4` of the exported policy in
MuJoCo (needs mujoco and cv2; HGT_PLAY_VIDEO=0 turns it off). Each of the
last two that is not written is named on one line with the reason; once
one is started, a failure in it raises.

Runs on the CUDA card unless `--device cpu` is given, and fails if there is
no card. The contact solver is `mega` on the card and `apgd` on the CPU;
HGT_SOLVER overrides it. The trace stays on the device during the rollout
and is copied to the host once, after it.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

PLAY_STEPS = 1200
PLAY_VX = 0.5
TRACE_KEYS = (
    "dof_pos_target", "dof_pos", "dof_vel", "dof_torque",
    "base_vel_x", "base_vel_y", "base_vel_z", "base_vel_yaw",
    "command_x", "command_y", "command_yaw", "contact_forces_z", "reward",
)
# the joint whose target, position, velocity and torque are traced
# (play.py:69-72: action column 2, qpos 7 + 2, qvel 6 + 2)
TRACE_JOINT = 2


def play_overrides(cfg):
    """Eval-time config (reference play.py:51-63, scripts/play.py:35-46)."""
    cfg.env.num_envs = 1
    cfg.terrain.mesh_type = "plane"
    cfg.terrain.curriculum = False
    cfg.noise.add_noise = True
    cfg.domain_rand.push_robots = False
    cfg.domain_rand.randomize_friction = False
    cfg.domain_rand.randomize_base_mass = False
    cfg.domain_rand.action_delay = 0.0
    cfg.domain_rand.action_noise = 0.0
    cfg.commands.heading_command = False


def play_rollout(env, policy, state, obs, n_steps: int, vx: float = PLAY_VX):
    """Step env 0 of `env` n_steps policy steps under `policy` (obs ->
    action) with the command held at (vx, 0, 0). Returns (state, obs,
    traces, falls): the traces of play.py:69-95 as NumPy arrays, gathered
    on the device one row per step and copied to the host once, and how
    often env 0 ended an episode other than by its time limit."""
    import torch

    j = TRACE_JOINT
    cmd = torch.tensor([vx, 0.0, 0.0, 0.0], device=env.device).expand(env.num_envs, 4).contiguous()
    feet = torch.as_tensor(env.model.feet_body_idx, device=env.device)
    rows = []
    falls = torch.zeros((), dtype=torch.int32, device=env.device)
    with torch.no_grad():
        for _ in range(n_steps):
            state = state.replace(commands=cmd)
            action = policy(obs)
            state, tr = env.step(state, action)
            obs = tr.obs
            falls += tr.done[0] & ~tr.time_out[0]
            ph = state.phys
            rows.append(torch.cat([
                action[0, j:j + 1], ph.qpos[0, 7 + j:8 + j], ph.qvel[0, 6 + j:7 + j],
                ph.torques[0, j:j + 1], state.base_lin_vel[0], state.base_ang_vel[0, 2:3],
                ph.contact_forces[0, :, 2].index_select(0, feet), tr.reward[0:1],
            ]).float())
        host = torch.cat([torch.stack(rows).flatten(), falls[None].float()]).cpu().numpy()
    falls = int(host[-1])
    host = host[:-1].reshape(n_steps, -1)
    nf = len(feet)
    traces = {
        "dof_pos_target": host[:, 0] * np.float32(0.25),
        "dof_pos": host[:, 1],
        "dof_vel": host[:, 2],
        "dof_torque": host[:, 3],
        "base_vel_x": host[:, 4],
        "base_vel_y": host[:, 5],
        "base_vel_z": host[:, 6],
        "base_vel_yaw": host[:, 7],
        "command_x": np.full(n_steps, vx),
        "command_y": np.zeros(n_steps),
        "command_yaw": np.zeros(n_steps),
        "contact_forces_z": host[:, 8:8 + nf],
        "reward": host[:, 8 + nf].astype(np.float64),
    }
    assert tuple(traces) == TRACE_KEYS
    return state, obs, traces, falls


def declined_outputs():
    """{output: why it is not written} for the dashboard and the gait
    video, decided before the rollout from the installed packages and
    HGT_PLAY_VIDEO."""
    from importlib.util import find_spec

    out = {}
    if find_spec("matplotlib") is None:
        out["dashboard"] = "matplotlib is not installed"
    if os.environ.get("HGT_PLAY_VIDEO", "1") == "0":
        out["gait video"] = "HGT_PLAY_VIDEO=0"
    else:
        missing = [m for m in ("mujoco", "cv2") if find_spec(m) is None]
        if missing:
            out["gait video"] = f"{' and '.join(missing)} not installed (it runs MuJoCo on the host)"
    return out


def play(args, n_steps: int = PLAY_STEPS):
    """Play `n_steps` policy steps (the reference's 1200 by default).
    Returns a dict: the checkpoint, the exported files, the trace file,
    the traces, the falls, the rollout's wall seconds, and the dashboard
    and video paths (None where not written)."""
    import torch

    from humanoid_gym_tpu_torch import XBOT_MJCF, registry
    from humanoid_gym_tpu_torch.export import export_policy, load_policy
    from humanoid_gym_tpu_torch.runner import OnPolicyRunner
    from humanoid_gym_tpu_torch.utils.helpers import get_load_path
    from humanoid_gym_tpu_torch.utils.platform import resolve_device

    device = resolve_device(args.device)
    spec = registry.get_task(args.task)
    train_cfg = spec.make_train_cfg()
    solver = os.environ.get("HGT_SOLVER", "apgd" if device.type == "cpu" else "mega")

    def overrides(cfg):
        play_overrides(cfg)
        cfg.sim.solver.solver_type = solver

    root = args.log_root or os.path.join(os.getcwd(), "logs", train_cfg.runner.experiment_name)
    path = get_load_path(root, load_run=args.load_run or -1, checkpoint=args.checkpoint)
    declined = declined_outputs()
    env, _ = registry.make_env(args.task, num_envs=1, cfg_overrides=overrides, device=device,
                               seed=0 if args.seed is None else args.seed)
    runner = OnPolicyRunner(env, train_cfg, log_dir=None)
    print(f"Loading model from: {path}")
    runner.load(path)
    policy = runner.get_inference_policy()

    # export (reference play.py:76-84)
    written = export_policy(runner.net, os.path.join(root, "exported", "policies"))
    print("Exported policy to:", written)

    # fixed-command rollout (reference play.py:115-151, FIX_COMMAND vx=0.5)
    state, obs, _ = env.reset_all()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    state, obs, traces, falls = play_rollout(env, policy, state, obs, n_steps)
    rollout_s = time.perf_counter() - t0
    out = os.path.join(root, "exported", "play_trace.npz")
    np.savez(out, **traces)
    print(f"Saved trace to {out}; mean reward {np.mean(traces['reward']):.3f}, "
          f"mean vx {np.mean(traces['base_vel_x']):.3f}, falls {falls} ({n_steps} steps in "
          f"{rollout_s:.1f} s on {device.type})")
    result = {"checkpoint": path, "exported": written, "trace": out, "traces": traces,
              "falls": falls, "rollout_s": rollout_s, "dashboard": None, "video": None}

    if "dashboard" in declined:
        print(f"dashboard not written: {declined['dashboard']}")
    else:
        from humanoid_gym_tpu_torch.utils.play_logger import plot_states

        result["dashboard"] = plot_states(
            traces, dt=env.dt, out_path=os.path.join(root, "exported", "play_dashboard.png"))
        print(f"Dashboard: {result['dashboard']}")

    # gait video of the exported policy (reference play.py:127-134 records
    # an mp4 via a camera sensor; here a headless software render of the
    # MuJoCo deployment rollout)
    if "gait video" in declined:
        print(f"gait video not written: {declined['gait video']}")
    else:
        from humanoid_gym_tpu_torch.export.sim2sim import Sim2SimCfg, run_mujoco

        mp4 = os.path.join(root, "exported", "gait.mp4")
        npz = next(p for p in written if p.endswith(".npz"))
        res = run_mujoco(load_policy(npz),
                         Sim2SimCfg(mujoco_model_path=XBOT_MJCF, sim_duration=10.0),
                         video_path=mp4)
        result["video"] = res["video"]
        print(f"Gait video: {mp4} (walked {res['distance_x']:.2f} m)")
    return result


if __name__ == "__main__":
    from humanoid_gym_tpu_torch.utils.helpers import get_args

    play(get_args())
