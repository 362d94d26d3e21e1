"""MuJoCo cross-simulator validation (the zero-shot transfer check).

Replays an exported policy in MuJoCo 2.3.x at 1 kHz with the deployment
observation contract of the reference (scripts/sim2sim.py:70-160):
sensor-only obs (no privileged info), 47-dim single frame, 15-deep history,
100 Hz policy / 1 kHz PD at kp/kd from the task config, flat +-200 Nm torque
clip (reference sim2sim.py:190), command vx fixed.

This is the e2e integration test of the whole framework: a policy trained in
the port's engine must walk in MuJoCo (BASELINE.md validation row).

The PyTorch port's copy of humanoid_gym_tpu/export/sim2sim.py (NumPy and
MuJoCo only; MuJoCo runs on the host's CPU). `run_mujoco` takes any
callable from a (705,) observation to a (12,) action: the port's
`load_policy` artifact, or a torch actor wrapped to NumPy.
"""

from __future__ import annotations

import os
from collections import deque
from dataclasses import dataclass, field
from typing import Optional

import numpy as np


@dataclass
class Sim2SimCfg:
    mujoco_model_path: str = ""
    sim_dt: float = 0.001
    decimation: int = 10
    sim_duration: float = 60.0
    # command (reference sim2sim.py:42-45)
    cmd_vx: float = 0.4
    cmd_vy: float = 0.0
    cmd_dyaw: float = 0.0
    # obs contract (XBotLCfg normalization/scales)
    frame_stack: int = 15
    num_single_obs: int = 47
    num_actions: int = 12
    obs_clip: float = 18.0
    action_clip: float = 18.0
    action_scale: float = 0.25
    cycle_time: float = 0.64
    obs_scale_lin_vel: float = 2.0
    obs_scale_ang_vel: float = 1.0
    obs_scale_dof_pos: float = 1.0
    obs_scale_dof_vel: float = 0.05
    obs_scale_quat: float = 1.0
    # PD (reference sim2sim.py:188-190)
    kps: np.ndarray = field(
        default_factory=lambda: np.array(
            [200, 200, 350, 350, 15, 15, 200, 200, 350, 350, 15, 15], np.float64
        )
    )
    kds: np.ndarray = field(
        default_factory=lambda: np.array(
            [10, 10, 10, 10, 10, 10, 10, 10, 10, 10, 10, 10], np.float64
        )
    )
    # flat 200 Nm deployment clamp (reference sim2sim.py:190) — NOTE this is
    # intentionally looser than training's 0.85x per-joint effort limits;
    # the transfer-validation contract uses the reference's value verbatim.
    tau_limit: np.ndarray = field(
        default_factory=lambda: 200.0 * np.ones(12, np.float64)
    )
    # spawn variation (EXTENSION; the reference always starts at the origin):
    # shift the base xy and re-seat z on the local terrain height so repeated
    # rollouts sample different footing (run_mujoco is otherwise fully
    # deterministic — the MJCF 3.x shim strips sensornoise).
    spawn_xy: tuple = (0.0, 0.0)
    # fall detection: base height above local terrain below this = fallen
    # (0.3 m for the 1.65 m XBot-L; scale for other morphologies)
    fall_below: float = 0.3


def xbots_sim2sim_cfg(**overrides) -> "Sim2SimCfg":
    """Deployment config for the Froude-scaled XBot-S morphology
    (config/xbots.py: s = 1.2/1.65, time/velocity x sqrt(s), kp x s^4).

    The controller kd is integrated IMPLICITLY as MJCF joint damping
    (scripts/gen_xbots_mjcf.py bakes kd + URDF damping into the model;
    explicit -kd*dq torques at dt = 1 ms are unstable on the scaled,
    nearly massless ankle bodies — same PD law, stable integration), so
    kds here is zero."""
    import math

    from .. import XBOT_S_MJCF
    from ..config.xbots import SCALE

    s = SCALE
    sq = math.sqrt(s)
    cfg = Sim2SimCfg(
        mujoco_model_path=XBOT_S_MJCF,
        cmd_vx=0.4 * sq,
        cycle_time=0.64 * sq,
        kps=np.array(
            [200, 200, 350, 350, 15, 15] * 2, np.float64
        ) * s**4,
        kds=np.zeros(12),
        tau_limit=200.0 * s**4 * np.ones(12, np.float64),
        fall_below=0.3 * s,
    )
    for k, v in overrides.items():
        setattr(cfg, k, v)
    return cfg


def quaternion_to_euler_array(quat_xyzw: np.ndarray) -> np.ndarray:
    """xyzw quaternion -> roll/pitch/yaw (reference sim2sim.py:48-67)."""
    x, y, z, w = quat_xyzw
    t0 = 2.0 * (w * x + y * z)
    t1 = 1.0 - 2.0 * (x * x + y * y)
    roll = np.arctan2(t0, t1)
    t2 = np.clip(2.0 * (w * y - z * x), -1.0, 1.0)
    pitch = np.arcsin(t2)
    t3 = 2.0 * (w * z + x * y)
    t4 = 1.0 - 2.0 * (y * y + z * z)
    yaw = np.arctan2(t3, t4)
    return np.array([roll, pitch, yaw])


def get_obs(data):
    """Extract state from MuJoCo (reference sim2sim.py:70-80)."""
    q = data.qpos.astype(np.double)
    dq = data.qvel.astype(np.double)
    quat = data.sensor("orientation").data[[1, 2, 3, 0]].astype(np.double)  # xyzw
    omega = data.sensor("angular-velocity").data.astype(np.double)
    return q, dq, quat, omega


def _load_mj_model(path: str):
    """Load an MJCF, tolerating MuJoCo 2.3-era attributes removed in 3.x.

    The reference assets target mujoco==2.3.6 (setup.py install_requires);
    installed MuJoCo may be 3.x, which rejects the legacy
    ``sensornoise``/``iterations`` option syntax. Strip what 3.x dropped and
    load from string with the original directory as asset root.
    """
    import re

    import mujoco

    try:
        return mujoco.MjModel.from_xml_path(path)
    except ValueError:
        xml = open(path).read()
        xml = re.sub(r'\s*sensornoise="[^"]*"', "", xml)
        xml = re.sub(r"\s*iterations='[^']*'", "", xml)
        # resolve relative meshdir against the mjcf location
        d = os.path.dirname(os.path.abspath(path))
        m = re.search(r'meshdir="([^"]*)"', xml)
        if m:
            absdir = os.path.normpath(os.path.join(d, m.group(1)))
            xml = xml.replace(m.group(0), f'meshdir="{absdir}"')
        return mujoco.MjModel.from_xml_string(xml)


def _make_hfield_height_fn(model):
    """Resolve the model's walkable hfield ONCE (geom scan + full-grid
    copy are rollout-invariant) and return height_at(x, y) -> float: the
    triangulated height of the terrain at world (x, y); 0 on flat models
    or outside the field. Resolves the hfield through its geom (models can
    carry several hfields; the walkable one is the one a geom
    instantiates)."""
    import mujoco

    gid = None
    if model.nhfield > 0:
        for g in range(model.ngeom):
            if model.geom_type[g] == mujoco.mjtGeom.mjGEOM_HFIELD:
                gid = g
                break
    if gid is None:
        return lambda x, y: 0.0
    hid = int(model.geom_dataid[gid])
    px, py = float(model.geom_pos[gid][0]), float(model.geom_pos[gid][1])
    sx, sy, sz, _ = (float(v) for v in model.hfield_size[hid])
    nr = int(model.hfield_nrow[hid])
    nc = int(model.hfield_ncol[hid])
    adr = int(model.hfield_adr[hid])
    h = np.array(model.hfield_data[adr : adr + nr * nc]).reshape(nr, nc)

    def height_at(x: float, y: float) -> float:
        # grid coords: columns span x in [-sx, sx], rows span y in [-sy, sy]
        gx = (x - px + sx) / (2 * sx) * (nc - 1)
        gy = (y - py + sy) / (2 * sy) * (nr - 1)
        if not (0 <= gx <= nc - 1 and 0 <= gy <= nr - 1):
            return 0.0
        x0, y0 = int(gx), int(gy)
        x1, y1 = min(x0 + 1, nc - 1), min(y0 + 1, nr - 1)
        fx, fy = gx - x0, gy - y0
        # MuJoCo triangulates each cell along the (row, col)->(row+1, col+1)
        # diagonal (verified against mj_ray to 3e-4 on uneven.png; plain
        # bilinear deviates up to 0.14 m on these 1 m cells)
        h00, h10 = h[y0, x0], h[y0, x1]
        h01, h11 = h[y1, x0], h[y1, x1]
        if fx >= fy:
            v = h00 + (h10 - h00) * fx + (h11 - h10) * fy
        else:
            v = h00 + (h01 - h00) * fy + (h11 - h01) * fx
        return float(v) * sz

    return height_at


def _hfield_height_at(model, x: float, y: float) -> float:
    """One-shot convenience wrapper over _make_hfield_height_fn (re-resolves
    the field every call — use the factory inside loops)."""
    return _make_hfield_height_fn(model)(x, y)


def run_mujoco(
    policy,
    cfg: Sim2SimCfg,
    record_states: bool = False,
    video_path: Optional[str] = None,
):
    """60 s closed-loop rollout (reference sim2sim.py:87-164).

    Returns summary dict: distance walked, mean height, falls, mean |vx|.
    With `video_path`, also writes a software-rendered mp4 of the gait
    (capability analog of reference play.py:127-134 camera video).
    """
    import mujoco

    model = _load_mj_model(cfg.mujoco_model_path)
    model.opt.timestep = cfg.sim_dt
    data = mujoco.MjData(model)
    height_at = _make_hfield_height_fn(model)
    if cfg.spawn_xy != (0.0, 0.0):
        sx, sy = cfg.spawn_xy
        data.qpos[0] += sx
        data.qpos[1] += sy
        data.qpos[2] += height_at(sx, sy)
    mujoco.mj_step(model, data)

    renderer = None
    if video_path is not None:
        from .video import GaitVideoRenderer

        renderer = GaitVideoRenderer(model)

    target_q = np.zeros(cfg.num_actions)
    action = np.zeros(cfg.num_actions)
    hist_obs = deque(maxlen=cfg.frame_stack)
    for _ in range(cfg.frame_stack):
        hist_obs.append(np.zeros(cfg.num_single_obs))

    count_lowlevel = 0
    n_steps = int(cfg.sim_duration / cfg.sim_dt)
    heights, xs, vxs = [], [], []
    states = []
    fallen_at: Optional[float] = None

    for step in range(n_steps):
        q, dq, quat, omega = get_obs(data)
        qj = q[-cfg.num_actions :]
        dqj = dq[-cfg.num_actions :]

        if count_lowlevel % cfg.decimation == 0:
            t = count_lowlevel * cfg.sim_dt
            obs = np.zeros(cfg.num_single_obs)
            eu = quaternion_to_euler_array(quat)
            eu[eu > np.pi] -= 2 * np.pi
            phase = 2 * np.pi * t / cfg.cycle_time
            obs[0] = np.sin(phase)
            obs[1] = np.cos(phase)
            obs[2] = cfg.cmd_vx * cfg.obs_scale_lin_vel
            obs[3] = cfg.cmd_vy * cfg.obs_scale_lin_vel
            obs[4] = cfg.cmd_dyaw * cfg.obs_scale_ang_vel
            obs[5:17] = qj * cfg.obs_scale_dof_pos
            obs[17:29] = dqj * cfg.obs_scale_dof_vel
            obs[29:41] = action
            obs[41:44] = omega
            obs[44:47] = eu
            obs = np.clip(obs, -cfg.obs_clip, cfg.obs_clip)
            hist_obs.append(obs)

            policy_input = np.concatenate(list(hist_obs))
            action = np.asarray(policy(policy_input)).reshape(-1)
            action = np.clip(action, -cfg.action_clip, cfg.action_clip)
            target_q = action * cfg.action_scale

        # 1 kHz PD (reference sim2sim.py:82-85,153-157)
        tau = cfg.kps * (target_q - qj) - cfg.kds * dqj
        tau = np.clip(tau, -cfg.tau_limit, cfg.tau_limit)
        data.ctrl = tau
        mujoco.mj_step(model, data)
        count_lowlevel += 1

        if renderer is not None and step % (1000 // renderer.fps) == 0:
            t = step * cfg.sim_dt
            renderer.add_frame(
                data,
                hud=f"t={t:5.2f}s  vx={data.qvel[0]:+.2f} m/s  "
                f"z={data.xpos[1][2]:.2f} m  cmd vx={cfg.cmd_vx:.2f}",
            )

        if step % 100 == 0:
            # absolute base height from body kinematics (the MJCF free base is
            # slide+ball joints, so qpos[2] is a *displacement*, not height)
            base_z = float(data.xpos[1][2])
            heights.append(base_z)
            xs.append(float(data.xpos[1][0]))
            vxs.append(float(data.qvel[0]))
            if record_states:
                states.append(np.array(data.qpos))
            # fall = base below cfg.fall_below over the LOCAL terrain
            # (absolute z is meaningless on the hfield, where mounds reach
            # 0.35 m)
            ground = height_at(float(data.xpos[1][0]), float(data.xpos[1][1]))
            if fallen_at is None and base_z - ground < cfg.fall_below:
                fallen_at = step * cfg.sim_dt

    out = {
        "distance_x": xs[-1] - xs[0] if xs else 0.0,
        "mean_height": float(np.mean(heights)) if heights else 0.0,
        "mean_vx": float(np.mean(vxs)) if vxs else 0.0,
        "fallen_at_s": fallen_at,
        "duration_s": cfg.sim_duration,
    }
    if record_states:
        out["states"] = np.stack(states)
    if renderer is not None:
        out["video"] = renderer.save(video_path)
    return out
