"""XBot-S task configuration: the Froude-scaled variant of XBot-L.

The PyTorch port's copy of humanoid_gym_tpu/config/xbots.py. The model is
XBot-L's URDF scaled by s = 1.2/1.65 (utils/scale_urdf.py). Froude scaling
gives time ~ sqrt(s), velocity ~ sqrt(s), torque ~ s^4: so kp x s^4,
kd x s^4.5, the gait cycle x sqrt(s), heights x s, commanded velocities and
pushes x sqrt(s), the base-mass DR range x s^3; terrain heights x s
(`froude_scale`) and the deploy style samples the scaled deployment field
(`deploy_mjcf`).
"""

from __future__ import annotations

import math
import os

from . import base as B
from .xbotl import XBotLCfg, XBotLCfgPPO

SCALE = 1.2 / 1.65
_SQ = math.sqrt(SCALE)


def XBotSCfg() -> B.LeggedRobotCfg:
    from .. import XBOT_S_TERRAIN_MJCF
    from ..utils.scale_urdf import ensure_xbot_s

    cfg = XBotLCfg()
    s = SCALE

    cfg.asset.file = ensure_xbot_s()
    cfg.asset.name = "XBot-S"
    # meshes are shared with XBot-L (geometry scaled via URDF mesh scale)
    cfg.asset.mesh_dir = os.path.normpath(
        os.path.join(os.path.dirname(XBotLCfg().asset.file), "..", "meshes")
    )

    # lengths/heights x s
    cfg.init_state.pos = [0.0, 0.0, 0.95 * s]
    cfg.rewards.base_height_target = 0.89 * s
    cfg.rewards.min_dist = 0.2 * s
    cfg.rewards.max_dist = 0.5 * s
    cfg.rewards.target_feet_height = 0.06 * s
    cfg.rewards.sole_offset = 0.05 * s

    # time x sqrt(s)
    cfg.rewards.cycle_time = 0.64 * _SQ

    # torques x s^4, damping x s^4.5
    cfg.control.stiffness = {k: v * s**4 for k, v in cfg.control.stiffness.items()}
    cfg.control.damping = {k: v * s**4.5 for k, v in cfg.control.damping.items()}

    # command velocities x sqrt(s) (Froude speed)
    r = cfg.commands.ranges
    r.lin_vel_x = [v * _SQ for v in r.lin_vel_x]
    r.lin_vel_y = [v * _SQ for v in r.lin_vel_y]

    # terrain x s: menu height amplitudes scale at map-build time, and the
    # deploy-style menu samples the Froude-scaled deployment field
    cfg.terrain.froude_scale = s
    cfg.terrain.deploy_mjcf = XBOT_S_TERRAIN_MJCF

    # pushes x sqrt(s)
    cfg.domain_rand.max_push_vel_xy *= _SQ
    # base-mass DR x s^3 (same relative range)
    cfg.domain_rand.added_mass_range = [v * s**3 for v in cfg.domain_rand.added_mass_range]

    return cfg


def XBotSCfgPPO() -> B.PPOCfg:
    cfg = XBotLCfgPPO()
    cfg.runner.experiment_name = "XBotS_ppo"
    return cfg
