"""The 22 XBot-L reward terms (plus 4 base-class terms), batched.

Port of humanoid_gym_tpu/envs/rewards.py: each term is
``fn(ctx: RewardCtx) -> (N,)``; the stateful terms' buffer updates are
returned by `feet_state_update`. The env multiplies by ``scale * dt``.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple

import torch


class RewardCtx(NamedTuple):
    # --- configuration scalars/vectors ---
    dt: float
    default_dof_pos: torch.Tensor  # (nj,)
    cycle_time: float
    target_joint_pos_scale: float
    target_feet_height: float
    base_height_target: float
    min_dist: float
    max_dist: float
    tracking_sigma: float
    max_contact_force: float
    sole_offset: float

    # --- dynamic quantities (this step, pre-reset), env axis first ---
    dof_pos: torch.Tensor  # (N, nj)
    dof_vel: torch.Tensor  # (N, nj)
    last_dof_vel: torch.Tensor  # (N, nj)
    actions: torch.Tensor  # (N, na)
    last_actions: torch.Tensor  # (N, na)
    last_last_actions: torch.Tensor  # (N, na)
    torques: torch.Tensor  # (N, nj)
    base_lin_vel: torch.Tensor  # (N, 3) body frame
    base_ang_vel: torch.Tensor  # (N, 3) body frame
    base_euler: torch.Tensor  # (N, 3)
    projected_gravity: torch.Tensor  # (N, 3)
    commands: torch.Tensor  # (N, 4)
    root_z: torch.Tensor  # (N,)
    root_vel: torch.Tensor  # (N, 6) world [lin, ang]
    last_root_vel: torch.Tensor  # (N, 6)
    feet_z: torch.Tensor  # (N, 2)
    feet_vel_xy: torch.Tensor  # (N, 2, 2)
    feet_pos_xy: torch.Tensor  # (N, 2, 2)
    knee_pos_xy: torch.Tensor  # (N, 2, 2)
    feet_contact_force: torch.Tensor  # (N, 2, 3)
    contact: torch.Tensor  # (N, 2) bool: feet force z > 5 N
    stance_mask: torch.Tensor  # (N, 2)
    ref_dof_pos: torch.Tensor  # (N, nj) stale, from the previous obs pass
    collision_flags: torch.Tensor  # (N, n_pen) bool

    # --- stateful-term carries (pre-update values) ---
    feet_air_time: torch.Tensor  # (N, 2)
    last_contacts: torch.Tensor  # (N, 2) bool
    feet_height: torch.Tensor  # (N, 2)
    last_feet_z: torch.Tensor  # (N, 2)


class FeetStateUpdate(NamedTuple):
    feet_air_time: torch.Tensor
    last_contacts: torch.Tensor
    feet_height: torch.Tensor
    last_feet_z: torch.Tensor


def _norm(x: torch.Tensor, dim=-1) -> torch.Tensor:
    return torch.linalg.norm(x, dim=dim)


def feet_state_update(ctx: RewardCtx) -> FeetStateUpdate:
    contact_filt = ctx.contact | (ctx.stance_mask > 0.5) | ctx.last_contacts
    air = (ctx.feet_air_time + ctx.dt) * (~contact_filt)
    feet_z = ctx.feet_z - ctx.sole_offset
    fh = (ctx.feet_height + (feet_z - ctx.last_feet_z)) * (~ctx.contact)
    return FeetStateUpdate(
        feet_air_time=air, last_contacts=ctx.contact, feet_height=fh, last_feet_z=feet_z
    )


def joint_pos(ctx):
    d = _norm(ctx.dof_pos - ctx.ref_dof_pos)
    return torch.exp(-2.0 * d) - 0.2 * torch.clamp(d, 0.0, 0.5)


def _pair_distance_reward(dist, min_d, max_d):
    d_min = torch.clamp(dist - min_d, -0.5, 0.0)
    d_max = torch.clamp(dist - max_d, 0.0, 0.5)
    return (torch.exp(-torch.abs(d_min) * 100) + torch.exp(-torch.abs(d_max) * 100)) / 2.0


def feet_distance(ctx):
    dist = _norm(ctx.feet_pos_xy[:, 0] - ctx.feet_pos_xy[:, 1])
    return _pair_distance_reward(dist, ctx.min_dist, ctx.max_dist)


def knee_distance(ctx):
    dist = _norm(ctx.knee_pos_xy[:, 0] - ctx.knee_pos_xy[:, 1])
    return _pair_distance_reward(dist, ctx.min_dist, ctx.max_dist / 2.0)


def foot_slip(ctx):
    speed = _norm(ctx.feet_vel_xy)
    return torch.sum(torch.sqrt(speed) * ctx.contact, dim=-1)


def feet_air_time(ctx):
    contact_filt = ctx.contact | (ctx.stance_mask > 0.5) | ctx.last_contacts
    first_contact = (ctx.feet_air_time > 0.0) * contact_filt
    air = torch.clamp(ctx.feet_air_time + ctx.dt, 0.0, 0.5) * first_contact
    return torch.sum(air, dim=-1)


def feet_contact_number(ctx):
    match = ctx.contact == (ctx.stance_mask > 0.5)
    return torch.mean(torch.where(match, 1.0, -0.3), dim=-1)


def orientation(ctx):
    quat_mismatch = torch.exp(-torch.sum(torch.abs(ctx.base_euler[:, :2]), dim=-1) * 10.0)
    grav = torch.exp(-_norm(ctx.projected_gravity[:, :2]) * 20.0)
    return (quat_mismatch + grav) / 2.0


def feet_contact_forces(ctx):
    f = _norm(ctx.feet_contact_force)
    return torch.sum(torch.clamp(f - ctx.max_contact_force, 0.0, 400.0), dim=-1)


def default_joint_pos(ctx):
    diff = ctx.dof_pos - ctx.default_dof_pos
    yaw_roll = _norm(diff[:, :2]) + _norm(diff[:, 6:8])
    yaw_roll = torch.clamp(yaw_roll - 0.1, 0.0, 50.0)
    return torch.exp(-yaw_roll * 100.0) - 0.01 * _norm(diff)


def base_height(ctx):
    stance = ctx.stance_mask
    mean_feet_z = torch.sum(ctx.feet_z * stance, dim=-1) / torch.clamp(
        torch.sum(stance, dim=-1), min=1e-9
    )
    h = ctx.root_z - (mean_feet_z - ctx.sole_offset)
    return torch.exp(-torch.abs(h - ctx.base_height_target) * 100.0)


def base_acc(ctx):
    return torch.exp(-_norm(ctx.last_root_vel - ctx.root_vel) * 3.0)


def vel_mismatch_exp(ctx):
    lin = torch.exp(-torch.square(ctx.base_lin_vel[:, 2]) * 10.0)
    ang = torch.exp(-_norm(ctx.base_ang_vel[:, :2]) * 5.0)
    return (lin + ang) / 2.0


def track_vel_hard(ctx):
    lin_err = _norm(ctx.commands[:, :2] - ctx.base_lin_vel[:, :2])
    ang_err = torch.abs(ctx.commands[:, 2] - ctx.base_ang_vel[:, 2])
    return (torch.exp(-lin_err * 10.0) + torch.exp(-ang_err * 10.0)) / 2.0 - 0.2 * (
        lin_err + ang_err
    )


def tracking_lin_vel(ctx):
    err = torch.sum(torch.square(ctx.commands[:, :2] - ctx.base_lin_vel[:, :2]), dim=-1)
    return torch.exp(-err * ctx.tracking_sigma)


def tracking_ang_vel(ctx):
    err = torch.square(ctx.commands[:, 2] - ctx.base_ang_vel[:, 2])
    return torch.exp(-err * ctx.tracking_sigma)


def feet_clearance(ctx):
    feet_z = ctx.feet_z - ctx.sole_offset
    fh = ctx.feet_height + (feet_z - ctx.last_feet_z)
    swing = 1.0 - ctx.stance_mask
    near = torch.abs(fh - ctx.target_feet_height) < 0.01
    return torch.sum(near * swing, dim=-1)


def low_speed(ctx):
    v = ctx.base_lin_vel[:, 0]
    c = ctx.commands[:, 0]
    av, ac = torch.abs(v), torch.abs(c)
    too_low = av < 0.5 * ac
    too_high = av > 1.2 * ac
    desired = ~(too_low | too_high)
    sign_mismatch = torch.sign(v) != torch.sign(c)
    r = torch.where(too_low, -1.0, 0.0)
    r = torch.where(too_high, 0.0, r)
    r = torch.where(desired, 1.2, r)
    r = torch.where(sign_mismatch, -2.0, r)
    return r * (torch.abs(c) > 0.1)


def torques(ctx):
    return torch.sum(torch.square(ctx.torques), dim=-1)


def dof_vel(ctx):
    return torch.sum(torch.square(ctx.dof_vel), dim=-1)


def dof_acc(ctx):
    return torch.sum(torch.square((ctx.last_dof_vel - ctx.dof_vel) / ctx.dt), dim=-1)


def collision(ctx):
    return torch.sum(ctx.collision_flags.to(torch.float32), dim=-1)


def action_smoothness(ctx):
    t1 = torch.sum(torch.square(ctx.last_actions - ctx.actions), dim=-1)
    t2 = torch.sum(
        torch.square(ctx.actions + ctx.last_last_actions - 2.0 * ctx.last_actions), dim=-1
    )
    t3 = 0.05 * torch.sum(torch.abs(ctx.actions), dim=-1)
    return t1 + t2 + t3


# base-class terms kept for config portability (zero in the XBot config)


def lin_vel_z(ctx):
    return torch.square(ctx.base_lin_vel[:, 2])


def ang_vel_xy(ctx):
    return torch.sum(torch.square(ctx.base_ang_vel[:, :2]), dim=-1)


def action_rate(ctx):
    return torch.sum(torch.square(ctx.last_actions - ctx.actions), dim=-1)


def stand_still(ctx):
    return torch.sum(torch.abs(ctx.dof_pos - ctx.default_dof_pos), dim=-1) * (
        _norm(ctx.commands[:, :2]) < 0.1
    )


REWARD_FUNCTIONS: Dict[str, Callable[[RewardCtx], torch.Tensor]] = {
    "joint_pos": joint_pos,
    "feet_clearance": feet_clearance,
    "feet_contact_number": feet_contact_number,
    "feet_air_time": feet_air_time,
    "foot_slip": foot_slip,
    "feet_distance": feet_distance,
    "knee_distance": knee_distance,
    "feet_contact_forces": feet_contact_forces,
    "tracking_lin_vel": tracking_lin_vel,
    "tracking_ang_vel": tracking_ang_vel,
    "vel_mismatch_exp": vel_mismatch_exp,
    "low_speed": low_speed,
    "track_vel_hard": track_vel_hard,
    "default_joint_pos": default_joint_pos,
    "orientation": orientation,
    "base_height": base_height,
    "base_acc": base_acc,
    "action_smoothness": action_smoothness,
    "torques": torques,
    "dof_vel": dof_vel,
    "dof_acc": dof_acc,
    "collision": collision,
    "lin_vel_z": lin_vel_z,
    "ang_vel_xy": ang_vel_xy,
    "action_rate": action_rate,
    "stand_still": stand_still,
}
