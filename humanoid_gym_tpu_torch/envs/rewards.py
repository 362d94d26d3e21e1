"""The 22 XBot-L reward terms (plus 4 base-class terms), batched.

Port of humanoid_gym_tpu/envs/rewards.py: each term is
``fn(ctx: RewardCtx) -> (N,)``; the stateful terms' buffer updates are
returned by `feet_state_update`. The env multiplies by ``scale * dt``.

`make_rewards` builds the env step's whole reward stage: on CUDA tensors
one launch of csrc/rewards.cu (`rewards_launch`), on CPU tensors the plain
chain of these functions (`.plain`).
"""

from __future__ import annotations

import ctypes
import math
from typing import Callable, Dict, NamedTuple

import numpy as np
import torch

from ..physics.cuda_build import check, kernel_library


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


# ---------------------------------------------------------------- the stage

# the terms csrc/rewards.cu computes (its `enum Term`), in this order
KERNEL_TERMS = tuple(REWARD_FUNCTIONS)


class RewardInputs(NamedTuple):
    """The step's tensors the reward stage reads, env axis first."""

    episode_length: torch.Tensor  # (N,) int32, this step's (after the increment)
    qpos: torch.Tensor  # (N, nq): root z at 2, joints at 7
    qvel: torch.Tensor  # (N, nv): root [lin, ang] at 0-5, joints at 6
    last_dof_vel: torch.Tensor  # (N, nj)
    actions: torch.Tensor  # (N, na)
    last_actions: torch.Tensor  # (N, na)
    last_last_actions: torch.Tensor  # (N, na)
    torques: torch.Tensor  # (N, nj)
    ref_dof_pos: torch.Tensor  # (N, nj)
    base_lin_vel: torch.Tensor  # (N, 3)
    base_ang_vel: torch.Tensor  # (N, 3)
    base_euler: torch.Tensor  # (N, 3)
    projected_gravity: torch.Tensor  # (N, 3)
    commands: torch.Tensor  # (N, 4)
    last_root_vel: torch.Tensor  # (N, 6)
    feet_rows: torch.Tensor  # (N, 14): feet x (2), y (2), z (2), knee x, y, feet vx, vy
    contact_forces: torch.Tensor  # (N, nbody, 3)
    collision_flags: torch.Tensor  # (N, n_pen) bool
    feet_air_time: torch.Tensor  # (N, 2)
    last_contacts: torch.Tensor  # (N, 2) bool
    feet_height: torch.Tensor  # (N, 2)
    last_feet_z: torch.Tensor  # (N, 2)
    episode_sums: torch.Tensor  # (N, n_terms)
    finite: torch.Tensor  # (N,) bool
    done: torch.Tensor  # (N,) bool
    time_out: torch.Tensor  # (N,) bool


class RewardOutputs(NamedTuple):
    reward: torch.Tensor  # (N,)
    episode_sums: torch.Tensor  # (N, n_terms)
    feet: FeetStateUpdate  # masked where the state is not finite
    contact: torch.Tensor  # (N, 2) bool: feet force z > 5 N


# csrc/rewards.cu's pointer slots (`enum Slot`), float parameters (`enum
# FParam`, then a scale per kernel term) and int parameters (`enum IParam`,
# then an episode-sum column per kernel term)
SLOTS = RewardInputs._fields + ("default_dof_pos",) + tuple(
    "out_" + k for k in ("reward", "episode_sums", "feet_air_time", "last_contacts",
                         "feet_height", "last_feet_z", "contact"))
FPARAMS = ("dt", "inv_dt", "inv_cycle_time", "target_feet_height", "base_height_target",
           "min_dist", "max_dist", "half_max_dist", "tracking_sigma", "max_contact_force",
           "sole_offset", "termination_scale")
IPARAMS = ("nj", "n_pen", "n_cols", "foot_body_0", "foot_body_1", "feet_base", "only_positive")


def gait_phase(episode_length: torch.Tensor, dt: float, cycle_time: float) -> torch.Tensor:
    return episode_length.to(torch.float32) * dt / cycle_time


def stance_mask(phase: torch.Tensor) -> torch.Tensor:
    sin_pos = torch.sin(2 * math.pi * phase)
    mask = torch.stack([(sin_pos >= 0).float(), (sin_pos < 0).float()], dim=1)
    return torch.where(torch.abs(sin_pos)[:, None] < 0.1, 1.0, mask)


def make_rewards(rcfg, dt: float, default_dof_pos: torch.Tensor, feet_body_idx, feet_base: bool):
    """rewards(inp: RewardInputs) -> RewardOutputs: the env step's reward
    stage for the config `rcfg` (a RewardsCfg) at policy step `dt`, the
    robot's default joint angles (nj,) and its two feet bodies.
    `feet_base`: `inp.feet_rows` are the mega kernel's FK rows (positions
    base-relative, so the base's xyz is added); otherwise world frame.

    The terms are the config's nonzero scales (`names`, the episode sums'
    columns in this order; `scales`, each times dt, float32); a
    `termination` scale adds termination_scale * dt where done and not
    time_out. A name outside KERNEL_TERMS raises here.

    A CUDA tensor takes one launch of csrc/rewards.cu (`rewards_launch`);
    a CPU tensor takes `rewards.plain`: the gait phase and stance mask, the
    feet kinematics, a RewardCtx, the terms stacked, masked where the state
    is not finite, scaled and summed, the only-positive clip, the
    termination term and `feet_state_update`, masked."""
    scales = rcfg.scales.nonzero_terms()
    names = tuple(n for n in scales if n != "termination")
    unknown = [n for n in names if n not in KERNEL_TERMS]
    if unknown:
        raise ValueError(f"reward terms {unknown} have no function; the terms are {KERNEL_TERMS}")
    dev = default_dof_pos.device
    scale_values = np.asarray([scales[n] * dt for n in names], np.float32)
    reward_scales = torch.as_tensor(scale_values, device=dev)
    termination_scale = scales.get("termination", 0.0) * dt
    if len(feet_body_idx) != 2:
        raise ValueError(f"the reward stage takes two feet, not {len(feet_body_idx)}")
    fns = [REWARD_FUNCTIONS[n] for n in names]
    feet_idx = torch.as_tensor(tuple(feet_body_idx), dtype=torch.int64, device=dev)

    def plain(inp: RewardInputs) -> RewardOutputs:
        qpos, rel = inp.qpos, inp.feet_rows
        feet_z = rel[:, 4:6]
        feet_pos_xy = torch.stack([rel[:, 0:2], rel[:, 2:4]], dim=2)
        knee_pos_xy = torch.stack([rel[:, 6:8], rel[:, 8:10]], dim=2)
        if feet_base:
            base_xy = qpos[:, None, :2]
            feet_z = feet_z + qpos[:, 2:3]
            feet_pos_xy = feet_pos_xy + base_xy
            knee_pos_xy = knee_pos_xy + base_xy
        feet_vel_xy = torch.stack([rel[:, 10:12], rel[:, 12:14]], dim=2)
        feet_force = inp.contact_forces[:, feet_idx]
        contact = feet_force[..., 2] > 5.0
        ctx = RewardCtx(
            dt=dt,
            default_dof_pos=default_dof_pos,
            cycle_time=rcfg.cycle_time,
            target_joint_pos_scale=rcfg.target_joint_pos_scale,
            target_feet_height=rcfg.target_feet_height,
            base_height_target=rcfg.base_height_target,
            min_dist=rcfg.min_dist,
            max_dist=rcfg.max_dist,
            tracking_sigma=rcfg.tracking_sigma,
            max_contact_force=rcfg.max_contact_force,
            sole_offset=rcfg.sole_offset,
            dof_pos=qpos[:, 7:],
            dof_vel=inp.qvel[:, 6:],
            last_dof_vel=inp.last_dof_vel,
            actions=inp.actions,
            last_actions=inp.last_actions,
            last_last_actions=inp.last_last_actions,
            torques=inp.torques,
            base_lin_vel=inp.base_lin_vel,
            base_ang_vel=inp.base_ang_vel,
            base_euler=inp.base_euler,
            projected_gravity=inp.projected_gravity,
            commands=inp.commands,
            root_z=qpos[:, 2],
            root_vel=inp.qvel[:, 0:6],
            last_root_vel=inp.last_root_vel,
            feet_z=feet_z,
            feet_vel_xy=feet_vel_xy,
            feet_pos_xy=feet_pos_xy,
            knee_pos_xy=knee_pos_xy,
            feet_contact_force=feet_force,
            contact=contact,
            stance_mask=stance_mask(gait_phase(inp.episode_length, dt, rcfg.cycle_time)),
            ref_dof_pos=inp.ref_dof_pos,
            collision_flags=inp.collision_flags,
            feet_air_time=inp.feet_air_time,
            last_contacts=inp.last_contacts,
            feet_height=inp.feet_height,
            last_feet_z=inp.last_feet_z,
        )
        finite = inp.finite
        term_values = torch.stack([fn(ctx) for fn in fns], dim=1)
        term_values = torch.where(finite[:, None], term_values, 0.0)
        scaled = term_values * reward_scales
        episode_sums = inp.episode_sums + scaled
        reward = torch.sum(scaled, dim=1)
        if rcfg.only_positive_rewards:
            reward = torch.clamp(reward, min=0.0)
        if termination_scale != 0.0:
            reward = reward + termination_scale * (inp.done & ~inp.time_out)

        fsu = feet_state_update(ctx)
        fin2 = finite[:, None]
        fsu = FeetStateUpdate(
            feet_air_time=torch.where(fin2, fsu.feet_air_time, 0.0),
            last_contacts=fsu.last_contacts & fin2,
            feet_height=torch.where(fin2, fsu.feet_height, 0.0),
            last_feet_z=torch.where(fin2, fsu.last_feet_z, 0.05),
        )
        return RewardOutputs(reward, episode_sums, fsu, contact)

    # the kernel's parameters: floats rounded to float32 as PyTorch rounds a
    # Python number on the card (a division by one is a multiply by its
    # float32 reciprocal)
    fvals = dict(
        dt=dt, inv_dt=np.float32(1.0) / np.float32(dt),
        inv_cycle_time=np.float32(1.0) / np.float32(rcfg.cycle_time),
        target_feet_height=rcfg.target_feet_height, base_height_target=rcfg.base_height_target,
        min_dist=rcfg.min_dist, max_dist=rcfg.max_dist, half_max_dist=rcfg.max_dist / 2.0,
        tracking_sigma=rcfg.tracking_sigma, max_contact_force=rcfg.max_contact_force,
        sole_offset=rcfg.sole_offset, termination_scale=termination_scale)
    col = {n: i for i, n in enumerate(names)}
    fparams = [float(np.float32(fvals[k])) for k in FPARAMS] + [
        float(scale_values[col[n]]) if n in col else 0.0 for n in KERNEL_TERMS]
    ivals = dict(nj=default_dof_pos.shape[0], n_cols=len(names), foot_body_0=feet_body_idx[0],
                 foot_body_1=feet_body_idx[1], feet_base=int(feet_base),
                 only_positive=int(rcfg.only_positive_rewards))
    table = (fparams, ivals, [col.get(n, -1) for n in KERNEL_TERMS])

    def rewards(inp: RewardInputs) -> RewardOutputs:
        if inp.qpos.is_cuda:
            return rewards_launch(inp, default_dof_pos, table)
        return plain(inp)

    rewards.plain = plain
    rewards.names = names
    rewards.scales = reward_scales
    rewards.termination_scale = termination_scale
    rewards.table = table
    rewards.default_dof_pos = default_dof_pos
    return rewards


def _layout_error(name: str, t: torch.Tensor, want: str) -> ValueError:
    return ValueError(f"rewards_launch: {name} must be {want} with unit column stride on the "
                      f"device of qpos; got {tuple(t.shape)} {t.dtype} strides {t.stride()} on "
                      f"{t.device}")


def rewards_launch(inp: RewardInputs, default_dof_pos: torch.Tensor, table) -> RewardOutputs:
    """Launch csrc/rewards.cu on CUDA inputs: the reward stage of
    `make_rewards` (whose `table` it takes: the float parameters and scales,
    the int parameters, the episode-sum column of each KERNEL_TERMS entry).
    Each input is read in place: float32 (bool for the flags, int32 for the
    episode length) with the documented width, unit column stride and any
    row stride; the outputs are new. Counts launches in
    `rewards_launch.launches`."""
    q = inp.qpos
    if not q.is_cuda:
        raise ValueError("rewards_launch takes CUDA tensors")
    n, dev = q.shape[0], q.device
    fparams, ivals, cols = table
    nj = ivals["nj"]
    if nj < 8:
        raise ValueError(f"rewards_launch: default_joint_pos reads joints 6 and 7; nj = {nj}")
    n_pen = inp.collision_flags.shape[1] if inp.collision_flags.dim() == 2 else -1
    widths = dict(qpos=(7 + nj, None), qvel=(6 + nj, None), last_dof_vel=(nj, nj),
                  actions=(nj, nj), last_actions=(nj, nj), last_last_actions=(nj, nj),
                  torques=(nj, nj), ref_dof_pos=(nj, nj), base_lin_vel=(3, 3),
                  base_ang_vel=(3, 3), base_euler=(3, 3), projected_gravity=(3, 3),
                  commands=(4, 4), last_root_vel=(6, 6), feet_rows=(14, 14),
                  collision_flags=(n_pen, n_pen), feet_air_time=(2, 2), last_contacts=(2, 2),
                  feet_height=(2, 2), last_feet_z=(2, 2),
                  episode_sums=(ivals["n_cols"], ivals["n_cols"]))
    flags = ("collision_flags", "last_contacts", "finite", "done", "time_out")
    ptrs, strides = [], []
    for name, t in zip(RewardInputs._fields, inp):
        dtype = torch.bool if name in flags else (
            torch.int32 if name == "episode_length" else torch.float32)
        if t.device != dev or t.dtype != dtype or t.shape[0] != n:
            raise _layout_error(name, t, f"{dtype} ({n}, ...)")
        if name == "contact_forces":
            if t.dim() != 3 or t.shape[2] != 3 or t.stride(2) != 1 or t.stride(1) != 3 \
                    or t.shape[1] <= max(ivals["foot_body_0"], ivals["foot_body_1"]):
                raise _layout_error(name, t, "(N, nbody, 3), the bodies packed,")
        elif name in widths:
            lo, hi = widths[name]
            if t.dim() != 2 or t.shape[1] < lo or (hi is not None and t.shape[1] != hi) \
                    or t.stride(1) != 1:
                raise _layout_error(name, t, f"(N, {lo}{'' if hi else '+'})")
        elif t.dim() != 1:
            raise _layout_error(name, t, "(N,)")
        ptrs.append(t.data_ptr())
        strides.append(t.stride(0))
    if default_dof_pos.device != dev or default_dof_pos.dtype != torch.float32 \
            or tuple(default_dof_pos.shape) != (nj,) or not default_dof_pos.is_contiguous():
        raise _layout_error("default_dof_pos", default_dof_pos, f"contiguous ({nj},)")
    lib = kernel_library()
    out = RewardOutputs(
        reward=torch.empty((n,), device=dev),
        episode_sums=torch.empty((n, ivals["n_cols"]), device=dev),
        feet=FeetStateUpdate(
            feet_air_time=torch.empty((n, 2), device=dev),
            last_contacts=torch.empty((n, 2), device=dev, dtype=torch.bool),
            feet_height=torch.empty((n, 2), device=dev),
            last_feet_z=torch.empty((n, 2), device=dev)),
        contact=torch.empty((n, 2), device=dev, dtype=torch.bool))
    outs = (out.reward, out.episode_sums, out.feet.feet_air_time, out.feet.last_contacts,
            out.feet.feet_height, out.feet.last_feet_z, out.contact)
    ptrs += [default_dof_pos.data_ptr()] + [t.data_ptr() for t in outs]
    strides += [0] + [t.stride(0) for t in outs]
    iparams = [dict(ivals, n_pen=n_pen)[k] for k in IPARAMS] + list(cols)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.rewards.hgt_rewards(
        (ctypes.c_uint64 * len(ptrs))(*ptrs), (ctypes.c_int * len(strides))(*strides),
        (ctypes.c_float * len(fparams))(*fparams), (ctypes.c_int * len(iparams))(*iparams),
        n, stream)
    check(err, "hgt_rewards launch")
    rewards_launch.launches += 1
    return out


rewards_launch.launches = 0
