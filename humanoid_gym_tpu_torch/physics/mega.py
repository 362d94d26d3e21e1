"""Whole-policy-step physics: the CUDA mega kernel and its plain version.

Port of humanoid_gym_tpu/physics/mega_kernel.py. One call runs all
`decimation` 1 kHz substeps (PD, FK, bias forces, CRBA mass matrix, contact
and joint-limit rows, the contact solve, integration) for every env and
returns the six outputs of `make_mega_step_batched`:

  qpos (19), qvel (18), lam (60, physical signs), tau (12),
  ff (6, per-foot world-frame impulse sums), fk14 (14, end-of-step
  feet/knee kinematics: [fLx,fRx, fLy,fRy, fLz,fRz, kLx,kRx, kLy,kRy,
  vLx,vRx, vLy,vRy], positions base-relative, feet v_origin world-frame).

A CUDA tensor goes to the kernel (csrc/mega.cu: one thread per env, all
substeps in one launch, env-major (N, 120) in / (N, 136) out in the
`IN_*` / `OUT_*` row layout of the TPU kernel). A CPU tensor goes to
`mega_step_plain`, a batched port of the TPU package's single-env
fallback `step` (mega_kernel.py:1669-1774) with the kernel's own solve
stage. Flat ground only.
"""

from __future__ import annotations

import numpy as np
import torch

from . import spatial as S
from .contact import build_contact_setup, joint_limit_bounds
from .cuda_build import check, kernel_library
from .dynamics import Dyn, bias_forces_explicit, mass_matrix
from .kinematics import ancestor_mask, body_velocities, fk
from .model import RobotModel
from .solve import fused_solve_plain

N_POINTS = 16
NQ, NV, NJ = 19, 18, 12

# input / output row layouts (mega_kernel.py:76-88, 153-167)
IN_QPOS, IN_QVEL, IN_TGT = 0, 19, 37
IN_FRIC, IN_MS, IN_CSTIFF, IN_COFF, IN_KPS, IN_KDS, IN_COMP = 49, 50, 51, 52, 53, 54, 55
IN_LAM = 56
IN_ROWS = 120
OUT_QPOS, OUT_QVEL, OUT_LAM, OUT_TAU, OUT_FF, OUT_FK = 0, 19, 37, 97, 109, 115
OUT_ROWS = 136
# external DOF order [base 0:6, left leg 6:12, right leg 12:18] -> the
# solver-internal order [left leg, right leg, base], and back
PERM = list(range(6, 18)) + list(range(6))
INV_PERM = [PERM.index(i) for i in range(NV)]

# __constant__ model layout: (name, length); offsets must match csrc/mega.cu
CONST_LAYOUT = (
    ("mass", 13), ("com", 39), ("inertia", 117), ("jpos", 36), ("jrot", 108),
    ("jaxis", 36), ("coff", 48), ("kp", 12), ("kd", 12), ("tlim", 12),
    ("low", 12), ("up", 12), ("vlim", 12), ("jfric", 12), ("jdamp", 12),
    ("arm", 12), ("grav", 3), ("parent", 13), ("cbody", 16), ("feet", 2),
    ("knee", 2),
)
CONST_COUNT = sum(n for _, n in CONST_LAYOUT)  # 541


def flat_height_fn(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Plane terrain (mesh_type='plane', the XBot-L default)."""
    return torch.zeros_like(x)


def check_mega_topology(model: RobotModel) -> None:
    """The kernel is specialized to XBot-L's tree: two 6-joint chains off
    the base, feet at the chain tips, knees at the same depth in both legs,
    foot-L contact points first and foot-R second (8 each)."""
    nj, nb = model.nj, model.nbody
    if model.body_parent != (-1, 0, 1, 2, 3, 4, 5, 0, 7, 8, 9, 10, 11):
        raise ValueError(f"mega kernel needs two mirror 6-joint chains; parent={model.body_parent}")
    if tuple(model.feet_body_idx) != (nj // 2, nb - 1):
        raise ValueError(f"mega kernel needs feet at the chain tips; feet={model.feet_body_idx}")
    if len(model.knee_body_idx) != 2 or model.knee_body_idx[1] - model.knee_body_idx[0] != nj // 2:
        raise ValueError(f"mega kernel needs mirrored knees; knee={model.knee_body_idx}")
    runs = model.contact_point_runs()
    if runs != ((nj // 2, 0, N_POINTS // 2), (nb - 1, N_POINTS // 2, N_POINTS)):
        raise ValueError(f"mega kernel needs 8 sole points per foot, L first; runs={runs}")


def pack_model_constants(model: RobotModel, kp, kd, torque_limit) -> np.ndarray:
    """The kernel's __constant__ block (CONST_LAYOUT order), float32."""
    def a(x):
        return np.asarray(torch.as_tensor(x).detach().cpu(), np.float64).ravel()

    axis = a(model.joint_axis).reshape(-1, 3)
    axis = axis / np.linalg.norm(axis, axis=1, keepdims=True)
    vals = {
        "mass": a(model.body_mass), "com": a(model.body_com),
        "inertia": a(model.body_inertia), "jpos": a(model.joint_pos),
        "jrot": a(model.joint_rot), "jaxis": axis.ravel(),
        "coff": a(model.contact_point_offset), "kp": a(kp), "kd": a(kd),
        "tlim": a(torque_limit), "low": a(model.dof_lower), "up": a(model.dof_upper),
        "vlim": a(model.dof_vel_limit), "jfric": a(model.dof_friction),
        "jdamp": a(model.dof_damping), "arm": a(model.dof_armature),
        "grav": a(model.gravity), "parent": np.asarray(model.body_parent, np.float64),
        "cbody": np.asarray(model.contact_point_body, np.float64),
        "feet": np.asarray(model.feet_body_idx, np.float64),
        "knee": np.asarray(model.knee_body_idx, np.float64),
    }
    parts = []
    for name, n in CONST_LAYOUT:
        if vals[name].shape != (n,):
            raise ValueError(f"constant {name}: expected {n} values, got {vals[name].shape}")
        parts.append(vals[name])
    return np.concatenate(parts).astype(np.float32)


def pack_inputs(qpos, qvel, fric, bms, cstiff, coff, kps, kds, comp, lam0, targets):
    """Per-env inputs as the kernel's env-major (N, 120) float32 rows."""
    n = qpos.shape[0]
    cols = [qpos, qvel, targets] + [x[:, None] for x in (fric, bms, cstiff, coff, kps, kds, comp)] + [lam0]
    packed = torch.cat([c.to(torch.float32) for c in cols], dim=1)
    pad = torch.zeros((n, IN_ROWS - packed.shape[1]), device=packed.device, dtype=torch.float32)
    return torch.cat([packed, pad], dim=1).contiguous()


def unpack_outputs(out: torch.Tensor):
    return (
        out[:, OUT_QPOS:OUT_QPOS + NQ],
        out[:, OUT_QVEL:OUT_QVEL + NV],
        out[:, OUT_LAM:OUT_LAM + 3 * N_POINTS + NJ],
        out[:, OUT_TAU:OUT_TAU + NJ],
        out[:, OUT_FF:OUT_FF + 6],
        out[:, OUT_FK:OUT_FK + 14],
    )


def mega_kernel_launch(packed: torch.Tensor, consts: np.ndarray, dt: float, decimation: int,
                       iterations: int, max_depen_vel: float) -> torch.Tensor:
    """Launch the mega kernel on (N, 120) CUDA rows; returns (N, 136) rows.
    Counts launches in `mega_kernel_launch.launches`."""
    if not packed.is_cuda:
        raise ValueError("mega_kernel_launch takes CUDA tensors")
    if packed.dtype != torch.float32 or packed.dim() != 2 or packed.shape[1] != IN_ROWS \
            or not packed.is_contiguous():
        raise ValueError(f"packed inputs must be contiguous float32 (N, {IN_ROWS})")
    lib = kernel_library()
    if lib.lib.hgt_const_count() != CONST_COUNT:
        raise RuntimeError("csrc/mega.cu constant layout disagrees with CONST_LAYOUT")
    blob = consts.tobytes()
    if lib.uploaded_consts != blob:
        check(lib.lib.hgt_set_model(consts.ctypes.data, CONST_COUNT), "hgt_set_model")
        lib.uploaded_consts = blob
    n = packed.shape[0]
    out = torch.empty((n, OUT_ROWS), device=packed.device, dtype=torch.float32)
    stream = torch.cuda.current_stream(packed.device).cuda_stream
    err = lib.lib.hgt_mega_step(
        packed.data_ptr(), out.data_ptr(), n, float(dt), int(decimation), int(iterations),
        float(max_depen_vel), stream,
    )
    check(err, "hgt_mega_step launch")
    mega_kernel_launch.launches += 1
    return out


mega_kernel_launch.launches = 0


def pd_torques(qpos, qvel, targets, kp, kd, torque_limit):
    """tau = kp*(target - q) - kd*qdot, clipped to +-torque_limit (N, nj)."""
    tau = kp * (targets - qpos[:, 7:]) - kd * qvel[:, 6:]
    return torch.maximum(torch.minimum(tau, torque_limit), -torque_limit)


def solve_operands(model: RobotModel, dt: float, qpos, qvel, targets, kp_eff, kd_eff,
                   torque_limit, mass_scale, fric, cstiff, coff, comp, lam0,
                   max_depen_vel: float = 1.0):
    """One substep's PD torques and the contact solve's operands, built with
    the generic batched physics (the TPU fallback's compute_dynamics /
    build_contact_setup / joint_limit_bounds) and permuted into the
    solver-internal DOF order [left leg, right leg, base] that the kernel
    and `solve.fused_solve` use. Returns (tau, [Mt, Jt, qvel, rhs, target,
    sign, mu, comp, lam0])."""
    n = qpos.shape[0]
    tau = pd_torques(qpos, qvel, targets, kp_eff, kd_eff, torque_limit)
    implicit_d = (kd_eff + model.dof_damping).expand(n, -1)
    k = fk(model, qpos)
    mask = ancestor_mask(model)
    M = mass_matrix(model, k, mask, mass_scale)
    h = bias_forces_explicit(model, qpos, qvel, k, mask, mass_scale)
    dq = qvel[:, 6:]
    tau_fric = -model.dof_friction * torch.tanh(dq / 0.05) - model.dof_damping * dq
    gen_force = torch.cat([torch.zeros_like(qvel[:, :6]), tau + tau_fric], dim=1)
    setup = build_contact_setup(
        model, Dyn(k=k, M=M, Mtilde_chol=None, h=h), flat_height_fn, dt,
        contact_offset=coff, max_depen_vel=max_depen_vel, baumgarte=0.2 * cstiff,
    )
    sign_l, lb = joint_limit_bounds(model, qpos, dt)
    D = torch.cat([torch.zeros_like(qvel[:, :6]), implicit_d], dim=1)
    Mt = M + dt * torch.diag_embed(D)
    target = torch.zeros((n, 3 * N_POINTS + NJ), device=qpos.device, dtype=qpos.dtype)
    target[:, 2:3 * N_POINTS:3] = setup.lo_bound
    target[:, 3 * N_POINTS:] = lb
    sign = torch.ones_like(target)
    sign[:, 3 * N_POINTS:] = sign_l
    rhs = dt * (gen_force - h)
    return tau, [
        Mt[:, PERM][:, :, PERM].contiguous(),
        setup.J.transpose(1, 2)[:, PERM].contiguous(),
        qvel[:, PERM].contiguous(),
        rhs[:, PERM].contiguous(),
        target, sign, fric.contiguous(), comp.contiguous(), lam0.contiguous(),
    ]


def mega_step_plain(model: RobotModel, dt: float, decimation: int, kp, kd, torque_limit,
                    iterations: int, max_depen_vel: float,
                    qpos, qvel, fric, bms, cstiff, coff, kps, kds, comp, lam0, targets):
    """Plain version of the mega kernel: a batched port of the TPU
    package's single-env fallback `step` (mega_kernel.py:1669-1774) —
    generic dynamics, contact and limit rows, integration, impulse sums and
    the end-of-step FK rows — whose contact solve is the kernel's own solve
    stage (`solve.fused_solve_plain`) in the kernel's DOF order. The APGD
    step bound ||B B^T||_inf depends on the DOF order (the TPU package's
    tests/test_fused_core_opt.py:122-127), so at the main path's 8
    iterations the fallback's order and the kernel's order follow different
    iterates (measured qvel ~1e-2 apart after one policy step); the two
    agree at convergence."""
    n = qpos.shape[0]
    kp_eff = kp * kps[:, None]
    kd_eff = kd * kds[:, None]
    mass_scale = torch.ones((n, model.nbody), device=qpos.device, dtype=qpos.dtype)
    mass_scale[:, 0] = bms
    tau = ff = None
    lam = lam0
    for _ in range(decimation):
        tau, ops = solve_operands(model, dt, qpos, qvel, targets, kp_eff, kd_eff, torque_limit,
                                  mass_scale, fric, cstiff, coff, comp, lam, max_depen_vel)
        qvel_i, lam = fused_solve_plain(*ops, iterations=iterations)
        qvel_new = qvel_i[:, INV_PERM]
        vj = torch.maximum(torch.minimum(qvel_new[:, 6:], model.dof_vel_limit), -model.dof_vel_limit)
        qvel = torch.cat([qvel_new[:, :6], vj], dim=1)
        pos_new = qpos[:, 0:3] + dt * qvel[:, 0:3]
        quat_new = S.quat_integrate(qpos[:, 3:7], qvel[:, 3:6], dt)
        qpos = torch.cat([pos_new, quat_new, qpos[:, 7:] + dt * vj], dim=1)
        imp = lam[:, : 3 * N_POINTS].reshape(n, 2, N_POINTS // 2, 3)
        ff = imp.sum(dim=2).reshape(n, 6)  # foot-major: L points first, then R
    k_f = fk(model, qpos)
    bv = body_velocities(model, qpos, qvel, k_f)
    fidx = list(model.feet_body_idx)
    kidx = list(model.knee_body_idx)
    p_rel = k_f.p - qpos[:, None, :3]
    fk14 = torch.cat(
        [
            p_rel[:, fidx, 0], p_rel[:, fidx, 1], p_rel[:, fidx, 2],
            p_rel[:, kidx, 0], p_rel[:, kidx, 1],
            bv.v_origin[:, fidx, 0], bv.v_origin[:, fidx, 1],
        ],
        dim=1,
    )
    return qpos, qvel, lam, tau, ff, fk14


def make_mega_step_batched(
    model: RobotModel,
    dt: float,
    decimation: int,
    kp,
    kd,
    torque_limit,
    iterations: int,
    max_depen_vel: float = 1.0,
):
    """Whole-policy-step physics over a batch of envs.

    Signature: (qpos, qvel, friction, base_mass_scale, contact_stiffness,
    contact_offset, kp_scale, kd_scale, contact_compliance, lam0 (N,60),
    targets) -> (qpos_new, qvel_new, lam, tau, ff, fk14). CUDA tensors run
    the kernel; CPU tensors run `mega_step_plain`."""
    check_mega_topology(model)
    consts = pack_model_constants(model, kp, kd, torque_limit)
    dev = model.device
    kp_t = torch.as_tensor(kp, dtype=torch.float32, device=dev)
    kd_t = torch.as_tensor(kd, dtype=torch.float32, device=dev)
    tl_t = torch.as_tensor(torque_limit, dtype=torch.float32, device=dev)

    def step(qpos, qvel, fric, bms, cstiff, coff, kps, kds, comp, lam0, targets):
        if qpos.is_cuda:
            packed = pack_inputs(qpos, qvel, fric, bms, cstiff, coff, kps, kds, comp, lam0, targets)
            out = mega_kernel_launch(packed, consts, dt, decimation, iterations, max_depen_vel)
            return unpack_outputs(out)
        return mega_step_plain(
            model, dt, decimation, kp_t, kd_t, tl_t, iterations, max_depen_vel,
            qpos, qvel, fric, bms, cstiff, coff, kps, kds, comp, lam0, targets,
        )

    step.consts = consts
    return step
