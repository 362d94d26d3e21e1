"""Whole-policy-step physics: the CUDA mega kernel and its plain version.

Port of humanoid_gym_tpu/physics/mega_kernel.py. One call runs all
`decimation` 1 kHz substeps (PD, FK, bias forces, CRBA mass matrix, contact
and joint-limit rows, the contact solve, integration) for every env and
returns the six outputs of `make_mega_step_batched`:

  qpos (19), qvel (18), lam (60, physical signs), tau (12),
  ff (6, per-foot world-frame impulse sums), fk14 (14, end-of-step
  feet/knee kinematics: [fLx,fRx, fLy,fRy, fLz,fRz, kLx,kRx, kLy,kRy,
  vLx,vRx, vLy,vRy], positions base-relative, feet v_origin world-frame).

A CUDA tensor goes to the kernel (csrc/mega.cu: one warp per env with the
env's state in that warp's shared memory, all substeps in one launch,
env-major (N, 120) in / (N, 136) out in the `IN_*` / `OUT_*` row layout of
the TPU kernel; the model's 541 constants, `CONST_LAYOUT`, by pointer to a
device tensor each launch names, as the TPU kernel takes them as an input
block, so launches of two robots need nothing between them). A CPU tensor
goes to
`mega_step_plain`, a batched port of the TPU package's single-env
fallback `step` (mega_kernel.py:1669-1774) with the kernel's own solve
stage.

On a heightfield (`terrain_map`) both take a second input of `IN2_ROWS`
rows per env, built once per policy step by `terrain_patches` from the
step-start state (mega_kernel.py:1575-1664): per contact point the 3 x 3
node patch of the grid (meters) around its step-start node, the patch
origin, and the step-start slope plus the contact-slope DR bias. Every
substep then looks the ground up bilinearly inside that patch (a point
that moved more than a cell clamps to the patch edge), measures the gap
along the sloped normal, projects its J rows onto (t1, t2, n), and the
per-foot impulse sums come back in the world frame. The CUDA kernel is the
`TERRAIN` instantiation of the same template (`hgt_mega_kernel<true>`);
on a CUDA tensor a terrain step launches it or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from ..terrain.terrain import TerrainMap, flat_height_fn, grid_tensor
from . import spatial as S
from .contact import build_contact_setup, joint_limit_bounds, world_impulses
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
# terrain second input (mega_kernel.py:90-100): per contact point k the 3x3
# node patch, tap-major at row (i*3+j)*16 + k, node (ox+i, oy+j), in meters;
# the patch origin ox / oy (grid units); the step-start slope gx / gy
# (dh/dx, dh/dy) with the slope DR bias added
IN2_PMIN = 0
IN2_OX = 9 * N_POINTS
IN2_OY = 10 * N_POINTS
IN2_GX = 11 * N_POINTS
IN2_GY = 12 * N_POINTS
IN2_ROWS = 13 * N_POINTS  # 208
# external DOF order [base 0:6, left leg 6:12, right leg 12:18] -> the
# solver-internal order [left leg, right leg, base], and back
PERM = list(range(6, 18)) + list(range(6))
INV_PERM = [PERM.index(i) for i in range(NV)]

# model-constant layout: (name, length); offsets must match csrc/mega.cu
CONST_LAYOUT = (
    ("mass", 13), ("com", 39), ("inertia", 117), ("jpos", 36), ("jrot", 108),
    ("jaxis", 36), ("coff", 48), ("kp", 12), ("kd", 12), ("tlim", 12),
    ("low", 12), ("up", 12), ("vlim", 12), ("jfric", 12), ("jdamp", 12),
    ("arm", 12), ("grav", 3), ("parent", 13), ("cbody", 16), ("feet", 2),
    ("knee", 2),
)
CONST_COUNT = sum(n for _, n in CONST_LAYOUT)  # 541

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
    """The kernel's model-constant block (CONST_LAYOUT order), float32."""
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


def terrain_constants(tmap: TerrainMap):
    """(border, 1 / horizontal_scale, nrow - 1.001, ncol - 1.001): the
    launch constants of the terrain variant (the clip of the grid
    coordinate, as `make_contact_height_fn` clips it)."""
    nrow, ncol = tmap.height_field.shape
    return (float(tmap.border_size), 1.0 / float(tmap.horizontal_scale), nrow - 1.001,
            ncol - 1.001)


def model_constants_tensor(consts: np.ndarray, device) -> torch.Tensor:
    """The (CONST_COUNT,) float32 blob of `pack_model_constants` as the
    contiguous tensor on `device` that a kernel launch reads."""
    return torch.as_tensor(np.ascontiguousarray(consts, np.float32), device=device).contiguous()


def mega_kernel_launch(packed: torch.Tensor, consts: torch.Tensor, dt: float, decimation: int,
                       iterations: int, max_depen_vel: float, packed2: torch.Tensor | None = None,
                       terrain=None) -> torch.Tensor:
    """Launch the mega kernel on (N, 120) CUDA rows; returns (N, 136) rows.
    `consts` is the model's (CONST_COUNT,) float32 constants on the device
    of `packed` (`model_constants_tensor`): the launch reads them from
    there, so launches of different models need no upload between them.
    With `terrain` (the 4 floats of `terrain_constants`) and `packed2`
    (N, IN2_ROWS) the terrain variant runs. Counts flat launches in
    `mega_kernel_launch.launches`, terrain launches in
    `mega_kernel_launch.terrain_launches`."""
    if not packed.is_cuda:
        raise ValueError("mega_kernel_launch takes CUDA tensors")
    if packed.dtype != torch.float32 or packed.dim() != 2 or packed.shape[1] != IN_ROWS \
            or not packed.is_contiguous():
        raise ValueError(f"packed inputs must be contiguous float32 (N, {IN_ROWS})")
    if not isinstance(consts, torch.Tensor) or consts.device != packed.device \
            or consts.dtype != torch.float32 or tuple(consts.shape) != (CONST_COUNT,) \
            or not consts.is_contiguous():
        raise ValueError(f"model constants must be a contiguous float32 ({CONST_COUNT},) tensor on "
                         f"the device of packed")
    if (terrain is None) != (packed2 is None):
        raise ValueError("the terrain variant takes both packed2 and terrain")
    if packed2 is not None and (
            packed2.device != packed.device or packed2.dtype != torch.float32
            or tuple(packed2.shape) != (packed.shape[0], IN2_ROWS) or not packed2.is_contiguous()):
        raise ValueError(f"packed2 must be contiguous float32 (N, {IN2_ROWS}) on the device of packed")
    lib = kernel_library()
    if lib.lib.hgt_const_count() != CONST_COUNT:
        raise RuntimeError("csrc/mega.cu constant layout disagrees with CONST_LAYOUT")
    n = packed.shape[0]
    out = torch.empty((n, OUT_ROWS), device=packed.device, dtype=torch.float32)
    stream = torch.cuda.current_stream(packed.device).cuda_stream
    if terrain is None:
        err = lib.lib.hgt_mega_step(
            packed.data_ptr(), consts.data_ptr(), out.data_ptr(), n, float(dt), int(decimation),
            int(iterations), float(max_depen_vel), stream,
        )
        check(err, "hgt_mega_step launch")
        mega_kernel_launch.launches += 1
    else:
        err = lib.lib.hgt_mega_step_terrain(
            packed.data_ptr(), packed2.data_ptr(), consts.data_ptr(), out.data_ptr(), n, float(dt),
            int(decimation), int(iterations), float(max_depen_vel), *[float(t) for t in terrain],
            stream,
        )
        check(err, "hgt_mega_step_terrain launch")
        mega_kernel_launch.terrain_launches += 1
    return out


mega_kernel_launch.launches = 0
mega_kernel_launch.terrain_launches = 0


def make_contact_xy(model: RobotModel):
    """contact_xy(qpos (N, nq)) -> (N, K, 2): the world xy of the sole
    contact points, specialized to the two 6-joint leg chains (the TPU
    package's `make_contact_xy_batched`, mega_kernel.py:475): both legs walk
    their chains together as a leading axis of 2, the joint rotations of all
    12 joints are formed at once (Rodrigues about the unit axis), and the
    points are placed base-relative before the base position is added, as
    the kernel places them. About 110 tensor operations (views included)
    where the generic `fk` takes about 700."""
    check_mega_topology(model)
    depth = model.nj // 2
    legs = torch.arange(model.nj, device=model.device).reshape(2, depth)  # joints of each chain
    axis = model.joint_axis / torch.linalg.norm(model.joint_axis, dim=1, keepdim=True)
    zero = torch.zeros_like(axis[:, 0])
    K = torch.stack([torch.stack([zero, -axis[:, 2], axis[:, 1]], -1),
                     torch.stack([axis[:, 2], zero, -axis[:, 0]], -1),
                     torch.stack([-axis[:, 1], axis[:, 0], zero], -1)], dim=1)  # (nj, 3, 3)
    K2 = K @ K
    jrot, jpos = model.joint_rot[legs], model.joint_pos[legs]  # (2, depth, 3, 3), (2, depth, 3)
    half = N_POINTS // 2
    offs = model.contact_point_offset.reshape(2, half, 3)  # L points first (check_mega_topology)

    def contact_xy(qpos: torch.Tensor) -> torch.Tensor:
        n = qpos.shape[0]
        q = qpos[:, 7:7 + model.nj]
        Rot = (torch.eye(3, device=q.device, dtype=q.dtype) + torch.sin(q)[..., None, None] * K
               + (1.0 - torch.cos(q))[..., None, None] * K2)  # (N, nj, 3, 3)
        Rot = Rot[:, legs]  # (N, 2, depth, 3, 3)
        R = S.quat_to_mat(qpos[:, 3:7])[:, None].expand(n, 2, 3, 3)
        p = torch.zeros((n, 2, 3), device=q.device, dtype=q.dtype)
        for d in range(depth):
            p = (R @ jpos[:, d, :, None])[..., 0] + p
            R = R @ jrot[:, d] @ Rot[:, :, d]
        pts = torch.einsum("nlij,lkj->nlki", R, offs) + p[:, :, None]  # (N, 2, half, 3)
        return pts.reshape(n, N_POINTS, 3)[..., :2] + qpos[:, None, :2]

    return contact_xy


def make_terrain_patches(model: RobotModel, tmap: TerrainMap):
    """terrain_patches(qpos (N, nq), slope_bias (N, 2)) -> (N, IN2_ROWS):
    the values of the TPU package's `terrain_patches`
    (mega_kernel.py:1575-1664) from direct gathers on the grid. From the
    step-start contact points' xy (`make_contact_xy`): node (px, py) = the floor of the
    clipped grid coordinate; the 3x3 node patch at ox = clip(px - 1, 0,
    nrow - 3), oy likewise, in meters; the slope of the bilinear cell at
    (px, py) plus the bias."""
    hf = grid_tensor(tmap, model.device, scaled=True)
    border, inv_h, gx_max, gy_max = terrain_constants(tmap)
    nrow, ncol = tmap.height_field.shape
    contact_xy = make_contact_xy(model)

    def terrain_patches(qpos: torch.Tensor, slope_bias: torch.Tensor) -> torch.Tensor:
        xy = contact_xy(qpos)
        gxf = torch.clamp((xy[..., 0] + border) * inv_h, 0.0, gx_max)
        gyf = torch.clamp((xy[..., 1] + border) * inv_h, 0.0, gy_max)
        px = gxf.to(torch.int64)
        py = gyf.to(torch.int64)
        ox = torch.clamp(px - 1, 0, nrow - 3)
        oy = torch.clamp(py - 1, 0, ncol - 3)
        taps = [hf[ox + i, oy + j] for i in range(3) for j in range(3)]
        h00, h10 = hf[px, py], hf[px + 1, py]
        h01, h11 = hf[px, py + 1], hf[px + 1, py + 1]
        fx = gxf - px
        fy = gyf - py
        gx = ((h10 - h00) * (1 - fy) + (h11 - h01) * fy) * inv_h + slope_bias[:, 0:1]
        gy = ((h01 - h00) * (1 - fx) + (h11 - h10) * fx) * inv_h + slope_bias[:, 1:2]
        return torch.cat(taps + [ox.to(torch.float32), oy.to(torch.float32), gx, gy],
                         dim=1).contiguous()

    return terrain_patches


def patch_frames(in2: torch.Tensor) -> torch.Tensor:
    """(N, K, 3, 3) rows (t1, t2, n) from the slope rows of `in2`, with the
    kernel's arithmetic: n = (-gx, -gy, 1) rsqrt(gx^2 + gy^2 + 1), t1 =
    (n_z, 0, -n_x) rsqrt(n_z^2 + n_x^2), t2 = n x t1 (t1_y = 0)."""
    gx = in2[:, IN2_GX:IN2_GX + N_POINTS]
    gy = in2[:, IN2_GY:IN2_GY + N_POINTS]
    n_inv = torch.rsqrt(gx * gx + gy * gy + 1.0)
    nx, ny, nz = -gx * n_inv, -gy * n_inv, n_inv
    t1_inv = torch.rsqrt(nz * nz + nx * nx)
    t1x, t1z = nz * t1_inv, -nx * t1_inv
    zero = torch.zeros_like(gx)
    t1 = torch.stack([t1x, zero, t1z], dim=-1)
    t2 = torch.stack([ny * t1z, nz * t1x - nx * t1z, -ny * t1x], dim=-1)
    n = torch.stack([nx, ny, nz], dim=-1)
    return torch.stack([t1, t2, n], dim=-2)


def make_patch_height_fn(in2: torch.Tensor, terrain):
    """The kernel's ground lookup: height_fn(x, y) for the (N, K) contact
    points of the envs whose `in2` rows these are, bilinear inside each
    point's 3x3 patch with u, v (the grid coordinate relative to the patch
    origin) clipped to [0, 1.999]: a point outside its window clamps to the
    patch edge, not to the grid edge."""
    border, inv_h, gx_max, gy_max = terrain
    n = in2.shape[0]
    taps = in2[:, IN2_PMIN:IN2_PMIN + 9 * N_POINTS].reshape(n, 3, 3, N_POINTS)
    ox = in2[:, IN2_OX:IN2_OX + N_POINTS]
    oy = in2[:, IN2_OY:IN2_OY + N_POINTS]

    def height_fn(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        fx = torch.clamp((x + border) * inv_h, 0.0, gx_max)
        fy = torch.clamp((y + border) * inv_h, 0.0, gy_max)
        u = torch.clamp(fx - ox, 0.0, 1.999)
        v = torch.clamp(fy - oy, 0.0, 1.999)
        iu, iv = torch.floor(u), torch.floor(v)
        fu, fv = u - iu, v - iv
        v0 = iv == 0.0
        hy = [(1.0 - fv) * torch.where(v0, taps[:, a, 0], taps[:, a, 1])
              + fv * torch.where(v0, taps[:, a, 1], taps[:, a, 2]) for a in range(3)]
        u0 = iu == 0.0
        h_lo = torch.where(u0, hy[0], hy[1])
        h_hi = torch.where(u0, hy[1], hy[2])
        return (1.0 - fu) * h_lo + fu * h_hi

    return height_fn


def pd_torques(qpos, qvel, targets, kp, kd, torque_limit):
    """tau = kp*(target - q) - kd*qdot, clipped to +-torque_limit (N, nj)."""
    tau = kp * (targets - qpos[:, 7:]) - kd * qvel[:, 6:]
    return torch.maximum(torch.minimum(tau, torque_limit), -torque_limit)


def solve_operands(model: RobotModel, dt: float, qpos, qvel, targets, kp_eff, kd_eff,
                   torque_limit, mass_scale, fric, cstiff, coff, comp, lam0,
                   max_depen_vel: float = 1.0, height_fn=flat_height_fn, frames=None):
    """One substep's PD torques and the contact solve's operands, built with
    the generic batched physics (the TPU fallback's compute_dynamics /
    build_contact_setup / joint_limit_bounds) and permuted into the
    solver-internal DOF order [left leg, right leg, base] that the kernel
    and `solve.fused_solve` use; on terrain with the patch height function
    and the sloped frames. Returns (tau, [Mt, Jt, qvel, rhs, target, sign,
    mu, comp, lam0], setup)."""
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
        model, Dyn(k=k, M=M, Mtilde_chol=None, h=h), height_fn, dt,
        contact_offset=coff, max_depen_vel=max_depen_vel, baumgarte=0.2 * cstiff,
        frames_override=frames,
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
    ], setup


def mega_step_plain(model: RobotModel, dt: float, decimation: int, kp, kd, torque_limit,
                    iterations: int, max_depen_vel: float,
                    qpos, qvel, fric, bms, cstiff, coff, kps, kds, comp, lam0, targets,
                    in2=None, terrain=None):
    """Plain version of the mega kernel: a batched port of the TPU
    package's single-env fallback `step` (mega_kernel.py:1669-1774) —
    generic dynamics, contact and limit rows, integration, impulse sums and
    the end-of-step FK rows — whose contact solve is the kernel's own solve
    stage (`solve.fused_solve_plain`) in the kernel's DOF order. The APGD
    step bound ||B B^T||_inf depends on the DOF order (the TPU package's
    tests/test_fused_core_opt.py:122-127), so at the main path's 8
    iterations the fallback's order and the kernel's order follow different
    iterates (measured qvel ~1e-2 apart after one policy step); the two
    agree at convergence.

    With `in2` (N, IN2_ROWS) and `terrain` (`terrain_constants`) it is the
    plain version of the terrain variant and reads the same rows as the
    kernel: the ground from each point's patch (`make_patch_height_fn`),
    the frames from the slope rows (`patch_frames`), and the impulse sums
    in the world frame."""
    n = qpos.shape[0]
    kp_eff = kp * kps[:, None]
    kd_eff = kd * kds[:, None]
    mass_scale = torch.ones((n, model.nbody), device=qpos.device, dtype=qpos.dtype)
    mass_scale[:, 0] = bms
    tau = ff = None
    lam = lam0
    height_fn, frames = flat_height_fn, None
    if terrain is not None:
        height_fn, frames = make_patch_height_fn(in2, terrain), patch_frames(in2)
    for _ in range(decimation):
        # the kernel's convention: kinematics BASE-RELATIVE (base origin at
        # 0), the base position added back only where the ground is looked
        # up; at world xy of ~100 m a float32 coordinate rounds to ~1e-5 m,
        # which the Baumgarte term (0.2 / dt) would turn into ~1e-3 m/s
        base = qpos[:, 0:3]

        def height_rel(x, y, base=base):
            return height_fn(x + base[:, 0:1], y + base[:, 1:2]) - base[:, 2:3]

        qpos_rel = torch.cat([torch.zeros_like(base), qpos[:, 3:]], dim=1)
        tau, ops, setup = solve_operands(model, dt, qpos_rel, qvel, targets, kp_eff, kd_eff,
                                         torque_limit, mass_scale, fric, cstiff, coff, comp, lam,
                                         max_depen_vel, height_rel, frames)
        qvel_i, lam = fused_solve_plain(*ops, iterations=iterations)
        qvel_new = qvel_i[:, INV_PERM]
        vj = torch.maximum(torch.minimum(qvel_new[:, 6:], model.dof_vel_limit), -model.dof_vel_limit)
        qvel = torch.cat([qvel_new[:, :6], vj], dim=1)
        pos_new = qpos[:, 0:3] + dt * qvel[:, 0:3]
        quat_new = S.quat_integrate(qpos[:, 3:7], qvel[:, 3:6], dt)
        qpos = torch.cat([pos_new, quat_new, qpos[:, 7:] + dt * vj], dim=1)
        imp = world_impulses(lam, setup).reshape(n, 2, N_POINTS // 2, 3)
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
    terrain_map: TerrainMap | None = None,
):
    """Whole-policy-step physics over a batch of envs.

    Signature: (qpos, qvel, friction, base_mass_scale, contact_stiffness,
    contact_offset, kp_scale, kd_scale, contact_compliance, lam0 (N,60),
    slope_bias (N,2), targets) -> (qpos_new, qvel_new, lam, tau, ff,
    fk14). CUDA tensors run the kernel; CPU tensors run `mega_step_plain`.
    The model's constants are packed once, here: `step.consts` (NumPy) and,
    on the card, `step.consts_dev`, the tensor every launch of this step
    reads. With a `terrain_map` each call first builds the IN2 rows
    (`step.terrain_patches`, exposed as in the TPU package) and runs the
    terrain variant; slope_bias is read only there."""
    check_mega_topology(model)
    consts = pack_model_constants(model, kp, kd, torque_limit)
    dev = model.device
    consts_dev = model_constants_tensor(consts, dev) if dev.type == "cuda" else None
    kp_t = torch.as_tensor(kp, dtype=torch.float32, device=dev)
    kd_t = torch.as_tensor(kd, dtype=torch.float32, device=dev)
    tl_t = torch.as_tensor(torque_limit, dtype=torch.float32, device=dev)
    terrain = terrain_patches = None
    if terrain_map is not None:
        terrain = terrain_constants(terrain_map)
        terrain_patches = make_terrain_patches(model, terrain_map)

    def step(qpos, qvel, fric, bms, cstiff, coff, kps, kds, comp, lam0, slope_bias, targets):
        in2 = terrain_patches(qpos, slope_bias) if terrain is not None else None
        if qpos.is_cuda:
            packed = pack_inputs(qpos, qvel, fric, bms, cstiff, coff, kps, kds, comp, lam0, targets)
            out = mega_kernel_launch(packed, consts_dev, dt, decimation, iterations,
                                     max_depen_vel, packed2=in2, terrain=terrain)
            return unpack_outputs(out)
        return mega_step_plain(
            model, dt, decimation, kp_t, kd_t, tl_t, iterations, max_depen_vel,
            qpos, qvel, fric, bms, cstiff, coff, kps, kds, comp, lam0, targets,
            in2=in2, terrain=terrain,
        )

    step.consts = consts
    step.consts_dev = consts_dev
    step.terrain = terrain
    if terrain_patches is not None:
        step.terrain_patches = terrain_patches
    return step
