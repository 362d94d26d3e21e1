"""Joint-space dynamics: mass matrix, bias forces, free-velocity solve.

Port of humanoid_gym_tpu/physics/dynamics.py, batched over a leading env
axis:

  M(q) qacc + h(q, v) = S tau + J_c^T f_c

- M = sum_b J_b^T I_b J_b over COM-frame world-axis Jacobians.
- h by explicit velocity / bias-acceleration propagation down the tree
  (`bias_forces_explicit`, the hot path), or by forward-mode AD of the
  body-velocity function (`bias_forces`, the JAX package's derivation,
  which the tests hold the explicit form against).
- Joint damping (URDF + PD kd) is implicit: Mtilde = M + dt * diag(D).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import spatial as S
from .kinematics import FK, ancestor_mask, body_jacobians, body_velocities, fk
from .linalg import chol_unrolled, solve_spd_chol
from .model import RobotModel


def qpos_derivative(qpos: torch.Tensor, qvel: torch.Tensor) -> torch.Tensor:
    """Time derivative (N, nq) of qpos given qvel (N, nv): the base
    quaternion's by 0.5 * omega (x) q."""
    dquat = S.quat_derivative(qpos[:, 3:7], qvel[:, 3:6])
    return torch.cat([qvel[:, 0:3], dquat, qvel[:, 6:]], dim=-1)


def world_inertias(model: RobotModel, k: FK, mass_scale: torch.Tensor):
    """Per-body world-frame rotational inertia about COM (N,nb,3,3) and
    scaled masses (N,nb). mass_scale: (N, nb) multiplicative DR."""
    I_w = torch.einsum("nbij,bjk,nblk->nbil", k.R, model.body_inertia, k.R)
    return I_w * mass_scale[:, :, None, None], model.body_mass * mass_scale


def mass_matrix(model: RobotModel, k: FK, mask: torch.Tensor, mass_scale: torch.Tensor) -> torch.Tensor:
    """Dense (N, nv, nv) mass matrix."""
    J_ang, J_lin = body_jacobians(model, k, mask)
    I_w, m = world_inertias(model, k, mass_scale)
    M_rot = torch.einsum("nbiv,nbij,nbjw->nvw", J_ang, I_w, J_ang)
    M_lin = torch.einsum("nb,nbiv,nbiw->nvw", m, J_lin, J_lin)
    arm = torch.cat([torch.zeros(6, device=m.device, dtype=m.dtype), model.dof_armature])
    return M_rot + M_lin + torch.diag(arm)


def bias_forces(
    model: RobotModel,
    qpos: torch.Tensor,
    qvel: torch.Tensor,
    k: FK,
    mask: torch.Tensor,
    mass_scale: torch.Tensor,
) -> torch.Tensor:
    """h(q,v) = C(q,v) v + g(q), (N, nv), by AD: the bias accelerations
    (qacc = 0) are the directional derivative of the body velocities along
    qdot (`torch.func.jvp`), plus the gyroscopic torque omega x I omega."""
    qdot = qpos_derivative(qpos, qvel)
    bv, bacc = torch.func.jvp(lambda qp: body_velocities(model, qp, qvel), (qpos,), (qdot,))
    I_w, m = world_inertias(model, k, mass_scale)
    f_ang = torch.einsum("nbij,nbj->nbi", I_w, bacc.omega) + torch.linalg.cross(
        bv.omega, torch.einsum("nbij,nbj->nbi", I_w, bv.omega), dim=-1
    )
    f_lin = m[:, :, None] * (bacc.v_com - model.gravity)
    J_ang, J_lin = body_jacobians(model, k, mask)
    return torch.einsum("nbiv,nbi->nv", J_ang, f_ang) + torch.einsum(
        "nbiv,nbi->nv", J_lin, f_lin
    )


def bias_forces_explicit(
    model: RobotModel,
    qpos: torch.Tensor,
    qvel: torch.Tensor,
    k: FK,
    mask: torch.Tensor,
    mass_scale: torch.Tensor,
) -> torch.Tensor:
    """h(q,v) (N, nv) by world-frame recursion with qacc=0:
      omega_b = omega_p + a_w qd        alpha_b = alpha_p + (omega_p x a_w) qd
      v_b = v_p + omega_p x r           a_b = a_p + alpha_p x r + omega_p x (omega_p x r)
    """
    cross = lambda a, b: torch.linalg.cross(a, b, dim=-1)  # noqa: E731
    z = torch.zeros_like(qvel[:, 0:3])
    omegas, alphas = [qvel[:, 3:6]], [z]
    v_orig, a_orig = [qvel[:, 0:3]], [z]
    for i, parent in enumerate(model.body_parent[1:]):
        w_p, al_p = omegas[parent], alphas[parent]
        v_p, a_p = v_orig[parent], a_orig[parent]
        r = k.pivot_w[:, i] - k.p[:, parent]
        wxr = cross(w_p, r)
        a_w = k.axis_w[:, i]
        qd = qvel[:, 6 + i : 7 + i]
        omegas.append(w_p + a_w * qd)
        alphas.append(al_p + cross(w_p, a_w) * qd)
        v_orig.append(v_p + wxr)
        a_orig.append(a_p + cross(al_p, r) + cross(w_p, wxr))
    omega = torch.stack(omegas, 1)
    alpha = torch.stack(alphas, 1)
    a_o = torch.stack(a_orig, 1)
    rc = k.com - k.p
    a_com = a_o + cross(alpha, rc) + cross(omega, cross(omega, rc))

    I_w, m = world_inertias(model, k, mass_scale)
    f_ang = torch.einsum("nbij,nbj->nbi", I_w, alpha) + cross(
        omega, torch.einsum("nbij,nbj->nbi", I_w, omega)
    )
    f_lin = m[:, :, None] * (a_com - model.gravity)
    J_ang, J_lin = body_jacobians(model, k, mask)
    return torch.einsum("nbiv,nbi->nv", J_ang, f_ang) + torch.einsum(
        "nbiv,nbi->nv", J_lin, f_lin
    )


class Dyn(NamedTuple):
    k: FK
    M: torch.Tensor  # (N,nv,nv) without implicit damping
    Mtilde_chol: torch.Tensor  # (N,nv,nv) cholesky of M + dt*D
    h: torch.Tensor  # (N,nv)


def compute_dynamics(
    model: RobotModel,
    qpos: torch.Tensor,
    qvel: torch.Tensor,
    dt: float,
    implicit_damping: torch.Tensor,  # (N,nj) kd gains + URDF damping
    mass_scale: torch.Tensor,  # (N,nb)
    factor: bool = True,
) -> Dyn:
    """factor=False leaves Mtilde_chol None, for a caller whose solver
    factors Mtilde itself."""
    k = fk(model, qpos)
    mask = ancestor_mask(model)
    M = mass_matrix(model, k, mask, mass_scale)
    h = bias_forces_explicit(model, qpos, qvel, k, mask, mass_scale)
    if not factor:
        return Dyn(k=k, M=M, Mtilde_chol=None, h=h)
    D = torch.cat([torch.zeros_like(implicit_damping[:, :6]), implicit_damping], dim=1)
    Mt = M + dt * torch.diag_embed(D)
    return Dyn(k=k, M=M, Mtilde_chol=chol_unrolled(Mt), h=h)


def solve_mtilde(chol: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Solve (M + dt D) x = rhs via the cached Cholesky factor."""
    return solve_spd_chol(chol, rhs)
