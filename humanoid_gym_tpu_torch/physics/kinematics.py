"""Forward kinematics, body velocities, and point Jacobians, batched.

Port of humanoid_gym_tpu/physics/kinematics.py. Every function takes the
env axis first: qpos (N, nq), qvel (N, nv). The 13-body tree is walked in
Python, so each call is a short chain of small batched tensor ops. Float32
matmuls must run in full precision (see `use_full_f32_matmul`).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import spatial as S
from .model import RobotModel


def use_full_f32_matmul() -> None:
    """Turn TF32 off for float32 matmuls and convolutions. The JAX reference
    runs its physics matmuls at HIGHEST precision; TF32 keeps ~3 decimal
    digits, which a 1 kHz integration cannot afford."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class FK(NamedTuple):
    R: torch.Tensor  # (N,nb,3,3) body frame rotation (world)
    p: torch.Tensor  # (N,nb,3) body frame origin (world)
    com: torch.Tensor  # (N,nb,3) body COM (world)
    axis_w: torch.Tensor  # (N,nj,3) world joint axes
    pivot_w: torch.Tensor  # (N,nj,3) world joint origins


def fk(model: RobotModel, qpos: torch.Tensor) -> FK:
    """qpos: (N, nq) = [pos(3), quat wxyz(4), q_joints(nj)]."""
    base_p = qpos[:, 0:3]
    base_R = S.quat_to_mat(qpos[:, 3:7])
    qj = qpos[:, 7:]
    Rs = [base_R]
    ps = [base_p]
    axes = []
    pivots = []
    for i, parent in enumerate(model.body_parent[1:]):
        Rp, pp = Rs[parent], ps[parent]
        Rj = Rp @ model.joint_rot[i]
        pj = (Rp @ model.joint_pos[i][:, None])[..., 0] + pp
        a = model.joint_axis[i]
        q = S.quat_from_axis_angle(a, qj[:, i])
        Rs.append(Rj @ S.quat_to_mat(q))
        ps.append(pj)
        axes.append((Rj @ a[:, None])[..., 0])
        pivots.append(pj)
    R = torch.stack(Rs, dim=1)
    p = torch.stack(ps, dim=1)
    com = p + torch.einsum("nbij,bj->nbi", R, model.body_com)
    return FK(R=R, p=p, com=com, axis_w=torch.stack(axes, 1), pivot_w=torch.stack(pivots, 1))


class BodyVel(NamedTuple):
    omega: torch.Tensor  # (N,nb,3) world angular velocity
    v_origin: torch.Tensor  # (N,nb,3) world linear velocity of body frame origin
    v_com: torch.Tensor  # (N,nb,3) world linear velocity of body COM


def body_velocities(
    model: RobotModel, qpos: torch.Tensor, qvel: torch.Tensor, k: FK | None = None
) -> BodyVel:
    """Propagate spatial velocities down the tree.
    qvel layout: [v_base_world(3), omega_base_world(3), qdot_joints(nj)]."""
    if k is None:
        k = fk(model, qpos)
    omegas = [qvel[:, 3:6]]
    v_orig = [qvel[:, 0:3]]
    for i, parent in enumerate(model.body_parent[1:]):
        w_p = omegas[parent]
        v_p = v_orig[parent]
        v_o = v_p + torch.linalg.cross(w_p, k.pivot_w[:, i] - k.p[:, parent], dim=-1)
        w_b = w_p + k.axis_w[:, i] * qvel[:, 6 + i : 7 + i]
        omegas.append(w_b)
        v_orig.append(v_o)
    omega = torch.stack(omegas, 1)
    v_origin = torch.stack(v_orig, 1)
    v_com = v_origin + torch.linalg.cross(omega, k.com - k.p, dim=-1)
    return BodyVel(omega=omega, v_origin=v_origin, v_com=v_com)


class DofBasis(NamedTuple):
    """Per-DOF screw data: for DOF column c and a world point x on a body
    that c moves, angular = ang[c], linear = ang[c] x (x - pivot[c]) + lin[c]."""

    ang: torch.Tensor  # (N,nv,3)
    lin: torch.Tensor  # (N,nv,3)
    pivot: torch.Tensor  # (N,nv,3)


def dof_basis(model: RobotModel, k: FK) -> DofBasis:
    n = k.p.shape[0]
    dev, dt_ = k.p.device, k.p.dtype
    eye3 = torch.eye(3, device=dev, dtype=dt_).expand(n, 3, 3)
    z3 = torch.zeros((n, 3, 3), device=dev, dtype=dt_)
    ang = torch.cat([z3, eye3, k.axis_w], dim=1)
    lin = torch.cat([eye3, z3, torch.zeros((n, model.nj, 3), device=dev, dtype=dt_)], dim=1)
    pivot = torch.cat([z3, k.p[:, 0:1].expand(n, 3, 3), k.pivot_w], dim=1)
    return DofBasis(ang=ang, lin=lin, pivot=pivot)


def ancestor_mask(model: RobotModel) -> torch.Tensor:
    """(nb, nv) static 0/1 mask: which DOF columns move each body."""
    nb, nv = model.nbody, model.nv
    m = np.zeros((nb, nv), dtype=np.float32)
    m[:, :6] = 1.0  # free base moves everything
    for b in range(1, nb):
        cur = b
        while cur != 0:
            m[b, 6 + cur - 1] = 1.0  # joint i moves body i+1
            cur = model.body_parent[cur]
    return torch.as_tensor(m, device=model.device)


def point_jacobian(basis: DofBasis, mask_row: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Linear-velocity Jacobians (N, K, 3, nv) of world points x (N, K, 3);
    mask_row (K, nv) is each point's body ancestor mask."""
    ang = basis.ang[:, None]  # (N,1,nv,3)
    rel = x[:, :, None, :] - basis.pivot[:, None]  # (N,K,nv,3)
    lin = torch.linalg.cross(ang.expand_as(rel), rel, dim=-1) + basis.lin[:, None]
    return (lin * mask_row[None, :, :, None]).transpose(-1, -2)


def body_jacobians(model: RobotModel, k: FK, mask: torch.Tensor):
    """Full 6D Jacobians at body COMs: (J_ang, J_lin), each (N, nb, 3, nv)."""
    basis = dof_basis(model, k)
    rel = k.com[:, :, None, :] - basis.pivot[:, None, :, :]  # (N,nb,nv,3)
    ang = basis.ang[:, None].expand_as(rel)
    lin = torch.linalg.cross(ang, rel, dim=-1) + basis.lin[:, None]
    m = mask[None, :, :, None]
    return (ang * m).transpose(-1, -2), (lin * m).transpose(-1, -2)
