"""Batched contact + joint-limit rows and the APGD contact solve.

Port of the parts of humanoid_gym_tpu/physics/contact.py that the mega
solver's plain path runs: `build_contact_setup`, `joint_limit_bounds`,
`_project_cone` and `apgd_solve`. Everything takes the env axis first.

Unilateral normal rows obey v_n+ >= b complementary to lambda_n >= 0, with
PhysX-like depenetration: approach-limited within contact_offset of the
ground, Baumgarte push-out capped by max_depen_vel when penetrating. One
unilateral row per joint enforces the position limits. Activity is carried
by the bounds (-1e9 = inactive), never by shapes.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .dynamics import Dyn
from .kinematics import ancestor_mask, dof_basis, point_jacobian
from .model import RobotModel


class ContactSetup(NamedTuple):
    J: torch.Tensor  # (N, nrow, nv) stacked constraint Jacobian
    lo_bound: torch.Tensor  # (N, K) velocity lower bound per normal row
    phi: torch.Tensor  # (N, K) signed gap of force-solved points
    pos_w: torch.Tensor  # (N, K, 3) world candidate positions


def build_contact_setup(
    model: RobotModel,
    dyn: Dyn,
    terrain_height_fn,
    dt: float,
    contact_offset=0.01,
    baumgarte=0.2,
    max_depen_vel: float = 1.0,
) -> ContactSetup:
    """contact_offset and baumgarte are floats or (N,) per-env tensors."""
    k = dyn.k
    n = k.p.shape[0]
    mask = ancestor_mask(model)
    basis = dof_basis(model, k)

    body_idx = list(model.contact_point_body)
    offs = model.contact_point_offset  # (K,3)
    Rb = k.R[:, body_idx]
    pb = k.p[:, body_idx]
    pos = pb + torch.einsum("nkij,kj->nki", Rb, offs)  # (N,K,3)
    ground = terrain_height_fn(pos[..., 0], pos[..., 1])
    phi = pos[..., 2] - ground

    Jpts = point_jacobian(basis, mask[body_idx], pos)  # (N,K,3,nv)

    coff = torch.as_tensor(contact_offset, dtype=phi.dtype, device=phi.device)
    bmg = torch.as_tensor(baumgarte, dtype=phi.dtype, device=phi.device)
    if coff.dim():
        coff = coff[:, None]
    if bmg.dim():
        bmg = bmg[:, None]
    inactive = phi > coff
    b_pen = torch.clamp(bmg * (-phi) / dt, max=max_depen_vel)
    b_gap = -phi / dt
    lo = torch.where(phi <= 0.0, b_pen, b_gap)
    lo = torch.where(inactive, torch.full_like(lo, -1e9), lo)

    K = pos.shape[1]
    qj_rows = torch.eye(model.nv, device=phi.device, dtype=phi.dtype)[6:].expand(n, model.nj, model.nv)
    J = torch.cat([Jpts.reshape(n, 3 * K, model.nv), qj_rows], dim=1)
    return ContactSetup(J=J, lo_bound=lo, phi=phi, pos_w=pos)


def joint_limit_bounds(
    model: RobotModel,
    qpos: torch.Tensor,
    dt: float,
    baumgarte: float = 0.2,
    max_depen_vel: float = 2.0,
    margin: float = 0.05,
):
    """Per-joint unilateral bound (N, nj): sign * qdot+ >= b. sign=+1
    enforces the lower limit, sign=-1 the upper."""
    qj = qpos[:, 7:]
    mid = 0.5 * (model.dof_lower + model.dof_upper)
    near_lower = qj < mid
    sign = torch.where(near_lower, 1.0, -1.0).to(qj.dtype)
    viol = torch.where(near_lower, model.dof_lower - qj, qj - model.dof_upper)
    b_pen = torch.clamp(baumgarte * viol / dt, max=max_depen_vel)
    b_gap = viol / dt
    b = torch.where(viol >= 0.0, b_pen, b_gap)
    b = torch.where(viol < -margin, torch.full_like(b, -1e9), b)
    return sign, b


def _project_cone(lam: torch.Tensor, n_points: int, mu: torch.Tensor, limit_sign: torch.Tensor):
    """Project stacked impulses (N, nrow) onto friction cones (the 3D
    contact blocks, (tx, ty, n)) and signed half-lines (limit rows).
    mu: (N,)."""
    n = lam.shape[0]
    blocks = lam[:, : 3 * n_points].reshape(n, n_points, 3)
    t = blocks[..., :2]
    nn_ = blocks[..., 2]
    mu_ = mu[:, None]
    nt = torch.linalg.norm(t, dim=-1)
    inside = nt <= mu_ * nn_
    polar = mu_ * nt <= -nn_
    n_proj = torch.clamp((mu_ * nt + nn_) / (1.0 + mu_ * mu_), min=0.0)
    scale = torch.where(
        nt > 1e-12, mu_ * n_proj / torch.clamp(nt, min=1e-12), torch.zeros_like(nt)
    )
    t_new = torch.where(
        inside[..., None], t,
        torch.where(polar[..., None], torch.zeros_like(t), t * scale[..., None]),
    )
    n_new = torch.where(inside, nn_, torch.where(polar, torch.zeros_like(nn_), n_proj))
    proj = torch.cat([t_new, n_new[..., None]], dim=-1).reshape(n, 3 * n_points)
    lim = lam[:, 3 * n_points :]
    lim_new = torch.clamp(lim * limit_sign, min=0.0) * limit_sign
    return torch.cat([proj, lim_new], dim=1)


def apgd_solve(
    A: torch.Tensor,  # (N, nrow, nrow) Delassus
    u0: torch.Tensor,  # (N, nrow) J v_free
    n_points: int,
    lo_bound: torch.Tensor,  # (N, n_points)
    limit_sign: torch.Tensor,  # (N, nlim)
    limit_bound: torch.Tensor,  # (N, nlim)
    mu: torch.Tensor,  # (N,)
    iterations: int,
    step_bound: torch.Tensor | None = None,  # (N,) >= lam_max(A)
    lam0: torch.Tensor | None = None,  # (N, nrow) warm start, physical signs
) -> torch.Tensor:
    """Accelerated projected gradient (Nesterov + adaptive restart) on the
    contact QP min 0.5 lam^T A lam + lam^T r over friction cones and signed
    half-lines."""
    n, nrow = u0.shape
    target = torch.zeros_like(u0)
    target[:, 2 : 3 * n_points : 3] = lo_bound
    target[:, 3 * n_points :] = limit_sign * limit_bound
    r = u0 - target
    if step_bound is None:
        step_bound = torch.amax(torch.sum(torch.abs(A), dim=-1), dim=-1)
    step = 1.0 / torch.clamp(step_bound, min=1e-6)
    if lam0 is None:
        lam = torch.zeros_like(u0)
    else:
        lam = _project_cone(lam0, n_points, mu, limit_sign)
    y = lam
    theta = torch.ones(n, device=u0.device, dtype=u0.dtype)
    for _ in range(iterations):
        g = (A @ y[..., None])[..., 0] + r
        lam_new = _project_cone(y - step[:, None] * g, n_points, mu, limit_sign)
        d = lam_new - lam
        restart = torch.sum(g * d, dim=-1) > 0.0
        theta = torch.where(restart, torch.ones_like(theta), theta)
        theta_new = 0.5 * (theta * torch.sqrt(theta * theta + 4.0) - theta * theta)
        beta = theta * (1.0 - theta) / (theta * theta + theta_new)
        beta = torch.where(restart, torch.zeros_like(beta), beta)
        y = lam_new + beta[:, None] * d
        lam = lam_new
        theta = theta_new
    return lam
