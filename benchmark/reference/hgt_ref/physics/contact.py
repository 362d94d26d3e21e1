"""Batched contact + joint-limit rows and the contact solvers.

Port of humanoid_gym_tpu/physics/contact.py: `terrain_contact_frames`,
`build_contact_setup`, `joint_limit_bounds`, `_project_cone`, `apgd_solve`,
`pgs_solve` and `resolve_contacts`, which dispatches on the solver name
("apgd", "pgs" in plain PyTorch; "apgd_pallas" to the APGD kernel of
physics/solve.py). Everything takes the env axis first. On a heightfield
the caller passes per-point frames (t1, t2, n) frozen at the policy-step
start: each point's three rows of J are projected onto them, the gap is
measured along the normal (vertical gap x n_z), and the impulses come back
in the world frame.

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
from .kinematics import ancestor_mask, dof_basis, index_tensor, point_jacobian
from .linalg import solve_lower_unrolled, solve_upper_unrolled
from .model import RobotModel
from .solve import apgd_solve_kernel


class ContactSetup(NamedTuple):
    J: torch.Tensor  # (N, nrow, nv) stacked constraint Jacobian
    lo_bound: torch.Tensor  # (N, K) velocity lower bound per normal row
    phi: torch.Tensor  # (N, K) signed gap of force-solved points
    pos_w: torch.Tensor  # (N, K, 3) world candidate positions
    frames: torch.Tensor | None  # (N, K, 3, 3) rows (t1, t2, n) per point,
    # or None on flat ground (identity frames: world x / y / z rows)


def _per_env(x):
    """A float, or an (N,) tensor as an (N, 1) column beside the (N, K)
    points."""
    return x[:, None] if torch.is_tensor(x) and x.dim() else x


def terrain_contact_frames(gx: torch.Tensor, gy: torch.Tensor) -> torch.Tensor:
    """Per-point contact frames from the terrain slope: rows (t1, t2, n)
    with n = normalize(-dh/dx, -dh/dy, 1), the surface normal of the height
    function, and tangents spanning the surface plane; t1 = normalize(e_y x
    n) = (n_z, 0, -n_x) / |.| is never degenerate while the surface is
    walkable (n_z > 0). gx, gy: (..., K) -> (..., K, 3, 3)."""
    ones = torch.ones_like(gx)
    n = torch.stack([-gx, -gy, ones], dim=-1)
    n = n / torch.linalg.norm(n, dim=-1, keepdim=True)
    t1 = torch.stack([n[..., 2], torch.zeros_like(gx), -n[..., 0]], dim=-1)
    t1 = t1 / torch.linalg.norm(t1, dim=-1, keepdim=True)
    t2 = torch.linalg.cross(n, t1, dim=-1)
    return torch.stack([t1, t2, n], dim=-2)


def build_contact_setup(
    model: RobotModel,
    dyn: Dyn,
    terrain_height_fn,
    dt: float,
    contact_offset=0.01,
    baumgarte=0.2,
    max_depen_vel: float = 1.0,
    frames_override: torch.Tensor | None = None,
) -> ContactSetup:
    """contact_offset and baumgarte are floats or (N,) per-env tensors;
    frames_override (N, K, 3, 3) are policy-step-start sloped frames (None:
    flat ground)."""
    k = dyn.k
    n = k.p.shape[0]
    mask = ancestor_mask(model)
    basis = dof_basis(model, k)

    body_idx = index_tensor(model.contact_point_body, model.device)
    offs = model.contact_point_offset  # (K,3)
    Rb = k.R[:, body_idx]
    pb = k.p[:, body_idx]
    pos = pb + torch.einsum("nkij,kj->nki", Rb, offs)  # (N,K,3)
    ground = terrain_height_fn(pos[..., 0], pos[..., 1])
    phi = pos[..., 2] - ground

    Jpts = point_jacobian(basis, mask[body_idx], pos)  # (N,K,3,nv)
    phi_n = phi
    if frames_override is not None:
        if tuple(frames_override.shape) != (n, pos.shape[1], 3, 3):
            raise ValueError(f"frames_override must be (N, K, 3, 3) = {(n, pos.shape[1], 3, 3)}, "
                             f"got {tuple(frames_override.shape)}")
        # each point's rows rotated into (t1, t2, n); the gap along the normal
        Jpts = torch.einsum("nkdc,nkcv->nkdv", frames_override, Jpts)
        phi_n = phi * frames_override[..., 2, 2]

    coff, bmg = _per_env(contact_offset), _per_env(baumgarte)
    inactive = phi_n > coff
    b_pen = torch.clamp(bmg * (-phi_n) / dt, max=max_depen_vel)
    b_gap = -phi_n / dt
    lo = torch.where(phi_n <= 0.0, b_pen, b_gap)
    lo = torch.where(inactive, torch.full_like(lo, -1e9), lo)

    K = pos.shape[1]
    qj_rows = torch.eye(model.nv, device=phi.device, dtype=phi.dtype)[6:].expand(n, model.nj, model.nv)
    J = torch.cat([Jpts.reshape(n, 3 * K, model.nv), qj_rows], dim=1)
    return ContactSetup(J=J, lo_bound=lo, phi=phi, pos_w=pos, frames=frames_override)


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


def pgs_solve(
    A: torch.Tensor,  # (N, nrow, nrow) Delassus
    u0: torch.Tensor,  # (N, nrow) J v_free
    n_points: int,
    lo_bound: torch.Tensor,  # (N, n_points)
    limit_sign: torch.Tensor,  # (N, nlim)
    limit_bound: torch.Tensor,  # (N, nlim)
    mu: torch.Tensor,  # (N,)
    iterations: int,
    lam0: torch.Tensor | None = None,  # (N, nrow) warm start, physical signs
) -> torch.Tensor:
    """Projected Gauss-Seidel over 3D friction blocks + 1D limit rows:
    per contact a scalar normal update clamped at 0, scalar tangential
    updates, then disk projection onto the cone. The sweeps are sequential
    in the rows; the batch runs over the envs."""
    nlim = limit_sign.shape[1]
    diag = torch.diagonal(A, dim1=-2, dim2=-1) + 1e-7
    if lam0 is None:
        lam = torch.zeros_like(u0)
        u = u0.clone()
    else:
        lam = _project_cone(lam0, n_points, mu, limit_sign)
        u = u0 + (A @ lam[..., None])[..., 0]
    lam = lam.clone()
    for _ in range(iterations):
        for kk in range(n_points):
            r = 3 * kk
            lam_k, u_k, d_k = lam[:, r:r + 3], u[:, r:r + 3], diag[:, r:r + 3]
            ln = torch.clamp(lam_k[:, 2] + (lo_bound[:, kk] - u_k[:, 2]) / d_k[:, 2], min=0.0)
            lt = lam_k[:, :2] - u_k[:, :2] / d_k[:, :2]
            tn = torch.linalg.norm(lt, dim=-1) + 1e-12
            scale = torch.clamp(mu * ln / tn, max=1.0)
            new_k = torch.cat([lt * scale[:, None], ln[:, None]], dim=1)
            d = new_k - lam_k
            lam[:, r:r + 3] = new_k
            u = u + (A[:, :, r:r + 3] @ d[..., None])[..., 0]
        for jj in range(nlim):
            r = 3 * n_points + jj
            sgn = limit_sign[:, jj]
            viol = limit_bound[:, jj] - sgn * u[:, r]
            cand = (lam[:, r] + viol / diag[:, r] * sgn) * sgn
            new = torch.clamp(cand, min=0.0) * sgn
            d = new - lam[:, r]
            lam[:, r] = new
            u = u + A[:, :, r] * d[:, None]
    return lam


class ContactResult(NamedTuple):
    qvel_new: torch.Tensor  # (N, nv)
    impulses: torch.Tensor  # (N, K, 3) per force-solved point (world frame)
    phi: torch.Tensor  # (N, K) gaps
    pos_w: torch.Tensor  # (N, K, 3)
    lam: torch.Tensor  # (N, nrow) full impulse vector (physical signs): the
    # warm-start carry for the next substep's solve


def delassus_operands(
    model: RobotModel,
    dyn: Dyn,
    qpos: torch.Tensor,
    v_free: torch.Tensor,
    terrain_height_fn,
    dt: float,
    contact_offset=0.01,
    max_depen_vel: float = 1.0,
    baumgarte=0.2,
    compliance=0.0,
    frames_override=None,
):
    """What a contact solver is handed at v_free: (setup, limit_sign,
    limit_bound, B, A, u0, step_bound). A = J Mtilde^-1 J^T through the
    half-factor B = L^-1 J^T (A = B^T B), with the CFM regularizer
    compliance * trace(A) / nrow on the diagonal; u0 = J v_free; the APGD
    step bound ||B B^T||_inf + reg, which every APGD path shares (same
    nonzero spectrum as A, invariant to limit-row sign folding).
    compliance is a float or an (N,) tensor; frames_override as in
    `build_contact_setup`."""
    setup = build_contact_setup(
        model, dyn, terrain_height_fn, dt, contact_offset=contact_offset,
        max_depen_vel=max_depen_vel, baumgarte=baumgarte, frames_override=frames_override,
    )
    sign, lb = joint_limit_bounds(model, qpos, dt)
    n = setup.phi.shape[0]
    B = solve_lower_unrolled(dyn.Mtilde_chol, setup.J.transpose(1, 2))  # (N, nv, nrow)
    A = B.transpose(1, 2) @ B
    nrow = A.shape[-1]
    comp = compliance.expand(n) if torch.is_tensor(compliance) else \
        torch.full((n,), float(compliance), dtype=A.dtype, device=A.device)
    reg = comp * torch.diagonal(A, dim1=-2, dim2=-1).sum(-1) / nrow
    A = A + reg[:, None, None] * torch.eye(nrow, device=A.device, dtype=A.dtype)
    u0 = (setup.J @ v_free[..., None])[..., 0]
    G = B @ B.transpose(1, 2)
    step_bound = torch.amax(torch.sum(torch.abs(G), dim=-1), dim=-1) + reg
    return setup, sign, lb, B, A, u0, step_bound


def resolve_contacts(
    model: RobotModel,
    dyn: Dyn,
    qpos: torch.Tensor,
    v_free: torch.Tensor,
    terrain_height_fn,
    dt: float,
    mu: torch.Tensor,
    iterations: int = 8,
    contact_offset=0.01,
    max_depen_vel: float = 1.0,
    solver: str = "apgd",
    baumgarte=0.2,
    compliance=0.0,
    lam0: torch.Tensor | None = None,
    frames_override=None,
) -> ContactResult:
    """Contact and joint-limit impulses at v_free (solver "apgd",
    "apgd_pallas" or "pgs" on the operands of `delassus_operands`) and the
    velocity after them, qvel_new = v_free + L^-T (B lam). With sloped
    frames the impulses are reported in the world frame."""
    setup, sign, lb, B, A, u0, step_bound = delassus_operands(
        model, dyn, qpos, v_free, terrain_height_fn, dt, contact_offset=contact_offset,
        max_depen_vel=max_depen_vel, baumgarte=baumgarte, compliance=compliance,
        frames_override=frames_override,
    )
    K = setup.phi.shape[1]
    L = dyn.Mtilde_chol
    if solver == "apgd":
        lam = apgd_solve(A, u0, K, setup.lo_bound, sign, lb, mu, iterations,
                         step_bound=step_bound, lam0=lam0)
    elif solver == "apgd_pallas":
        lam = apgd_solve_kernel(
            A.contiguous(), u0.contiguous(), setup.lo_bound.contiguous(), sign.contiguous(),
            lb.contiguous(), mu.contiguous(), step_bound.contiguous(),
            None if lam0 is None else lam0.contiguous(), iterations=iterations,
        )
    elif solver == "pgs":
        lam = pgs_solve(A, u0, K, setup.lo_bound, sign, lb, mu, iterations, lam0=lam0)
    else:
        raise ValueError(f"unknown contact solver {solver!r}")
    qvel_new = v_free + solve_upper_unrolled(L.transpose(1, 2), (B @ lam[..., None])[..., 0])
    return ContactResult(
        qvel_new=qvel_new, impulses=world_impulses(lam, setup), phi=setup.phi,
        pos_w=setup.pos_w, lam=lam,
    )


def world_impulses(lam: torch.Tensor, setup: ContactSetup) -> torch.Tensor:
    """The contact rows of lam (N, nrow) as (N, K, 3) world-frame impulses:
    rotated out of the (t1, t2, n) frames where the setup has them."""
    n, K = setup.phi.shape
    imp = lam[:, : 3 * K].reshape(n, K, 3)
    if setup.frames is not None:
        imp = torch.einsum("nkd,nkdc->nkc", imp, setup.frames)
    return imp
