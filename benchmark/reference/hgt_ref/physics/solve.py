"""The contact solves' plain versions (the benchmark's copy keeps no kernel
launch; the module text below describes the port's kernels they stand for).

Port of humanoid_gym_tpu/physics/pallas_solver.py, three solves:

- `fused_solve` / `fused_solve_plain`: `_fused_core_opt(leg_blocks=True)`,
  the solve stage of the mega kernel (factor form, solver-internal DOF
  order), described below;
- `fused_dense_solve` / `fused_dense_solve_plain`: `_fused_kernel` ->
  `_fused_core` (solver "fused_pallas"): the same chain with the DENSE
  Delassus A = B^T B in the EXTERNAL DOF order [base, left leg, right leg],
  which makes it iterate-for-iterate equal to solver "apgd";
- `apgd_solve_kernel` / `apgd_solve_kernel_plain`: `_apgd_kernel` (solver
  "apgd_pallas"): APGD alone on a prebuilt Delassus matrix.

The last two take the env-major operands `resolve_contacts` and
`make_substep` build ((N,60,60), (N,60,18), (N,18,18), bounds per contact
point and per limit row) and run csrc/dense_solve.cu, one warp per env with
the Delassus rows in registers; the kernels are compiled for the one shape
the package builds (18 velocities, 60 rows, 16 contact points).
A CUDA tensor launches the kernel or raises; a CPU tensor takes the plain
version (at any shape). Each wrapper counts its launches in `.launches`.

The mega kernel's solve stage: Cholesky of Mtilde, v_free, B = L^-1 J^T,
factor-form APGD (matvec B^T (B y), step bound ||B B^T||_inf + CFM
regularizer, cone projection, Nesterov restart, warm start),
dv = L^-T (B lam). Its operands are env-major and in the SOLVER-INTERNAL
DOF order
[left leg 0:6, right leg 6:12, base 12:18]:
  Mt (N,18,18), Jt (N,18,60) (J^T, not sign-folded), qvel/rhs (N,18),
  target/sign/lam0 (N,60), mu/comp (N,)  ->  qvel_new (N,18), lam (N,60)
with lam0 and lam in physical signs. The CUDA version is the device
function `hgt_solve_env` in csrc/solve.cuh (one warp per env: the factor in
shared memory, the columns of B in registers), which the mega kernel calls;
`fused_solve` launches it alone so it can be held against
`fused_solve_plain` on the card.
"""

from __future__ import annotations

import torch

from .linalg import chol_unrolled, solve_lower_unrolled, solve_upper_unrolled

NV = 18
N_POINTS = 16
ROWS = 60

def project_cone_folded(x: torch.Tensor, mu: torch.Tensor, n_points: int = N_POINTS) -> torch.Tensor:
    """The kernels' projection: friction cones on the (tx, ty, n) blocks
    (nt floored at 1e-24 under the root) and nonnegativity on the
    sign-folded limit rows. x (N, nrow), mu (N,)."""
    n = x.shape[0]
    nc3 = 3 * n_points
    blocks = x[:, :nc3].reshape(n, n_points, 3)
    tx, ty, nn_ = blocks[..., 0], blocks[..., 1], blocks[..., 2]
    mu_ = mu[:, None]
    nt = torch.sqrt(tx * tx + ty * ty + 1e-24)
    inside = nt <= mu_ * nn_
    polar = mu_ * nt <= -nn_
    n_p = torch.clamp((mu_ * nt + nn_) / (1.0 + mu_ * mu_), min=0.0)
    scale = mu_ * n_p / nt
    keep = inside.to(x.dtype)
    mid = (1.0 - keep) * (1.0 - polar.to(x.dtype))
    cone = torch.stack(
        [keep * tx + mid * tx * scale, keep * ty + mid * ty * scale, keep * nn_ + mid * n_p],
        dim=-1,
    ).reshape(n, nc3)
    return torch.cat([cone, torch.clamp(x[:, nc3:], min=0.0)], dim=1)


def fused_solve_plain(Mt, Jt, qvel, rhs, target, sign, mu, comp, lam0, iterations: int):
    """Plain PyTorch version of the solve kernel (same math, batched)."""
    L = chol_unrolled(Mt)
    Lt = L.transpose(-1, -2)
    v_free = qvel + solve_upper_unrolled(Lt, solve_lower_unrolled(L, rhs))
    r = torch.sum(Jt * v_free[..., None], dim=1) * sign - target
    B = solve_lower_unrolled(L, Jt) * sign[:, None, :]  # (N,18,60)
    G = B @ B.transpose(-1, -2)
    bound = torch.amax(torch.sum(torch.abs(G), dim=-1), dim=-1)
    reg = comp * torch.sum(B * B, dim=(1, 2)) / ROWS
    step = 1.0 / torch.clamp(bound + reg, min=1e-6)

    lam = project_cone_folded(lam0 * sign, mu)
    y = lam
    theta = torch.ones_like(mu)
    for _ in range(iterations):
        t = (B @ y[..., None])  # (N,18,1)
        g = (B.transpose(-1, -2) @ t)[..., 0] + reg[:, None] * y + r
        lam_new = project_cone_folded(y - step[:, None] * g, mu)
        d = lam_new - lam
        restart = torch.sum(g * d, dim=-1) > 0.0
        theta = torch.where(restart, torch.ones_like(theta), theta)
        theta_new = 0.5 * (theta * torch.sqrt(theta * theta + 4.0) - theta * theta)
        beta = theta * (1.0 - theta) / (theta * theta + theta_new)
        beta = torch.where(restart, torch.zeros_like(beta), beta)
        y = lam_new + beta[:, None] * d
        lam = lam_new
        theta = theta_new
    dv = solve_upper_unrolled(Lt, (B @ lam[..., None])[..., 0])
    return v_free + dv, lam * sign


def _check_operands(tensors, n):
    shapes = ((n, NV, NV), (n, NV, ROWS), (n, NV), (n, NV), (n, ROWS), (n, ROWS),
              (n,), (n,), (n, ROWS))
    for t, shp in zip(tensors, shapes):
        if t.dtype != torch.float32 or tuple(t.shape) != shp or not t.is_contiguous():
            raise ValueError(f"solve operand must be contiguous float32 {shp}, got "
                             f"{t.dtype} {tuple(t.shape)}")


def fused_solve(Mt, Jt, qvel, rhs, target, sign, mu, comp, lam0, iterations: int):
    """Solve stage: the plain version on any device (the benchmark's copy
    launches no kernel)."""
    return fused_solve_plain(Mt, Jt, qvel, rhs, target, sign, mu, comp, lam0, iterations)


# ---- the dense solves of the per-substep path (csrc/dense_solve.cu) ----

MAX_ROWS = 64  # the kernels give each lane two constraint rows: padded length of their vectors


def _require(t: torch.Tensor, shape, name: str, device, align: int = 4) -> None:
    if t.dtype != torch.float32 or tuple(t.shape) != tuple(shape) or not t.is_contiguous() \
            or t.device != device:
        raise ValueError(f"{name} must be contiguous float32 {tuple(shape)} on {device}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if t.data_ptr() % align:
        raise ValueError(f"{name} must start on a {align}-byte boundary")


def _require_kernel_shape(what: str, nv: int, nrow: int, n_points: int) -> None:
    """The dense kernels hold rows and columns in register arrays, so they
    are compiled for one problem shape."""
    if (nv, nrow, n_points) != (NV, ROWS, N_POINTS):
        raise ValueError(f"the {what} kernel takes nv {NV}, {ROWS} rows and {N_POINTS} contact "
                         f"points, got nv {nv}, nrow {nrow}, n_points {n_points}")


def _fold_signs(limit_sign: torch.Tensor, nc3: int) -> torch.Tensor:
    """(N, nrow) row signs: 1 on contact rows, limit_sign on limit rows."""
    ones = torch.ones((limit_sign.shape[0], nc3), device=limit_sign.device, dtype=limit_sign.dtype)
    return torch.cat([ones, limit_sign], dim=1)


def apgd_solve_kernel_plain(A, u0, lo_bound, limit_sign, limit_bound, mu, step_bound=None,
                            lam0=None, iterations: int = 16):
    """Plain PyTorch version of the APGD kernel: the folded loop of
    `_apgd_kernel` (A' = s s^T o A, r' = s o u0 - target, projected warm
    start, `iterations` x [gradient, projection, restart, momentum], signs
    unfolded on the way out). Returns lam (N, nrow), physical signs."""
    n, nrow = u0.shape
    n_points = lo_bound.shape[1]
    nc3 = 3 * n_points
    s = _fold_signs(limit_sign, nc3)
    A_f = A * s[:, :, None] * s[:, None, :]
    target = torch.zeros_like(u0)
    target[:, 2:nc3:3] = lo_bound
    target[:, nc3:] = limit_bound
    r = s * u0 - target
    if step_bound is None:
        step_bound = torch.amax(torch.sum(torch.abs(A_f), dim=-1), dim=-1)
    step = 1.0 / torch.clamp(step_bound, min=1e-6)
    lam = torch.zeros_like(u0) if lam0 is None else project_cone_folded(s * lam0, mu, n_points)
    y = lam
    theta = torch.ones_like(mu)
    for _ in range(iterations):
        g = (A_f @ y[..., None])[..., 0] + r
        lam_new = project_cone_folded(y - step[:, None] * g, mu, n_points)
        d = lam_new - lam
        restart = torch.sum(g * d, dim=-1) > 0.0
        theta = torch.where(restart, torch.ones_like(theta), theta)
        theta_new = 0.5 * (theta * torch.sqrt(theta * theta + 4.0) - theta * theta)
        beta = theta * (1.0 - theta) / (theta * theta + theta_new)
        beta = torch.where(restart, torch.zeros_like(beta), beta)
        y = lam_new + beta[:, None] * d
        lam = lam_new
        theta = theta_new
    return lam * s


def apgd_solve_kernel(A, u0, lo_bound, limit_sign, limit_bound, mu, step_bound=None, lam0=None,
                      iterations: int = 16):
    """APGD on a prebuilt Delassus matrix. A (N,nrow,nrow), u0 (N,nrow),
    lo_bound (N,n_points), limit_sign / limit_bound (N,nlim), mu (N,),
    step_bound (N,) or None (-> ||A||_inf), lam0 (N,nrow) in physical signs
    or None (-> zeros). Returns lam (N,nrow). The plain version on any
    device (the benchmark's copy launches no kernel)."""
    return apgd_solve_kernel_plain(A, u0, lo_bound, limit_sign, limit_bound, mu,
                                   step_bound, lam0, iterations)


def fused_dense_solve_plain(Mt, J, qvel, rhs, lo_bound, limit_sign, limit_bound, mu, compliance,
                            lam0=None, iterations: int = 16):
    """Plain PyTorch version of the fused dense kernel: the batched form of
    the TPU package's single-env fallback (pallas_solver.py:867-887) with
    the kernels' projection. Returns (qvel_new (N,nv), lam (N,nrow))."""
    L = chol_unrolled(Mt)
    Lt = L.transpose(-1, -2)
    v_free = qvel + solve_upper_unrolled(Lt, solve_lower_unrolled(L, rhs))
    B = solve_lower_unrolled(L, J.transpose(-1, -2))  # (N,nv,nrow)
    A = B.transpose(-1, -2) @ B
    nrow = A.shape[-1]
    reg = compliance * torch.diagonal(A, dim1=-2, dim2=-1).sum(-1) / nrow
    A = A + reg[:, None, None] * torch.eye(nrow, device=A.device, dtype=A.dtype)
    u0 = (J @ v_free[..., None])[..., 0]
    G = B @ B.transpose(-1, -2)
    step_bound = torch.amax(torch.sum(torch.abs(G), dim=-1), dim=-1) + reg
    lam = apgd_solve_kernel_plain(A, u0, lo_bound, limit_sign, limit_bound, mu, step_bound,
                                  lam0, iterations)
    qvel_new = v_free + solve_upper_unrolled(Lt, (B @ lam[..., None])[..., 0])
    return qvel_new, lam


def fused_dense_solve(Mt, J, qvel, rhs, lo_bound, limit_sign, limit_bound, mu, compliance,
                      lam0=None, iterations: int = 16):
    """Cholesky + v_free + dense Delassus + APGD + velocity update in the
    external DOF order. Mt (N,nv,nv), J (N,nrow,nv), qvel / rhs (N,nv),
    lo_bound (N,n_points), limit_sign / limit_bound (N,nlim), mu /
    compliance (N,), lam0 (N,nrow) in physical signs or None. Returns
    (qvel_new (N,nv), lam (N,nrow)). The plain version on any device (the
    benchmark's copy launches no kernel)."""
    return fused_dense_solve_plain(Mt, J, qvel, rhs, lo_bound, limit_sign, limit_bound, mu,
                                   compliance, lam0, iterations)
