"""The contact solve stage of the mega kernel, with its plain version.

Port of humanoid_gym_tpu/physics/pallas_solver.py `_fused_core_opt` with
`leg_blocks=True`: Cholesky of Mtilde, v_free, B = L^-1 J^T, factor-form
APGD (matvec B^T (B y), step bound ||B B^T||_inf + CFM regularizer, cone
projection, Nesterov restart, warm start), dv = L^-T (B lam).

All operands are env-major and in the SOLVER-INTERNAL DOF order
[left leg 0:6, right leg 6:12, base 12:18]:
  Mt (N,18,18), Jt (N,18,60) (J^T, not sign-folded), qvel/rhs (N,18),
  target/sign/lam0 (N,60), mu/comp (N,)  ->  qvel_new (N,18), lam (N,60)
with lam0 and lam in physical signs. The CUDA version is the device
function `hgt_solve_env` in csrc/solve.cuh, which the mega kernel calls;
`fused_solve` launches it alone so it can be held against
`fused_solve_plain` on the card.
"""

from __future__ import annotations

import torch

from .cuda_build import check, kernel_library
from .linalg import chol_unrolled, solve_lower_unrolled, solve_upper_unrolled

NV = 18
N_POINTS = 16
NC3 = 3 * N_POINTS
ROWS = 60


def project_cone_folded(x: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
    """The kernel's projection: 16 friction cones on (tx, ty, n) blocks
    (nt floored at 1e-24 under the root) and nonnegativity on the
    sign-folded limit rows. x (N, 60), mu (N,)."""
    n = x.shape[0]
    blocks = x[:, :NC3].reshape(n, N_POINTS, 3)
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
    ).reshape(n, NC3)
    return torch.cat([cone, torch.clamp(x[:, NC3:], min=0.0)], dim=1)


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
    """Solve stage: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors. Counts kernel launches in `fused_solve.launches`."""
    if not Mt.is_cuda:
        return fused_solve_plain(Mt, Jt, qvel, rhs, target, sign, mu, comp, lam0, iterations)
    n = Mt.shape[0]
    ops = [Mt, Jt, qvel, rhs, target, sign, mu, comp, lam0]
    _check_operands(ops, n)
    if any(not t.is_cuda or t.device != Mt.device for t in ops):
        raise ValueError("solve operands must all lie on one CUDA device")
    lib = kernel_library()
    qvel_out = torch.empty((n, NV), device=Mt.device, dtype=torch.float32)
    lam_out = torch.empty((n, ROWS), device=Mt.device, dtype=torch.float32)
    stream = torch.cuda.current_stream(Mt.device).cuda_stream
    err = lib.lib.hgt_solve(
        *[t.data_ptr() for t in ops], qvel_out.data_ptr(), lam_out.data_ptr(),
        n, int(iterations), stream,
    )
    check(err, "hgt_solve launch")
    fused_solve.launches += 1
    return qvel_out, lam_out


fused_solve.launches = 0
