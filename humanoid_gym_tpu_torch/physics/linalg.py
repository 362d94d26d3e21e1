"""Unrolled small-matrix linear algebra on batched tensors.

Port of humanoid_gym_tpu/physics/linalg.py: the same outer-product Cholesky
(pivot floor 1e-12) and forward/back substitution, written over a leading
batch axis. These are the plain versions of the factor and solves inside
the CUDA solve kernel (csrc/solve.cuh), and keep its arithmetic order.
"""

from __future__ import annotations

import torch


def chol_unrolled(M: torch.Tensor) -> torch.Tensor:
    """Cholesky factor L (lower) of SPD (..., n, n) matrices."""
    n = M.shape[-1]
    A = M.clone()
    L = torch.zeros_like(M)
    for k in range(n):
        d = torch.sqrt(torch.clamp(A[..., k, k], min=1e-12))
        col = A[..., :, k] / d[..., None]
        col[..., :k] = 0.0
        col[..., k] = d
        L[..., :, k] = col
        v = col.clone()
        v[..., k] = 0.0
        A = A - v[..., :, None] * v[..., None, :]
    return L


def solve_lower_unrolled(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve L X = B with L (..., n, n) lower-triangular, B (..., n) or
    (..., n, k)."""
    n = L.shape[-1]
    vec = B.dim() == L.dim() - 1
    X = (B[..., None] if vec else B).clone()
    for k in range(n):
        xk = X[..., k, :] / L[..., k, k][..., None]
        X[..., k, :] = xk
        if k + 1 < n:
            X[..., k + 1:, :] = X[..., k + 1:, :] - L[..., k + 1:, k][..., None] * xk[..., None, :]
    return X[..., 0] if vec else X


def solve_upper_unrolled(U: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve U X = B with U (..., n, n) upper-triangular."""
    n = U.shape[-1]
    vec = B.dim() == U.dim() - 1
    X = (B[..., None] if vec else B).clone()
    for k in reversed(range(n)):
        xk = X[..., k, :] / U[..., k, k][..., None]
        X[..., k, :] = xk
        if k > 0:
            X[..., :k, :] = X[..., :k, :] - U[..., :k, k][..., None] * xk[..., None, :]
    return X[..., 0] if vec else X


def solve_spd_chol(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve (L L^T) X = B given the Cholesky factor."""
    return solve_upper_unrolled(L.transpose(-1, -2), solve_lower_unrolled(L, B))
