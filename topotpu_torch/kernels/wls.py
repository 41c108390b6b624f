"""Batched masked weighted least squares (port of ``topotpu.kernels.wls``).

Shapes: X (B, k, p) design, y (B, k) targets, w (B, k) weights (0 = masked).
p is tiny (<= 8), so the normal-equations route with a batched Cholesky is
the plain version the hand kernel is held against.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _normal_eq(X: torch.Tensor, w: torch.Tensor, ridge: float) -> torch.Tensor:
    """A = X^T diag(w) X + ridge * (mean diagonal) * I, shape (B, p, p)."""
    A = torch.einsum("bkp,bkq->bpq", X * w[..., :, None], X)
    p = X.shape[-1]
    diag_mean = torch.diagonal(A, dim1=-2, dim2=-1).sum(-1)[..., None, None] / p
    eye = torch.eye(p, dtype=X.dtype, device=X.device)
    return A + (ridge * diag_mean + 1e-30) * eye


def cholesky_or_nan(A: torch.Tensor) -> torch.Tensor:
    """Batched lower Cholesky factor; a matrix that is not positive definite
    gets a NaN factor (as XLA's does) instead of raising for the batch."""
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where((info != 0)[..., None, None], torch.nan, L)


def _chol_solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b for SPD A (B, p, p) and b (B, p, r)."""
    L = cholesky_or_nan(A)
    z = torch.linalg.solve_triangular(L, b, upper=False)
    return torch.linalg.solve_triangular(L.transpose(-1, -2), z, upper=True)


def batched_wls(
    X: torch.Tensor, y: torch.Tensor, w: torch.Tensor, ridge: float = 1e-6
) -> torch.Tensor:
    """Weighted least-squares coefficients beta (B, p) per batch element."""
    A = _normal_eq(X, w, ridge)
    b = torch.einsum("bkp,bk->bp", X * w[..., :, None], y)
    return _chol_solve(A, b[..., None])[..., 0]


def batched_gwr_gain(
    X: torch.Tensor, w: torch.Tensor, x0: torch.Tensor, ridge: float = 1e-6
) -> torch.Tensor:
    """Prediction gain row g (B, k) = w * (X (X^T W X)^-1 x0): pred(y) = g . y."""
    A = _normal_eq(X, w, ridge)
    v = _chol_solve(A, x0[..., None])[..., 0]
    return w * torch.einsum("bkp,bp->bk", X, v)


def center_design(
    cov_stack: torch.Tensor, cov_point: torch.Tensor, w: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Locally centred, weighted-std-scaled design with an intercept column.

    cov_stack (B, k, p-1), cov_point (B, p-1), w (B, k). Returns (X, x0,
    scale) with X (B, k, p); x0 is exactly e0, so pred = beta[0].
    """
    d = cov_stack - cov_point[..., None, :]
    wsum = torch.sum(w, dim=-1, keepdim=True) + 1e-30
    mean = torch.sum(w[..., None] * d, dim=-2) / wsum
    var = torch.sum(w[..., None] * (d - mean[..., None, :]) ** 2, dim=-2) / wsum
    scale = torch.sqrt(var) + 1e-6
    dn = d / scale[..., None, :]
    B, k, _ = cov_stack.shape
    ones = torch.ones((B, k, 1), dtype=cov_stack.dtype, device=cov_stack.device)
    X = torch.cat([ones, dn], dim=-1)
    x0 = torch.zeros((B, X.shape[-1]), dtype=cov_stack.dtype, device=cov_stack.device)
    x0[:, 0] = 1.0
    return X, x0, scale
