"""Batched ordinary-kriging solve (port of ``topotpu.kernels.cholesky``).

The augmented (k+1) OK system is replaced by the simple-kriging reduction on
the SPD covariance C alone:

    C a = c0,   C u = 1
    t       = (1 - 1^T a) / (1^T u)
    lambda  = a + t u                         (OK weights)
    sigma^2 = sill - lambda^T c0 + t          (OK variance)

A masked station j gets row/col e_j in C, 0 in c0 and 0 in the ones vector,
so its weight is exactly 0 and it cannot move the mean or the variance.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from topotpu_torch.kernels.wls import cholesky_or_nan


class OKSolution(NamedTuple):
    weights: torch.Tensor   # (B, k) ordinary-kriging weights (0 at masked)
    variance: torch.Tensor  # (B,) kriging variance
    ok: torch.Tensor        # (B,) bool: enough stations and solvable


def assemble_exp_cov(
    dist_pair: torch.Tensor,
    dist_point: torch.Tensor,
    nugget: torch.Tensor,
    psill: torch.Tensor,
    rng: torch.Tensor,
    mask: torch.Tensor,
    jitter_frac: float = 1e-5,
):
    """Exponential-model covariance for a padded neighbourhood.

    dist_pair (B, k, k), dist_point (B, k), nugget/psill/rng (B,), mask
    (B, k). Returns (C, c0, sill): C (B, k, k) SPD with masked rows/cols
    folded to identity, c0 (B, k) masked to 0, sill (B,) = nugget + psill.
    """
    nugget = nugget[..., None]
    psill = psill[..., None]
    rng = torch.clamp(rng[..., None], min=1e-3)
    zero = torch.zeros((), dtype=dist_point.dtype, device=dist_point.device)
    c0 = torch.where(mask, psill * torch.exp(-dist_point / rng), zero)

    C = psill[..., None] * torch.exp(-dist_pair / rng[..., None])
    k = dist_pair.shape[-1]
    eye = torch.eye(k, dtype=C.dtype, device=C.device)
    sill = (nugget + psill)[..., 0]
    C = C + (nugget[..., None] + jitter_frac * sill[..., None, None]) * eye
    pair_mask = mask[..., :, None] & mask[..., None, :]
    C = torch.where(pair_mask, C, zero)
    diag_fix = (~mask).to(C.dtype)
    C = C + diag_fix[..., :, None] * eye
    return C, c0, sill


def ok_solve(
    C: torch.Tensor,
    c0: torch.Tensor,
    mask: torch.Tensor,
    sill: torch.Tensor,
    min_neighbors: int = 3,
) -> OKSolution:
    """Ordinary-kriging weights and variance via a batched Cholesky.

    C must already have masked rows/cols folded to identity (see
    ``assemble_exp_cov``); c0 masked to 0.
    """
    ones = mask.to(C.dtype)
    rhs = torch.stack([c0, ones], dim=-1)  # (B, k, 2)
    L = cholesky_or_nan(C)
    z = torch.linalg.solve_triangular(L, rhs, upper=False)
    sol = torch.linalg.solve_triangular(L.transpose(-1, -2), z, upper=True)
    a = sol[..., 0]
    u = sol[..., 1]
    sum_a = torch.sum(a * ones, dim=-1)
    sum_u = torch.sum(u * ones, dim=-1)
    n_valid = torch.sum(mask, dim=-1)
    solvable = (n_valid >= min_neighbors) & (sum_u > 1e-12) & torch.isfinite(sum_u)
    t = (1.0 - sum_a) / torch.where(solvable, sum_u, torch.ones_like(sum_u))
    lam = torch.where(mask, a + t[..., None] * u, torch.zeros_like(a))
    var = torch.clamp(sill - torch.sum(lam * c0, dim=-1) + t, min=0.0)
    return OKSolution(weights=lam, variance=var, ok=solvable)
