"""Moving-window regression kriging of monthly normals (port of
``topotpu.interp.normals``).

Per cell x month: a GWR trend on (elev, tdi, lst_m) plus ordinary kriging of
the trend residuals with per-cell exponential variogram parameters
(distance-weighted from the per-station fits), giving the kriged mean and
the kriging variance. Inputs arrive gathered per neighbourhood: (C, k) and
(C, k, q) with a validity mask.

Both entry points go through ``kernels.krig_normals.krig_normals_fused``,
which dispatches on the device of its inputs: CUDA tensors launch the
hand-written kernel, CPU tensors take its plain version.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from topotpu_torch.kernels.krig_normals import OUT_EXTRA, krig_normals_fused


class NormalsResult(NamedTuple):
    normal: torch.Tensor    # (C,) kriged monthly normal
    variance: torch.Tensor  # (C,) kriging variance (deg C^2)
    se: torch.Tensor        # (C,) sqrt variance
    trend: torch.Tensor     # (C,) GWR trend component (diagnostic)
    ok: torch.Tensor        # (C,) bool solvable flag
    vario: torch.Tensor     # (C, 3) cell-interpolated nugget/psill/range


def interp_cell_variogram(nbr_vario: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(C, k, 3) station params + (C, k) weights -> (C, 3) cell params."""
    wsum = torch.sum(w, dim=-1, keepdim=True) + 1e-30
    v = torch.einsum("ck,ckp->cp", w, nbr_vario) / wsum
    nug = torch.clamp(v[..., 0], min=0.0)
    psill = torch.clamp(v[..., 1], min=1e-6)
    rng = torch.clamp(v[..., 2], min=1e-2)
    return torch.stack([nug, psill, rng], dim=-1)


def _rows(a: torch.Tensor) -> torch.Tensor:
    """(C, k, n) -> (n k, C) covariate-major rows, contiguous."""
    C, k, n = a.shape
    return a.permute(2, 1, 0).reshape(n * k, C).contiguous()


def krig_normals_and_gains(
    dist, mask, nbr_xyz, nbr_cov, cell_cov, nbr_norm, nbr_vario,
    anom_cov, cell_anom_cov,
    weight_kernel="bisquare", ridge=1e-6, jitter_frac=1e-5, min_neighbors=3,
):
    """``krig_normals`` plus the anomaly-GWR gain rows (C, k) over the same
    neighbourhoods and weights, in one kernel launch: the gathered inputs are
    laid out as the kernel's (rows, C) planes, and its (8 + k, C) output is
    unpacked into (NormalsResult, gains)."""
    C, k = dist.shape
    q, qa = nbr_cov.shape[-1], anom_cov.shape[-1]
    dt = dist.dtype
    cell8 = torch.zeros((OUT_EXTRA, C), dtype=dt, device=dist.device)
    cell8[:q] = cell_cov.T
    cell8[q : q + qa] = cell_anom_cov.T
    out = krig_normals_fused(
        _rows(nbr_xyz.to(dt)),
        dist.T.contiguous(),
        mask.T.to(dt).contiguous(),
        _rows(nbr_cov.to(dt)),
        cell8,
        nbr_norm.T.to(dt).contiguous(),
        _rows(nbr_vario.to(dt)),
        _rows(anom_cov.to(dt)),
        ridge=ridge, jitter_frac=jitter_frac, min_neighbors=min_neighbors,
        weight_kernel=weight_kernel,
    )
    var = out[1]
    res = NormalsResult(
        normal=out[0],
        variance=var,
        se=torch.sqrt(torch.clamp(var, min=0.0)),
        trend=out[3],
        ok=out[2] > 0.5,
        vario=out[4:7].T,
    )
    return res, out[OUT_EXTRA:].T


def krig_normals(
    dist: torch.Tensor,
    mask: torch.Tensor,
    nbr_xyz: torch.Tensor,
    nbr_cov: torch.Tensor,
    cell_cov: torch.Tensor,
    nbr_norm: torch.Tensor,
    nbr_vario: torch.Tensor,
    weight_kernel: str = "bisquare",
    ridge: float = 1e-6,
    jitter_frac: float = 1e-5,
    min_neighbors: int = 3,
) -> NormalsResult:
    """Regression-krige monthly normals for a batch of cells.

    dist (C, k) km; mask (C, k); nbr_xyz (C, k, 3) unit-sphere coords;
    nbr_cov (C, k, q) and cell_cov (C, q) trend covariates; nbr_norm (C, k)
    station normals; nbr_vario (C, k, 3) station (nugget, psill, range).
    The kernel runs with an empty anomaly design (qa = 0), whose
    intercept-only gain rows are dropped.
    """
    C, k = dist.shape
    res, _ = krig_normals_and_gains(
        dist, mask, nbr_xyz, nbr_cov, cell_cov, nbr_norm, nbr_vario,
        dist.new_zeros((C, k, 0)), dist.new_zeros((C, 0)),
        weight_kernel=weight_kernel, ridge=ridge, jitter_frac=jitter_frac,
        min_neighbors=min_neighbors,
    )
    return res
