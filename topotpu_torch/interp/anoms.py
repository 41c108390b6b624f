"""Daily-anomaly GWR as gain rows (port of ``topotpu.interp.anoms``).

The GWR design and weights depend only on (cell, month) geometry, so the
per-day solve collapses to a gain row g per cell:

    anom(cell, day) = sum_j g[cell, j] * anom_stn[idx[cell, j], day]

and a month of days is one contraction with the station-day matrix.
"""

from __future__ import annotations

import torch

from topotpu_torch.geo.neighbors import distance_weights
from topotpu_torch.kernels.wls import batched_gwr_gain, center_design


def anomaly_gain_rows(
    dist: torch.Tensor,
    mask: torch.Tensor,
    nbr_cov: torch.Tensor,
    cell_cov: torch.Tensor,
    weight_kernel: str = "bisquare",
    ridge: float = 1e-6,
) -> torch.Tensor:
    """(C, k) GWR prediction gains for one (tile, month) geometry."""
    w = distance_weights(dist, mask, weight_kernel)
    X, x0, _ = center_design(nbr_cov, cell_cov, w)
    return batched_gwr_gain(X, w, x0, ridge)


def scatter_gains(
    gains: torch.Tensor, idx: torch.Tensor, mask: torch.Tensor, n_stations: int
) -> torch.Tensor:
    """Scatter (C, k) gains into a dense (C, S) matrix; masked entries add 0
    and duplicate indices accumulate."""
    g = torch.where(mask, gains, torch.zeros_like(gains))
    C = gains.shape[0]
    G = torch.zeros((C, n_stations), dtype=gains.dtype, device=gains.device)
    return G.scatter_add_(1, idx.long(), g)


def predict_daily(G: torch.Tensor, stn_anoms: torch.Tensor) -> torch.Tensor:
    """(C, S) gains x (S, D) station anomalies -> (C, D) cell anomalies."""
    return G @ stn_anoms


def predict_daily_gathered(
    gains: torch.Tensor,      # (C, k)
    idx: torch.Tensor,        # (C, k)
    mask: torch.Tensor,       # (C, k)
    stn_anoms: torch.Tensor,  # (S, D)
) -> torch.Tensor:
    """Scatter-free form: gather each neighbourhood's day rows and contract."""
    g = torch.where(mask, gains, torch.zeros_like(gains))
    rows = stn_anoms[idx.long()]  # (C, k, D)
    return torch.einsum("ck,ckd->cd", g, rows)
