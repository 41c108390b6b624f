"""Static-shape kNN station neighbourhoods (port of ``topotpu.geo.neighbors``).

Invalid or monthly-masked stations are pushed to +inf distance (or -inf
cosine score) before ``torch.topk``; a boolean mask carries validity
downstream, so a masked station never perturbs the kriging mean or variance.
``torch.topk`` breaks ties in another order than ``lax.top_k``, so two
implementations agree on neighbourhoods as sets over the masked slots, not
on raw ``idx``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from topotpu_torch.geo.distance import (
    great_circle_km,
    pairwise_great_circle_km,
    unit_xyz,
)
from topotpu_torch.kernels.loo_select import loo_select
from topotpu_torch.utils.profiling import span


class Neighborhood(NamedTuple):
    """Per-cell padded neighbourhoods. All tensors (ncells, k), or (M,
    ncells, k) for M months' neighbourhoods (``select_loo_neighbors``)."""

    idx: torch.Tensor   # int64 station indices into the tile station pool
    dist: torch.Tensor  # km; 0 where masked
    mask: torch.Tensor  # bool; False entries carry no weight downstream


def _pad_to_k(score, k, fill):
    if score.shape[-1] >= k:
        return score
    pad = torch.full(
        score.shape[:-1] + (k - score.shape[-1],), fill,
        dtype=score.dtype, device=score.device,
    )
    return torch.cat([score, pad], dim=-1)


def select_neighbors(
    cell_lon: torch.Tensor,
    cell_lat: torch.Tensor,
    stn_lon: torch.Tensor,
    stn_lat: torch.Tensor,
    stn_valid: torch.Tensor,
    k: int,
    exclude_self_km: float = 0.0,
    dist_matrix: torch.Tensor | None = None,
    cos_matrix: torch.Tensor | None = None,
    exclude_idx: torch.Tensor | None = None,
) -> Neighborhood:
    """k nearest valid stations for each cell.

    Two branches, as in the reference: the cheap cosine-score branch (one
    matmul on the unit-sphere embedding, exact distances recomputed for the
    chosen k) when neither ``dist_matrix`` nor ``exclude_self_km`` is given,
    else the exact-distance branch. ``exclude_idx`` (ncells,) leaves one
    station out of each query's neighbourhood by index: the leave-one-out
    rule of the x-val stages and krig-params, where the queries are the
    pool. It removes that station only, the reference's remove-by-station
    rule: another station at identical coordinates (a twin) stays and enters
    the neighbourhood at distance 0, as in the JAX package.
    ``exclude_self_km`` leaves out stations within that distance (exact
    branch only), twins included.
    """
    with span("geo.select_neighbors"):
        S = stn_lon.shape[0]
        if cos_matrix is not None and exclude_self_km > 0.0:
            raise ValueError(
                "exclude_self_km requires the exact-distance branch; pass "
                "dist_matrix (or neither matrix), not cos_matrix"
            )
        cols = torch.arange(S, device=stn_lon.device)
        if cos_matrix is not None or (dist_matrix is None and exclude_self_km == 0.0):
            if cos_matrix is None:
                cos_matrix = unit_xyz(cell_lon, cell_lat) @ unit_xyz(stn_lon, stn_lat).T
            neg_inf = float("-inf")
            score = cos_matrix.masked_fill(~stn_valid[None, :], neg_inf)
            if exclude_idx is not None:
                score = score.masked_fill(cols[None, :] == exclude_idx[:, None], neg_inf)
            score = _pad_to_k(score, k, neg_inf)
            top_score, idx = torch.topk(score, k, dim=-1, largest=True, sorted=True)
            idx = torch.clamp(idx, max=S - 1)
            mask = torch.isfinite(top_score)
            dist = great_circle_km(
                cell_lon[:, None], cell_lat[:, None], stn_lon[idx], stn_lat[idx]
            )
            dist = torch.where(mask, dist, torch.zeros_like(dist))
            return Neighborhood(idx=idx, dist=dist, mask=mask)

        if dist_matrix is None:
            dist_matrix = pairwise_great_circle_km(cell_lon, cell_lat, stn_lon, stn_lat)
        inf = float("inf")
        d = dist_matrix.masked_fill(~stn_valid[None, :], inf)
        if exclude_self_km > 0.0:
            d = d.masked_fill(d <= exclude_self_km, inf)
        if exclude_idx is not None:
            d = d.masked_fill(cols[None, :] == exclude_idx[:, None], inf)
        d = _pad_to_k(d, k, inf)
        dist, idx = torch.topk(d, k, dim=-1, largest=False, sorted=True)
        idx = torch.clamp(idx, max=S - 1)
        mask = torch.isfinite(dist)
        dist = torch.where(mask, dist, torch.zeros_like(dist))
        return Neighborhood(idx=idx, dist=dist, mask=mask)


def select_loo_neighbors(
    lon: torch.Tensor,
    lat: torch.Tensor,
    valid: torch.Tensor,
    k: int,
) -> Neighborhood:
    """Every month's leave-one-out neighbourhoods of a pool whose stations
    are also the queries: for lon/lat (S,) and valid (S, M), the k best
    cosine-scored stations valid in month m other than the query itself, as
    one ``Neighborhood`` of (M, S, k) tensors. The cosine branch of
    ``select_neighbors`` with the pool as cells and ``exclude_idx =
    arange(S)``, a month at a time, gives the same (the remove-by-station
    rule: a twin stays, at distance 0), up to the order of near-equal
    scores on the card. One ``kernels.loo_select.loo_select`` call for all
    M months (one launch on CUDA, with no S x S matrix); ``dist`` is
    recomputed from the chosen idx as ``select_neighbors`` does, ``mask``
    is where the score is finite. One ``geo.select_neighbors`` span, keyed
    by M, covers the call."""
    with span("geo.select_neighbors", valid.shape[1]):
        score, idx = loo_select(unit_xyz(lon, lat), valid.contiguous(), k)
        mask = torch.isfinite(score)
        dist = great_circle_km(lon[:, None], lat[:, None], lon[idx], lat[idx])
        dist = torch.where(mask, dist, torch.zeros_like(dist))
        return Neighborhood(idx=idx, dist=dist, mask=mask)


def distance_weights(
    dist: torch.Tensor,
    mask: torch.Tensor,
    kernel: str = "bisquare",
    bandwidth_scale: float = 1.0,
) -> torch.Tensor:
    """Adaptive-bandwidth distance kernel weights, (..., k) -> (..., k).

    Bandwidth per cell = max masked neighbour distance * bandwidth_scale.
    Masked entries get exactly 0 weight.
    """
    zero = torch.zeros_like(dist)
    big = torch.amax(torch.where(mask, dist, zero), dim=-1, keepdim=True)
    bw = torch.clamp(big * bandwidth_scale, min=1e-3)
    if kernel == "bisquare":
        r = torch.clamp(dist / bw, max=1.0)
        w = torch.clamp((1.0 - r**2) ** 2, min=1e-4)
    elif kernel == "gaussian":
        w = torch.exp(-0.5 * (dist / bw) ** 2)
    elif kernel == "uniform":
        w = torch.ones_like(dist)
    else:
        raise ValueError(f"unknown kernel {kernel!r}")
    return torch.where(mask, w, zero)
