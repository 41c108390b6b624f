"""Station-series infilling pipeline (port of ``topotpu.infill.pipeline``).

For every station, build a predictor matrix from its most-correlated
neighbour series, run PPCA imputation over the joint matrix
(``topotpu_torch.stats.ppca``), adjust the imputed variance, and emit a
serially complete daily series plus monthly normals.

The (S, T) station tensors go to ``device`` once; each batch gathers its
[target | predictors] series there from a (B, V) index matrix, and the
filled series stay there until one transfer after the last batch.
Predictor selection runs as numpy on the host for small networks and as
four full-float32 grams plus ``topk`` on ``device`` above that, returning
only the (S, n) indices.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from topotpu_torch.core.config import PPCAParams
from topotpu_torch.core.device import COMPUTE_DTYPE
from topotpu_torch.geo.distance import pairwise_great_circle_km
from topotpu_torch.interp.convert import to_tensor
from topotpu_torch.oracle.numpy_ref import haversine_km
from topotpu_torch.stats.ppca import ppca_impute, variance_adjust
from topotpu_torch.utils.profiling import span


@dataclasses.dataclass
class InfillResult:
    filled: np.ndarray        # (S, T) serially complete series
    obs_mask: np.ndarray      # (S, T) original observation mask
    norms: np.ndarray         # (S, 12) monthly normals from filled series
    n_iters: np.ndarray       # (S,) EM iterations per target
    predictors: np.ndarray    # (S, n_neighbors) chosen predictor indices
    bad: np.ndarray           # (S,) too few obs for a trustworthy infill


def select_predictors(
    obs: np.ndarray,
    mask: np.ndarray,
    n_neighbors: int,
    stn_lon: np.ndarray | None = None,
    stn_lat: np.ndarray | None = None,
    *,
    device: torch.device | str,
) -> np.ndarray:
    """(S, n_neighbors) indices of the most-correlated predictor stations.

    Stations ranked by |correlation| over jointly observed days; pairs with
    fewer than 30 such days score 0, and with coordinates given those slots
    fall back to the nearest stations (a strictly weaker score). Below
    6 S^2 T = 2e11 gram FLOPs the selection is the JAX package's numpy code
    on the host, so small networks answer exactly as there; above it,
    ``_device_select_predictors`` runs on ``device``."""
    mu = np.nanmean(np.where(mask, obs, np.nan), axis=1)
    sd = np.nanstd(np.where(mask, obs, np.nan), axis=1) + 1e-6
    xs = np.where(mask, (obs - mu[:, None]) / sd[:, None], 0.0).astype(np.float32)
    S, T = xs.shape
    # a station can have at most S-1 distinct predictors
    n_neighbors = min(int(n_neighbors), S - 1)

    if 6.0 * S * S * T < 2e11:
        m = mask.astype(np.float32)
        n = m @ m.T
        sx = xs @ m.T
        sxy = xs @ xs.T
        sxx = (xs * xs) @ m.T
        safe_n = np.maximum(n, 1.0)
        cov = sxy / safe_n - (sx / safe_n) * (sx.T / safe_n)
        vx = np.maximum(sxx / safe_n - (sx / safe_n) ** 2, 1e-12)
        score = np.abs(np.where(n < 30, 0.0, cov / np.sqrt(vx * vx.T)))
        if stn_lon is not None:
            d = haversine_km(
                stn_lon[:, None], stn_lat[:, None],
                stn_lon[None, :], stn_lat[None, :],
            )
            # proximity as a strictly weaker tiebreak: any real correlation
            # wins over any pure-distance candidate
            prox = 1e-4 / (1.0 + d)
            score = np.where(score > 0, score + 1.0, prox)
        np.fill_diagonal(score, -1.0)  # never select self
        part = np.argpartition(-score, n_neighbors, axis=1)[:, :n_neighbors]
        rows = np.arange(S)[:, None]
        order = np.argsort(-score[rows, part], axis=1, kind="stable")
        return part[rows, order].astype(np.int32)

    if stn_lon is None:
        # the distance tiebreak never beats a real correlation, so zeros
        # only affect the sparse-overlap fallback
        lon = lat = np.zeros(S, np.float32)
    else:
        lon, lat = stn_lon, stn_lat
    return _device_select_predictors(xs, mask, lon, lat, stn_lon is not None, n_neighbors,
                                     device)


def _device_select_predictors(xs, mask, lon, lat, use_dist, n_neighbors, device):
    """The device branch of ``select_predictors``: (S, T) float32
    standardised series ``xs`` and bool ``mask`` (uploaded as bool, widened
    on the device) -> (S, n_neighbors) int32 numpy indices, best first.
    Counts its calls in ``_device_select_predictors.calls``."""
    _device_select_predictors.calls += 1
    xs = to_tensor(xs, device)
    m = to_tensor(mask, device, torch.bool).to(COMPUTE_DTYPE)
    # full-float32 grams (TF32 is off): reduced precision would flip
    # near-tied correlations and part this branch from the numpy one
    n = m @ m.T
    sx = xs @ m.T
    sxy = xs @ xs.T
    sxx = (xs * xs) @ m.T
    del m
    sy, syy = sx.T, sxx.T
    safe_n = torch.clamp(n, min=1.0)
    cov = sxy / safe_n - (sx / safe_n) * (sy / safe_n)
    vx = torch.clamp(sxx / safe_n - (sx / safe_n) ** 2, min=1e-12)
    vy = torch.clamp(syy / safe_n - (sy / safe_n) ** 2, min=1e-12)
    score = torch.abs(torch.where(n < 30, 0.0, cov * torch.rsqrt(vx * vy)))
    del sx, sxy, sxx, sy, syy, safe_n, cov, vx, vy, n
    if use_dist:
        lon, lat = to_tensor(lon, device), to_tensor(lat, device)
        prox = 1e-4 / (1.0 + pairwise_great_circle_km(lon, lat, lon, lat))
        score = torch.where(score > 0, score + 1.0, prox)
    score.fill_diagonal_(-1.0)  # never select self
    idx = torch.topk(score, n_neighbors, dim=1).indices
    return idx.to(torch.int32).cpu().numpy()


_device_select_predictors.calls = 0


def _infill_batch(obs_all, mask_all, cols, month_idx, n_comp, max_iters, tol):
    """Gather [target | predictors] series on the device, impute, adjust.

    obs_all/mask_all are the full (S, T) station tensors; ``cols`` is the
    (B, V) station-index tensor of this batch (column 0 = target). Returns
    the (B, T) adjusted target series and the (B,) EM iteration counts."""
    Y = obs_all[cols].transpose(1, 2).contiguous()   # (B, T, V)
    M = mask_all[cols].transpose(1, 2).contiguous()
    res = ppca_impute(Y, M, n_components=n_comp, max_iters=max_iters, tol=tol)
    tgt_filled = variance_adjust(res.filled[..., 0], mask_all[cols[:, 0]], month_idx)
    return tgt_filled, res.n_iters


def infill_network(
    obs: np.ndarray,
    month_idx: np.ndarray,
    params: PPCAParams,
    batch_size: int | None = None,
    stn_lon: np.ndarray | None = None,
    stn_lat: np.ndarray | None = None,
    min_obs_days: int = 365,
    *,
    device: torch.device | str,
) -> InfillResult:
    """Serially complete an (S, T) obs matrix (NaN = missing) on ``device``.

    Targets run in batches of ``batch_size``; each target's predictor matrix
    is [target | n_neighbors correlated stations]. Stations with fewer than
    ``min_obs_days`` observations (or half the span, if less) are imputed
    but flagged ``bad``."""
    with span("infill.call"):
        if batch_size is None:
            batch_size = params.batch_size
        S, T = obs.shape
        mask = np.isfinite(obs)
        obs0 = np.where(mask, obs, 0.0).astype(np.float32)
        with span("infill.select_predictors"):
            preds = select_predictors(obs, mask, params.n_neighbors, stn_lon, stn_lat,
                                      device=device)
        bad = mask.sum(axis=1) < min(min_obs_days, T // 2)

        V = 1 + preds.shape[1]  # select_predictors clamps to S-1 on tiny pools
        n_comp = min(params.n_components, V - 1)
        obs_dev = to_tensor(obs0, device)
        mask_dev = to_tensor(mask, device, torch.bool)
        midx_dev = to_tensor(month_idx, device, torch.int64)
        preds_dev = to_tensor(preds, device, torch.int64)
        filled = obs_dev.clone()
        n_iters = torch.zeros(S, dtype=torch.int32, device=obs_dev.device)

        pad_to = ((S + batch_size - 1) // batch_size) * batch_size
        # a batch's EM runs until its slowest element converges, so similar
        # targets (by observation count) share batches; per-target results do
        # not depend on the batch, so this is pure scheduling
        by_difficulty = np.argsort(mask.sum(axis=1), kind="stable").astype(np.int64)
        # the padding wraps round to the first targets
        order = to_tensor(by_difficulty[np.arange(pad_to) % S], device, torch.int64)
        for start in range(0, pad_to, batch_size):
            with span("infill.batch", start // batch_size):
                tgt = order[start : start + batch_size]
                cols = torch.cat([tgt[:, None], preds_dev[tgt]], dim=1)  # (B, V)
                tf, ni = _infill_batch(obs_dev, mask_dev, cols, midx_dev, n_comp,
                                       params.max_iters, params.tol)
                filled[tgt] = tf  # wrapped padding targets recompute identically
                n_iters[tgt] = ni

        with span("infill.fetch"):
            filled_host, iters_host = filled.cpu().numpy(), n_iters.cpu().numpy()
        with span("infill.normals"):
            norms = monthly_normals(filled, month_idx, device)
        return InfillResult(
            filled=filled_host,
            obs_mask=mask,
            norms=norms,
            n_iters=iters_host,
            predictors=preds,
            bad=bad,
        )


def monthly_normals(series, month_idx: np.ndarray, device: torch.device | str) -> np.ndarray:
    """(S, T) complete series (numpy or a tensor) -> (S, 12) monthly normals,
    computed on ``device``."""
    x = to_tensor(series, device)
    midx = to_tensor(month_idx, device, torch.int64)
    return torch.stack([x[:, midx == m].mean(dim=1) for m in range(12)], dim=1).cpu().numpy()
