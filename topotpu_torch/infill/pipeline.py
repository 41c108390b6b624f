"""Station-series infilling pipeline (port of ``topotpu.infill.pipeline``).

For every target station (by default every station of the network; with
``targets``, those stations only, each against the whole network), build a
predictor matrix from its most-correlated neighbour series, run PPCA
imputation over the joint matrix (``topotpu_torch.stats.ppca``), adjust the
imputed variance, and emit a serially complete daily series plus monthly
normals.

The (S, T) station tensors go to ``device`` once a call; each batch gathers
its [target | predictors] series there from a (B, V) index matrix, and the
targets' filled series stay there until one transfer after the last batch.
Predictor selection computes only the targets' rows of the (S, S) grams: as
numpy on the host while 6 n_t S T (n_t targets) stays under
``DEVICE_SELECT_FLOPS``, and as full-float32 grams plus ``topk`` on
``device`` from there, returning only the (n_t, n) indices.
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

# gram operations (6 n_t S T) from which select_predictors runs on the device
DEVICE_SELECT_FLOPS = 2e11


@dataclasses.dataclass
class InfillResult:
    """One row per target: every station, or ``targets`` in their order."""

    filled: np.ndarray        # (n_t, T) serially complete series
    obs_mask: np.ndarray      # (n_t, T) original observation mask
    norms: np.ndarray         # (n_t, 12) monthly normals from filled series
    n_iters: np.ndarray       # (n_t,) EM iterations per target
    predictors: np.ndarray    # (n_t, n_neighbors) chosen predictors, indices into the network
    bad: np.ndarray           # (n_t,) too few obs for a trustworthy infill


def _targets(targets, S: int) -> np.ndarray | None:
    """``targets`` as an int64 index array into S stations (None stays None)."""
    if targets is None:
        return None
    t = np.asarray(targets)
    if t.ndim != 1 or not len(t) or not np.issubdtype(t.dtype, np.integer):
        raise ValueError("targets must be a non-empty 1-D array of station indices")
    if t.min() < 0 or t.max() >= S:
        raise ValueError(f"targets must lie in [0, {S})")
    return t.astype(np.int64)


def select_predictors(
    obs: np.ndarray,
    mask: np.ndarray,
    n_neighbors: int,
    stn_lon: np.ndarray | None = None,
    stn_lat: np.ndarray | None = None,
    *,
    device: torch.device | str,
    targets: np.ndarray | None = None,
) -> np.ndarray:
    """(n_t, n_neighbors) indices of the most-correlated predictor stations
    of each target, best first: every station (n_t = S), or the stations
    ``targets`` in their order, each ranked against the whole network.

    Stations ranked by |correlation| over jointly observed days; pairs with
    fewer than 30 such days score 0, and with coordinates given those slots
    fall back to the nearest stations (a strictly weaker score). A target
    never selects itself. Only the targets' rows of the grams are computed:
    below 6 n_t S T = ``DEVICE_SELECT_FLOPS`` gram operations the selection
    is the JAX package's numpy code on the host, so small networks answer
    exactly as there; from it, ``_device_select_predictors`` runs on
    ``device``."""
    mu = np.nanmean(np.where(mask, obs, np.nan), axis=1)
    sd = np.nanstd(np.where(mask, obs, np.nan), axis=1) + 1e-6
    xs = np.where(mask, (obs - mu[:, None]) / sd[:, None], 0.0).astype(np.float32)
    S, T = xs.shape
    targets = _targets(targets, S)
    n_t = S if targets is None else len(targets)
    # a station can have at most S-1 distinct predictors
    n_neighbors = min(int(n_neighbors), S - 1)

    if 6.0 * n_t * S * T < DEVICE_SELECT_FLOPS:
        m = mask.astype(np.float32)
        if targets is None:
            n = m @ m.T
            sx = xs @ m.T
            sxy = xs @ xs.T
            sxx = (xs * xs) @ m.T
            sy, syy = sx.T, sxx.T
        else:
            xt, mt = xs[targets], m[targets]
            n = mt @ m.T
            sx = xt @ m.T
            sxy = xt @ xs.T
            sxx = (xt * xt) @ m.T
            sy, syy = mt @ xs.T, mt @ (xs * xs).T
        safe_n = np.maximum(n, 1.0)
        cov = sxy / safe_n - (sx / safe_n) * (sy / safe_n)
        vx = np.maximum(sxx / safe_n - (sx / safe_n) ** 2, 1e-12)
        vy = np.maximum(syy / safe_n - (sy / safe_n) ** 2, 1e-12)
        score = np.abs(np.where(n < 30, 0.0, cov / np.sqrt(vx * vy)))
        rows = np.arange(S) if targets is None else targets
        if stn_lon is not None:
            d = haversine_km(
                stn_lon[rows][:, None], stn_lat[rows][:, None],
                stn_lon[None, :], stn_lat[None, :],
            )
            # proximity as a strictly weaker tiebreak: any real correlation
            # wins over any pure-distance candidate
            prox = 1e-4 / (1.0 + d)
            score = np.where(score > 0, score + 1.0, prox)
        score[np.arange(n_t), rows] = -1.0  # never select self
        part = np.argpartition(-score, n_neighbors, axis=1)[:, :n_neighbors]
        at = np.arange(n_t)[:, None]
        order = np.argsort(-score[at, part], axis=1, kind="stable")
        return part[at, order].astype(np.int32)

    if stn_lon is None:
        # the distance tiebreak never beats a real correlation, so zeros
        # only affect the sparse-overlap fallback
        lon = lat = np.zeros(S, np.float32)
    else:
        lon, lat = stn_lon, stn_lat
    return _device_select_predictors(xs, mask, lon, lat, stn_lon is not None, n_neighbors,
                                     device, targets)


def _device_select_predictors(xs, mask, lon, lat, use_dist, n_neighbors, device, targets=None):
    """The device branch of ``select_predictors``: (S, T) float32
    standardised series ``xs`` and bool ``mask`` (uploaded as bool, widened
    on the device) -> (n_t, n_neighbors) int32 numpy indices, best first,
    for every station or for the stations ``targets`` (the (n_t, S) rows of
    the grams only). Counts its calls in ``_device_select_predictors.calls``."""
    _device_select_predictors.calls += 1
    S, T = xs.shape
    targets = _targets(targets, S)
    n_t = S if targets is None else len(targets)
    with span("infill.select.device", (n_t, S, T)):
        xs = to_tensor(xs, device)
        m = to_tensor(mask, device, torch.bool).to(COMPUTE_DTYPE)
        # full-float32 grams (TF32 is off): reduced precision would flip
        # near-tied correlations and part this branch from the numpy one
        if targets is None:
            n = m @ m.T
            sx = xs @ m.T
            sxy = xs @ xs.T
            sxx = (xs * xs) @ m.T
            del m
            sy, syy = sx.T, sxx.T
        else:
            t = to_tensor(targets, device, torch.int64)
            xt, mt = xs[t], m[t]
            n = mt @ m.T
            sx = xt @ m.T
            sxy = xt @ xs.T
            sxx = (xt * xt) @ m.T
            sy = mt @ xs.T
            del m, xt  # before the squares, so that two (S, T) floats are held at most
            syy = mt @ (xs * xs).T
            del mt, xs
        safe_n = torch.clamp(n, min=1.0)
        cov = sxy / safe_n - (sx / safe_n) * (sy / safe_n)
        vx = torch.clamp(sxx / safe_n - (sx / safe_n) ** 2, min=1e-12)
        vy = torch.clamp(syy / safe_n - (sy / safe_n) ** 2, min=1e-12)
        score = torch.abs(torch.where(n < 30, 0.0, cov * torch.rsqrt(vx * vy)))
        del sx, sxy, sxx, sy, syy, safe_n, cov, vx, vy, n
        if use_dist:
            lon, lat = to_tensor(lon, device), to_tensor(lat, device)
            lon_t, lat_t = (lon, lat) if targets is None else (lon[t], lat[t])
            prox = 1e-4 / (1.0 + pairwise_great_circle_km(lon_t, lat_t, lon, lat))
            score = torch.where(score > 0, score + 1.0, prox)
        if targets is None:
            score.fill_diagonal_(-1.0)  # never select self
        else:
            score[torch.arange(n_t, device=score.device), t] = -1.0
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
    targets: np.ndarray | None = None,
) -> InfillResult:
    """Serially complete the series of an (S, T) obs matrix (NaN = missing)
    on ``device``: every station's, or with ``targets`` (an int array of
    station indices) those stations' only, each infilled against the whole
    network given. The result has one row per target, in ``targets``'
    order, and its predictors index the whole network.

    Targets run in batches of ``batch_size``; each target's predictor matrix
    is [target | n_neighbors correlated stations]. Stations with fewer than
    ``min_obs_days`` observations (or half the span, if less) are imputed
    but flagged ``bad``."""
    S, T = obs.shape
    targets = _targets(targets, S)
    n_t = S if targets is None else len(targets)
    with span("infill.call", (n_t, S)):
        if batch_size is None:
            batch_size = params.batch_size
        mask = np.isfinite(obs)
        obs0 = np.where(mask, obs, 0.0).astype(np.float32)
        with span("infill.select_predictors"):
            preds = select_predictors(obs, mask, params.n_neighbors, stn_lon, stn_lat,
                                      device=device, targets=targets)
        tmask = mask if targets is None else mask[targets]
        bad = tmask.sum(axis=1) < min(min_obs_days, T // 2)

        V = 1 + preds.shape[1]  # select_predictors clamps to S-1 on tiny pools
        n_comp = min(params.n_components, V - 1)
        obs_dev = to_tensor(obs0, device)
        mask_dev = to_tensor(mask, device, torch.bool)
        midx_dev = to_tensor(month_idx, device, torch.int64)
        preds_dev = to_tensor(preds, device, torch.int64)
        if targets is None:
            filled = obs_dev.clone()
        else:
            tgt_dev = to_tensor(targets, device, torch.int64)
            filled = obs_dev[tgt_dev]
        n_iters = torch.zeros(n_t, dtype=torch.int32, device=obs_dev.device)

        pad_to = ((n_t + batch_size - 1) // batch_size) * batch_size
        # a batch's EM runs until its slowest element converges, so similar
        # targets (by observation count) share batches; per-target results do
        # not depend on the batch, so this is pure scheduling. Rows of the
        # result (0..n_t-1) are batched; ``tgt`` holds their stations.
        by_difficulty = np.argsort(tmask.sum(axis=1), kind="stable").astype(np.int64)
        # the padding wraps round to the first targets
        order = to_tensor(by_difficulty[np.arange(pad_to) % n_t], device, torch.int64)
        for start in range(0, pad_to, batch_size):
            with span("infill.batch", start // batch_size):
                row = order[start : start + batch_size]
                tgt = row if targets is None else tgt_dev[row]
                cols = torch.cat([tgt[:, None], preds_dev[row]], dim=1)  # (B, V)
                tf, ni = _infill_batch(obs_dev, mask_dev, cols, midx_dev, n_comp,
                                       params.max_iters, params.tol)
                filled[row] = tf  # wrapped padding targets recompute identically
                n_iters[row] = ni

        with span("infill.fetch"):
            filled_host, iters_host = filled.cpu().numpy(), n_iters.cpu().numpy()
        with span("infill.normals"):
            norms = monthly_normals(filled, month_idx, device)
        return InfillResult(
            filled=filled_host,
            obs_mask=tmask,
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
