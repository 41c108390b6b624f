"""Cross-validation and the neighbourhood-size optimisation (port of
``topotpu.interp.xval``).

* ``xval_interp_normals``: leave each station out, krige its monthly normals
  from the others, score MAE, bias and R^2 per month;
* ``xval_interp_daily``: the same for daily values (normals + GWR anomalies);
* ``optimize_nnghs`` / ``optimize_nnghs_anoms``: sweep the normals or the
  anomaly neighbourhood size and pick, per region, the smallest k within one
  standard error of the best per-station MAE;
* ``xval_infill``: hold out observed daily entries, infill the network
  (``topotpu_torch.infill``) and score the held-out entries.

Leave-one-out is one batched run per month on the device: the "cells" are
the station locations, and each station is left out of its own
neighbourhood by index (``select_loo_neighbors``, the 12 months in one call:
one ``loo_select`` launch on the card). That is the
reference's remove-by-station rule, and it removes only the station itself:
a second station at identical coordinates (a twin) stays in the pool and
enters the neighbourhood at distance 0 with the largest weight, exactly as
in the JAX package. The 12 months' normals run through one call of
``kernels.krig_normals.krig_normals_indexed`` (the CUDA ``krig_normals``
kernel on the card, one launch per x-val run), the stations being both the
station table's rows and the cells. Inputs are numpy station arrays; they go
to ``device`` once and the results stay there. What the daily x-val's runs
share whatever their ka (the station tensors, the month-grouped anomalies,
the 12 neighbourhoods and tables at the normals k) is made once a sweep
(``_daily_inputs``), then each ka is one launch, its contractions and its
scoring (``_loo_daily``). The normals' x-val brings its
(S, 12) errors back for the numpy scoring, which is the JAX package's; the
daily x-val scores its predictions on ``device`` in their month-grouped
layout (``_score_daily``) and brings back only the per-station MAEs and 15
scalars, in one transfer.
"""

from __future__ import annotations

import dataclasses
import types

import numpy as np
import torch

from topotpu_torch.core.config import InterpParams, PPCAParams
from topotpu_torch.geo.distance import unit_xyz
from topotpu_torch.geo.neighbors import select_loo_neighbors
from topotpu_torch.interp.anoms import predict_daily_gathered
from topotpu_torch.interp.convert import to_tensor
from topotpu_torch.interp.point import _local_xy_km, group_days_by_month, month_layout
from topotpu_torch.kernels.krig_normals import cell_table, krig_normals_indexed, station_table
from topotpu_torch.utils.profiling import span


@dataclasses.dataclass
class XvalScores:
    mae: np.ndarray    # (12,)
    bias: np.ndarray   # (12,)
    r2: np.ndarray     # (12,)
    per_station_err: np.ndarray  # (S, 12) prediction - truth, NaN where unscored


def _stations(device, stn_lon, stn_lat, stn_elev, stn_tdi, stn_lst, stn_norm, stn_vario,
              stn_valid):
    f = lambda a: to_tensor(a, device)  # noqa: E731
    return dict(lon=f(stn_lon), lat=f(stn_lat), elev=f(stn_elev), tdi=f(stn_tdi),
                lst=f(stn_lst), norm=f(stn_norm), vario=f(stn_vario),
                valid=to_tensor(stn_valid, device, torch.bool))


def _loo_systems(st, k: int):
    """Every month's leave-one-out neighbourhoods and the arguments of
    ``krig_normals_indexed`` that solve them: 12 neighbourhoods (one a month,
    by that month's validity, a station never its own neighbour; one
    ``select_loo_neighbors`` call) and the 12 systems of the one variable,
    the stations being both the table's rows and the cells. Returns the
    neighbourhoods ((12, S, k) tensors) and (idx, dist, mask, table, cells,
    pairs, shared)."""
    lon, lat = st["lon"], st["lat"]
    ref_lat = torch.mean(lat)
    x, y = _local_xy_km(lon, lat, ref_lat)
    table = station_table(st["elev"], st["tdi"], x, y, unit_xyz(lon, lat), st["lst"],
                          [(st["norm"], st["vario"])])
    cells = cell_table(st["elev"], st["tdi"], x, y, st["lst"])
    nbrs = select_loo_neighbors(lon, lat, st["valid"], k)
    return nbrs, (*nbrs, table, cells, [(m, 0) for m in range(12)], False)


def _loo_normals(args, params: InterpParams, k_anom: int | None = None):
    """Every month's leave-one-out kriged normals at every station, in one
    call of ``krig_normals_indexed`` on ``_loo_systems``' arguments ``args``.
    Returns the normals (12, S), the ok flags (12, S) and the anomaly gain
    rows (12, S, k) of the first ``k_anom`` slots (all k by default)."""
    head, gains = krig_normals_indexed(
        *args, k_anom=k_anom, weight_kernel=params.weight_kernel, ridge=params.ridge,
        jitter_frac=params.chol_jitter, min_neighbors=params.min_neighbors,
    )
    return head[..., 0], head[..., 2] > 0.5, gains


def xval_interp_normals(
    stn_lon, stn_lat, stn_elev, stn_tdi, stn_lst, stn_norm, stn_vario,
    stn_valid, params: InterpParams, device: torch.device | str,
) -> XvalScores:
    """Leave-one-station-out normals interpolation, batched over stations.

    lon/lat/elev/tdi (S,), lst/norm/valid (S, 12), vario (S, 12, 3), numpy.
    """
    st = _stations(device, stn_lon, stn_lat, stn_elev, stn_tdi, stn_lst, stn_norm, stn_vario,
                   stn_valid)
    _, args = _loo_systems(st, params.k_neighbors)
    normal, ok, _ = _loo_normals(args, params)
    errs = (normal.T - st["norm"]).cpu().numpy()
    oks = ok.T.cpu().numpy()

    # score only entries valid this month AND solved (a failed solve's
    # normal grades solve failure, not interpolation skill), with finite
    # truth and error (a station's stale or NaN stored normal is unscorable)
    truth = np.asarray(stn_norm, np.float32)
    use = np.asarray(stn_valid, bool) & oks & np.isfinite(truth) & np.isfinite(errs)
    maes, biases, r2s = [], [], []
    for m in range(12):
        e = errs[use[:, m], m]
        t = truth[use[:, m], m]
        if e.size == 0:
            maes.append(np.nan)
            biases.append(np.nan)
            r2s.append(np.nan)
            continue
        maes.append(np.abs(e).mean())
        biases.append(e.mean())
        ss_res = (e**2).sum()
        ss_tot = ((t - t.mean()) ** 2).sum() + 1e-12
        r2s.append(1.0 - ss_res / ss_tot)
    return XvalScores(
        mae=np.array(maes), bias=np.array(biases), r2=np.array(r2s),
        per_station_err=np.where(use, errs, np.nan),
    )


def xval_interp_daily(
    stn_lon, stn_lat, stn_elev, stn_tdi, stn_lst, stn_norm, stn_vario,
    stn_valid, stn_anoms, month_idx, params: InterpParams,
    device: torch.device | str,
) -> dict:
    """Leave-one-station-out x-val of daily values (normals + GWR anomalies).

    stn_anoms: (S, T) serially complete daily anomalies; month_idx: (T,).
    The anomaly neighbourhood is the distance-sorted prefix of
    ``k_neighbors_anom`` slots of the normals one; its gain rows come from
    the normals' launch, with covariates (elev, x_km, y_km) at the pool-mean
    latitude, as on the tile path.
    """
    inputs = _daily_inputs(device, stn_lon, stn_lat, stn_elev, stn_tdi, stn_lst, stn_norm,
                           stn_vario, stn_valid, stn_anoms, month_idx, params.k_neighbors, 1)
    return _loo_daily(inputs, params)


def _daily_inputs(device, stn_lon, stn_lat, stn_elev, stn_tdi, stn_lst, stn_norm, stn_vario,
                  stn_valid, stn_anoms, month_idx, k: int, runs: int):
    """What every daily leave-one-out run over these stations shares,
    whatever its ka, on ``device``: the station tensors, the anomalies
    grouped by month (12, S, dpm), the slots that hold a day (12, dpm), and
    ``_loo_systems`` at the normals ``k``. ``runs``, the number of runs it
    serves, keys its span."""
    with span("xval.daily_inputs", runs):
        st = _stations(device, stn_lon, stn_lat, stn_elev, stn_tdi, stn_lst, stn_norm, stn_vario,
                       stn_valid)
        layout = month_layout(types.SimpleNamespace(month_idx=month_idx, ndays=len(month_idx)))
        anoms_g = group_days_by_month(np.asarray(stn_anoms, np.float32), layout)
        anoms_g = to_tensor(np.moveaxis(anoms_g, 1, 0), device)  # (12, S, dpm)
        nbrs, args = _loo_systems(st, k)
        return types.SimpleNamespace(st=st, anoms_g=anoms_g, nbrs=nbrs, args=args,
                                     day_valid=to_tensor(layout.day_valid, device, torch.bool))


def _loo_daily(inputs, params: InterpParams) -> dict:
    """One daily leave-one-out run on ``_daily_inputs``' ``inputs`` (made at
    ``params.k_neighbors``): the normals and the gain rows of the first
    ``k_neighbors_anom`` slots in one launch, each month's gathered
    contraction on that prefix of the shared neighbourhoods, the scores."""
    with span("xval.loo_daily", params.k_neighbors_anom):
        ka = min(params.k_neighbors_anom, params.k_neighbors)
        normal, ok, gains = _loo_normals(inputs.args, params, ka)
        idx, mask = inputs.nbrs.idx[..., :ka], inputs.nbrs.mask[..., :ka]
        preds = [
            normal[m][:, None] + predict_daily_gathered(
                gains[m][:, :ka], idx[m], mask[m], inputs.anoms_g[m])
            for m in range(12)
        ]
        return _score_daily(preds, inputs.st["norm"], inputs.anoms_g, inputs.st["valid"], ok,
                            inputs.day_valid)


def _score_daily(preds, norm, anoms_g, valid, ok, day_valid) -> dict:
    """The daily LOO scores, on the predictions' device and in their
    month-grouped layout: ``preds`` the 12 months' (S, dpm) predictions,
    ``norm`` (S, 12) stored normals, ``anoms_g`` (12, S, dpm) anomalies (the
    truth is normal + anomaly), ``valid`` (S, 12) and ``ok`` (12, S) flags,
    ``day_valid`` (12, dpm) the slots that hold a day.

    Only stations valid and solved in every month are scored, over the days
    ``day_valid`` marks; both masks select (``torch.where``), so nothing in a
    pad slot or an unscored station reaches a sum, while a NaN truth of a
    scored station propagates (plain sums). The errors are float32, their sums
    float64. One transfer brings back the (S,) sums and the 15 scalars.
    Returns MAE, bias and RMSE (floats), ``mae_by_month`` (12 floats) and
    ``per_station_mae`` ((S,) numpy, NaN where unscored); NaN with no scored
    station."""
    with span("xval.score"):
        f64 = torch.float64
        vmask = valid.all(1) & ok.all(0)  # (S,)
        rows = []
        for m in range(12):
            e = preds[m] - (norm[:, m, None] + anoms_g[m])
            e = torch.where(day_valid[m], e, 0.0).to(f64)
            rows.append(torch.stack([e.abs().sum(1), e.sum(1), (e * e).sum(1)]))
        rows = torch.stack(rows)  # (12, 3, S): |e|, e, e^2 summed over each month's days
        days = day_valid.sum(1).to(f64)  # (12,)
        n_days = days.sum()
        scored = torch.where(vmask, rows, 0.0).sum(-1)  # (12, 3)
        total = scored.sum(0) / (vmask.sum() * n_days)
        packed = torch.cat([
            torch.where(vmask, rows[:, 0].sum(0) / n_days, torch.nan),
            scored[:, 0] / (vmask.sum() * days),
            total[:2], total[2:].sqrt(),
        ])
    with span("xval.fetch"):
        host = packed.cpu().numpy()
    S = len(host) - 15
    mae, bias, rmse = (float(v) for v in host[S + 12:])
    return {
        "mae": mae,
        "bias": bias,
        "rmse": rmse,
        "mae_by_month": [float(v) for v in host[S:S + 12]],
        "per_station_mae": host[:S],
    }


def xval_infill(
    obs: np.ndarray,
    month_idx: np.ndarray,
    params: PPCAParams,
    holdout_frac: float = 0.2,
    seed: int = 0,
    stn_lon=None,
    stn_lat=None,
    *,
    device: torch.device | str,
) -> dict:
    """Hold out observed entries, infill on ``device``, score the held-out
    entries (BASELINE config #3's protocol). The hold-out is drawn in numpy
    from ``seed`` exactly as in the JAX package, so both hold out the same
    entries."""
    from topotpu_torch.infill import infill_network  # the infill package imports interp

    rng = np.random.default_rng(seed)
    observed = np.isfinite(obs)
    hold = observed & (rng.uniform(size=obs.shape) < holdout_frac)
    obs_masked = np.where(hold, np.nan, obs)
    res = infill_network(obs_masked, month_idx, params, stn_lon=stn_lon, stn_lat=stn_lat,
                         device=device)
    err = (res.filled - obs)[hold]
    return {
        "mae": float(np.abs(err).mean()),
        "bias": float(err.mean()),
        "rmse": float(np.sqrt((err**2).mean())),
        "n_holdout": int(hold.sum()),
        "result": res,
    }


def _pick_k(scores: dict, fallback: int, parsimony: bool) -> int:
    """Choose k from {k: (mean_mae, se)}: with ``parsimony`` the smallest k
    whose mean MAE is within one standard error of the best (the 1-SE rule),
    else the argmin; ``fallback`` when nothing was scored."""
    if not scores:
        return fallback
    kbest = min(scores, key=lambda k: scores[k][0])
    if not parsimony:
        return int(kbest)
    bar = scores[kbest][0] + scores[kbest][1]
    return int(min(k for k in scores if scores[k][0] <= bar))


def _mean_se(vals: np.ndarray):
    """(mean, standard error) over finite entries; None if empty."""
    vals = vals[np.isfinite(vals)]
    if not vals.size:
        return None
    se = float(vals.std(ddof=1) / np.sqrt(vals.size)) if vals.size > 1 else 0.0
    return float(vals.mean()), se


def optimize_nnghs(
    stn_lon, stn_lat, stn_elev, stn_tdi, stn_lst, stn_norm, stn_vario,
    stn_valid,
    candidates=(8, 16, 24, 32, 48),
    region_labels: np.ndarray | None = None,
    base_params: InterpParams | None = None,
    parsimony: bool = True,
    *,
    device: torch.device | str,
) -> dict:
    """Sweep the normals neighbourhood size by LOO x-val; per region the
    smallest k within one SE of the best per-station MAE (``parsimony=False``
    -> bare argmin). ``region_labels`` (S,) ints, None = one region.

    Returns {"best": {region: k}, "mae": {k: (12,)}, "per_station_err":
    {k: (S, 12)}}."""
    with span("xval.sweep_normals"):
        base = base_params or InterpParams()
        if region_labels is None:
            region_labels = np.zeros(len(stn_lon), int)
        mae_by_k, err_by_k = {}, {}
        for k in candidates:
            sc = xval_interp_normals(
                stn_lon, stn_lat, stn_elev, stn_tdi, stn_lst, stn_norm, stn_vario,
                stn_valid, dataclasses.replace(base, k_neighbors=int(k)), device,
            )
            mae_by_k[int(k)] = sc.mae
            err_by_k[int(k)] = sc.per_station_err

        best = {}
        for r in np.unique(region_labels):
            in_r = region_labels == r
            # per-station MAE over its finite months first: the station is the
            # independent unit of the 1-SE bar
            scores = {}
            for k, errs in err_by_k.items():
                err = np.abs(errs[in_r])
                fin = np.isfinite(err)
                cnt = fin.sum(axis=1)
                stn_mae = np.where(cnt > 0, np.where(fin, err, 0.0).sum(axis=1)
                                   / np.maximum(cnt, 1), np.nan)
                ms = _mean_se(stn_mae)
                if ms is not None:
                    scores[k] = ms
            best[int(r)] = _pick_k(scores, int(base.k_neighbors), parsimony)
        return {"best": best, "mae": mae_by_k, "per_station_err": err_by_k}


def optimize_nnghs_anoms(
    stn_lon, stn_lat, stn_elev, stn_tdi, stn_lst, stn_norm, stn_vario,
    stn_valid, stn_anoms, month_idx,
    candidates=(8, 16, 24, 32),
    region_labels: np.ndarray | None = None,
    base_params: InterpParams | None = None,
    parsimony: bool = True,
    *,
    device: torch.device | str,
) -> dict:
    """Sweep the anomaly (daily GWR) neighbourhood size by daily LOO x-val,
    the normals k held fixed; per region the smallest ka within one SE of the
    best per-station daily MAE (``parsimony=False`` -> bare argmin).

    Returns {"best": {region: ka}, "mae": {ka: float},
    "per_station_mae": {ka: (S,)}}."""
    with span("xval.sweep_anoms"):
        base = base_params or InterpParams()
        if region_labels is None:
            region_labels = np.zeros(len(stn_lon), int)
        candidates = tuple(candidates)
        inputs = _daily_inputs(device, stn_lon, stn_lat, stn_elev, stn_tdi, stn_lst, stn_norm,
                               stn_vario, stn_valid, stn_anoms, month_idx, base.k_neighbors,
                               len(candidates))
        mae_by_k, stn_mae_by_k = {}, {}
        for ka in candidates:
            # the gains use a prefix of the normals neighbourhood: ka <= k
            p = dataclasses.replace(base, k_neighbors_anom=min(int(ka), base.k_neighbors))
            sc = _loo_daily(inputs, p)
            mae_by_k[int(ka)] = sc["mae"]
            stn_mae_by_k[int(ka)] = sc["per_station_mae"]

        best = {}
        for r in np.unique(region_labels):
            in_r = region_labels == r
            scores = {}
            for k, stn_mae in stn_mae_by_k.items():
                ms = _mean_se(stn_mae[in_r])
                if ms is not None:
                    scores[k] = ms
            best[int(r)] = _pick_k(scores, min(base.k_neighbors_anom, base.k_neighbors),
                                   parsimony)
        return {"best": best, "mae": mae_by_k, "per_station_mae": stn_mae_by_k}
