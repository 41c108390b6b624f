"""Float64 numpy reference of the full per-cell interpolation pipeline (the
port's own copy of the JAX package's ``oracle/pipeline.py``).

The trusted model of what ``interp.point.interp_tile`` must produce, cell by
cell, with the
exact same statistical conventions (adaptive bisquare weights, point-centered
scaled GWR design, distance-weighted variogram-parameter interpolation,
ordinary kriging of GWR residuals via the augmented Lagrange system).

Deliberately slow and loopy; used only in tests.
"""

from __future__ import annotations

import numpy as np

from topotpu_torch.oracle.numpy_ref import haversine_km, ok_krige_augmented


def bisquare_weights(dist, bandwidth_scale=1.0):
    bw = max(dist.max() * bandwidth_scale, 1e-3)
    r = np.minimum(dist / bw, 1.0)
    w = (1.0 - r**2) ** 2
    return np.maximum(w, 1e-4)


def centered_wls_gain(cov_nbr, cov_pt, w, ridge=1e-6):
    """Gain row g with the device's centered+scaled design and scaled ridge.

    Returns (g, x0_beta_fn) where prediction = g @ y.
    """
    d = cov_nbr - cov_pt[None, :]
    wsum = w.sum() + 1e-30
    mean = (w[:, None] * d).sum(0) / wsum
    var = (w[:, None] * (d - mean) ** 2).sum(0) / wsum
    scale = np.sqrt(var) + 1e-6
    X = np.concatenate([np.ones((len(w), 1)), d / scale], axis=1)
    p = X.shape[1]
    Xw = X * w[:, None]
    A = Xw.T @ X
    A += (ridge * np.trace(A) / p + 1e-30) * np.eye(p)
    v = np.linalg.solve(A, np.eye(p)[0])
    return w * (X @ v)


def interp_cell_month(
    cell_lon, cell_lat, cell_cov, cell_cov_anom,
    stn_lon, stn_lat, stn_cov, stn_cov_anom, stn_norm, stn_vario,
    k, ridge=1e-6,
):
    """One (cell, month): returns dict with normal, variance, anomaly gain.

    ``stn_cov`` (S, q) trend covariates for this month; ``stn_vario`` (S, 3).
    """
    d_all = haversine_km(cell_lon, cell_lat, stn_lon, stn_lat)
    idx = np.argsort(d_all)[:k]
    dist = d_all[idx]
    w = bisquare_weights(dist)

    # GWR trend via gain row (centered design): trend = g_t @ norms
    g_t = centered_wls_gain(stn_cov[idx], cell_cov, w, ridge)
    trend = float(g_t @ stn_norm[idx])
    # residuals need beta at stations: recompute beta directly
    d_c = stn_cov[idx] - cell_cov[None, :]
    wsum = w.sum() + 1e-30
    mean = (w[:, None] * d_c).sum(0) / wsum
    var = (w[:, None] * (d_c - mean) ** 2).sum(0) / wsum
    scale = np.sqrt(var) + 1e-6
    # len(idx) = min(k, S): a pool smaller than k must not crash the oracle
    X = np.concatenate([np.ones((len(idx), 1)), d_c / scale], axis=1)
    p = X.shape[1]
    Xw = X * w[:, None]
    A = Xw.T @ X
    A += (ridge * np.trace(A) / p + 1e-30) * np.eye(p)
    beta = np.linalg.solve(A, Xw.T @ stn_norm[idx])
    resid = stn_norm[idx] - X @ beta

    # cell variogram params: weight-interpolated
    vp = (w[:, None] * stn_vario[idx]).sum(0) / wsum
    nug, psill, rng_km = max(vp[0], 0.0), max(vp[1], 1e-6), max(vp[2], 1e-2)

    dpair = haversine_km(
        stn_lon[idx][:, None], stn_lat[idx][:, None],
        stn_lon[idx][None, :], stn_lat[idx][None, :],
    )
    np.fill_diagonal(dpair, 0.0)
    pred_r, var_krig, lam = ok_krige_augmented(dpair, dist, resid, nug, psill, rng_km)

    g_anom = centered_wls_gain(stn_cov_anom[idx], cell_cov_anom, w, ridge)
    return {
        "normal": trend + pred_r,
        "variance": max(var_krig, 0.0),
        "trend": trend,
        "idx": idx,
        "gain_anom": g_anom,
        "vario": (nug, psill, rng_km),
    }


def interp_tile_oracle(world, cells_rc, k, stn_vario, month_of_day):
    """Interpolate a list of (row, col) cells of a SyntheticWorld.

    Returns dict of arrays: normal (12, C), se (12, C), daily (C, ndays).
    """
    rows = np.array([r for r, _ in cells_rc])
    cols = np.array([c for _, c in cells_rc])
    lon, lat = world.grid.cell_lonlat(rows, cols)
    C = len(rows)
    ndays = world.stn_anoms.shape[1]

    # x scale from the network's mean latitude (the device path derives the
    # same reference from its station pool; see interp/point.py)
    kx = 111.32 * np.cos(np.deg2rad(float(world.stn_lat.mean())))
    stn_x = world.stn_lon * kx
    stn_y = world.stn_lat * 111.32
    cell_x = lon * kx
    cell_y = lat * 111.32

    normal = np.zeros((12, C))
    se = np.zeros((12, C))
    daily = np.zeros((C, ndays))

    for ci in range(C):
        r, c = rows[ci], cols[ci]
        for m in range(12):
            # trend design: covariates only (must match interp/point.py)
            stn_cov = np.stack(
                [world.stn_elev, world.stn_tdi, world.stn_lst[:, m]], 1
            )
            cell_cov = np.array(
                [world.elev[r, c], world.tdi[r, c], world.lst[m, r, c]]
            )
            stn_cov_anom = np.stack([world.stn_elev, stn_x, stn_y], 1)
            cell_cov_anom = np.array([world.elev[r, c], cell_x[ci], cell_y[ci]])
            res = interp_cell_month(
                lon[ci], lat[ci], cell_cov, cell_cov_anom,
                world.stn_lon, world.stn_lat, stn_cov, stn_cov_anom,
                world.stn_norm[:, m], stn_vario[:, m, :], k,
            )
            normal[m, ci] = res["normal"]
            se[m, ci] = np.sqrt(res["variance"])
            dsel = month_of_day == m
            anoms = res["gain_anom"] @ world.stn_anoms[res["idx"]][:, dsel]
            daily[ci, dsel] = res["normal"] + anoms
    return {"normal": normal, "se": se, "daily": daily}
