"""Plain reference of the grid cell: TopoWx's moving-window regression
kriging at sampled cells of the produced region, as the configuration
states it.

For a cell of tile t:
* the pool: the stations inside t's box widened by ``margin_km`` (in
  longitude at t's central latitude), the nearest ``max_tile_stations`` to
  t's centre by squared degrees where more;
* the neighbourhood: the k nearest pool stations by great-circle distance,
  bisquare weights on the k-th distance (floored at 1e-4); ``gap_km``, the
  distance from the k-th to the next, lets the caller leave out a cell whose
  set float32 distances do not determine;
* the normal of month m: a weighted regression of the stations' normals on
  (elevation, TDI, LST of m), centred at the cell and scaled by the weighted
  standard deviations, ridge ``ridge`` x the mean diagonal of the normal
  equations; plus ordinary kriging of its residuals, the augmented (k + 1)
  system, exponential covariance with the weighted mean of the stations'
  (nugget, partial sill, range) and ``chol_jitter`` x the sill on the
  diagonal; se = the root of the kriging variance;
* the daily value: the month's normal plus the weighted regression on
  (elevation, x, y) of the neighbours' anomalies of the day, as a gain row;
  where tmax < tmin, both take their mean.
All of it batched over cells in torch, in ``Prec``'s precision.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from reference.precision import Prec

EARTH_RADIUS_KM = 6371.0087714


def haversine(lon1, lat1, lon2, lat2):
    lon1, lat1, lon2, lat2 = (torch.deg2rad(x) for x in (lon1, lat1, lon2, lat2))
    a = (torch.sin((lat2 - lat1) / 2) ** 2
         + torch.cos(lat1) * torch.cos(lat2) * torch.sin((lon2 - lon1) / 2) ** 2)
    return 2 * EARTH_RADIUS_KM * torch.asin(torch.sqrt(torch.clamp(a, 0, 1)))


def tile_pool(lon, lat, row0, col0, nr, nc, lon0, lat0, cs, margin_km, cap) -> np.ndarray:
    """Station indices of the tile's pool (float64 numpy)."""
    lat_c = lat0 - (row0 + nr / 2) * cs
    lon_c = lon0 + (col0 + nc / 2) * cs
    mlat = margin_km / 111.32
    mlon = margin_km / (111.32 * max(math.cos(math.radians(lat_c)), 0.2))
    inside = ((lat >= lat0 - (row0 + nr) * cs - mlat) & (lat <= lat0 - row0 * cs + mlat)
              & (lon >= lon0 + col0 * cs - mlon) & (lon <= lon0 + (col0 + nc) * cs + mlon))
    cand = np.flatnonzero(inside)
    if len(cand) > cap:
        d2 = (lon[cand] - lon_c) ** 2 + (lat[cand] - lat_c) ** 2
        cand = cand[np.argsort(d2, kind="stable")[:cap]]
    return cand


def _weights(d, k_valid_mask):
    bw = torch.clamp(torch.amax(torch.where(k_valid_mask, d, 0.0), -1, keepdim=True), min=1e-3)
    r = torch.clamp(d / bw, max=1.0)
    return torch.where(k_valid_mask, torch.clamp((1.0 - r ** 2) ** 2, min=1e-4), 0.0)


def _design(cov, cell_cov, w):
    """[1, (cov - cell_cov) / scale] (..., k, p) with the weighted std scale."""
    d = cov - cell_cov[..., None, :]
    wsum = w.sum(-1, keepdim=True) + 1e-30
    mean = (w[..., None] * d).sum(-2) / wsum
    var = (w[..., None] * (d - mean[..., None, :]) ** 2).sum(-2) / wsum
    dn = d / (torch.sqrt(var) + 1e-6)[..., None, :]
    return torch.cat([torch.ones_like(dn[..., :1]), dn], -1)


def _normal_matrix(P, X, w, ridge):
    A = P.einsum("...kp,...k,...kq->...pq", X, w, X)
    p = X.shape[-1]
    diag = torch.diagonal(A, dim1=-2, dim2=-1).sum(-1)[..., None, None] / p
    return A + (ridge * diag + 1e-30) * torch.eye(p, dtype=A.dtype, device=A.device)


def krige(P: Prec, st: dict, cells: dict, idx: np.ndarray, ref_lat: np.ndarray, cfg: dict,
          device, ka: int | None = None) -> dict:
    """The normals chain at n cells, each over its own neighbourhood ``idx``
    (n, k) of station rows: normals (V, n, 12), kriging variance (n, 12), ok
    (V, n, 12), and the anomaly gain rows (n, ka) of the neighbourhood's
    first ``ka`` slots (covariates (elev, x, y) at ``ref_lat``, (n,)).
    ``cells``: lon, lat, elev, tdi (n,), lst (n, 12), numpy."""
    T = lambda x: P.t(x, device)  # noqa: E731
    n, k = idx.shape
    clon, clat = T(cells["lon"]), T(cells["lat"])
    slon, slat = T(st["lon"][idx]), T(st["lat"][idx])
    dist = haversine(clon[:, None], clat[:, None], slon, slat)            # (n, k)
    pair = haversine(slon[:, :, None], slat[:, :, None], slon[:, None, :], slat[:, None, :])
    valid = torch.ones_like(dist, dtype=torch.bool)
    w = _weights(dist, valid)                                             # (n, k)

    # trend and kriging, every month and variable
    elev, tdi, lst = T(st["elev"][idx]), T(st["tdi"][idx]), T(st["lst"][idx])  # lst (n, k, 12)
    c_elev, c_tdi, c_lst = T(cells["elev"]), T(cells["tdi"]), T(cells["lst"])
    cov = torch.stack([elev[:, None].expand(-1, 12, -1), tdi[:, None].expand(-1, 12, -1),
                       lst.transpose(1, 2)], -1)                          # (n, 12, k, 3)
    cell_cov = torch.stack([c_elev[:, None].expand(-1, 12), c_tdi[:, None].expand(-1, 12),
                            c_lst], -1)                                   # (n, 12, 3)
    w12 = w[:, None, :].expand(-1, 12, -1)
    X = _design(cov, cell_cov, w12)                                       # (n, 12, k, 4)
    A = _normal_matrix(P, X, w12, cfg["ridge"])
    y = T(st["norm"][:, idx, :]).permute(0, 1, 3, 2)                      # (V, n, 12, k)
    rhs = P.einsum("nmkp,nmk,vnmk->vnmp", X, w12, y)
    beta = torch.linalg.solve(A[None].expand(y.shape[0], -1, -1, -1, -1), rhs[..., None])[..., 0]
    trend = beta[..., 0]                                                  # (V, n, 12)
    resid = y - P.einsum("nmkp,vnmp->vnmk", X, beta)

    vario = T(st["vario"][idx]).transpose(1, 2)                           # (n, 12, k, 3)
    vp = P.einsum("nmk,nmkp->nmp", w12, vario) / (w12.sum(-1, keepdim=True) + 1e-30)
    nug = torch.clamp(vp[..., 0], min=0.0)
    psill = torch.clamp(vp[..., 1], min=1e-6)
    rng = torch.clamp(vp[..., 2], min=1e-2)
    sill = nug + psill
    Cm = psill[..., None, None] * torch.exp(-pair[:, None] / rng[..., None, None])
    eye = torch.eye(k, dtype=Cm.dtype, device=Cm.device)
    Cm = Cm * (1 - eye) + (sill + cfg["chol_jitter"] * sill)[..., None, None] * eye
    c0 = psill[..., None] * torch.exp(-dist[:, None] / rng[..., None])   # (n, 12, k)
    aug = torch.zeros(Cm.shape[:-2] + (k + 1, k + 1), dtype=Cm.dtype, device=Cm.device)
    aug[..., :k, :k] = Cm
    aug[..., :k, k] = 1.0
    aug[..., k, :k] = 1.0
    b = torch.cat([c0, torch.ones_like(c0[..., :1])], -1)
    sol = torch.linalg.solve(aug, b[..., None])[..., 0]
    lam, mu = sol[..., :k], sol[..., k]
    var = torch.clamp(sill - P.einsum("nmk,nmk->nm", lam, c0) - mu, min=0.0)
    normal = trend + P.einsum("nmk,vnmk->vnm", lam, resid)                # (V, n, 12)
    ok = (valid.sum(-1) >= cfg["min_neighbors"])[:, None] & torch.isfinite(var)
    ok = ok[None].expand_as(normal) & torch.isfinite(normal)

    # anomaly gain rows: (elev, x, y) at the reference latitude
    ka = k if ka is None else ka
    kx = 111.32 * torch.cos(torch.deg2rad(T(ref_lat)))
    wa = _weights(dist[:, :ka], valid[:, :ka])
    acov = torch.stack([elev[:, :ka], slon[:, :ka] * kx[:, None], slat[:, :ka] * 111.32], -1)
    cell_acov = torch.stack([c_elev, clon * kx, clat * 111.32], -1)
    Xa = _design(acov, cell_acov, wa)
    Aa = _normal_matrix(P, Xa, wa, cfg["ridge"])
    e0 = torch.zeros(n, 4, 1, dtype=Aa.dtype, device=Aa.device)
    e0[:, 0] = 1.0
    v = torch.linalg.solve(Aa, e0)[..., 0]
    gain = wa * P.einsum("nkp,np->nk", Xa, v)
    return dict(normal=normal, var=var, ok=ok, gain=gain)


def reference(st: dict, region: dict, cfg: dict, rows, cols, chunks, prec: str, device):
    """Normals, se, ok flags (V, 12, n) and, per chunk (t0, month_idx), the
    reconciled dailies (V, nt, n) of the cells (``rows``, ``cols``) of the
    region. ``st``: lon, lat (S,), elev, tdi (S,), lst (S, 12), norm (V, S,
    12), vario (S, 12, 3), anoms (V, S, T). ``region``: lon0 / lat0 (centre of
    the upper-left cell), cellsize, elev, tdi, lst (12, R, C)."""
    P = Prec(prec)
    T = lambda x: P.t(x, device)  # noqa: E731
    k, tr, tc = cfg["k_neighbors"], cfg["tile_rows"], cfg["tile_cols"]
    R, C = region["elev"].shape
    cs, lon0, lat0 = region["cellsize"], region["lon0"], region["lat0"]
    rows, cols = np.asarray(rows), np.asarray(cols)
    n = len(rows)

    # pools and neighbourhoods
    idx = np.zeros((n, k), np.int64)
    ref_lat = np.zeros(n)
    gap_km = np.full(n, np.inf)  # the k-th neighbour to the next
    pools = {}
    for i, (r, c) in enumerate(zip(rows, cols)):
        t = (r // tr, c // tc)
        if t not in pools:
            r0, c0 = t[0] * tr, t[1] * tc
            pools[t] = tile_pool(st["lon"], st["lat"], r0, c0, min(tr, R - r0), min(tc, C - c0),
                                 lon0, lat0, cs, cfg["margin_km"], cfg["max_tile_stations"])
        pool = pools[t]
        clon, clat = lon0 + c * cs, lat0 - r * cs
        dp = haversine(T(np.full(len(pool), clon)), T(np.full(len(pool), clat)),
                       T(st["lon"][pool]), T(st["lat"][pool])).cpu().numpy()
        if len(pool) < k:
            raise ValueError(f"a pool of {len(pool)} stations, fewer than k = {k}")
        order = np.argsort(dp, kind="stable")
        idx[i] = pool[order[:k]]
        if len(pool) > k:
            gap_km[i] = dp[order[k]] - dp[order[k - 1]]
        ref_lat[i] = st["lat"][pool].mean()
    cells = dict(lon=lon0 + cols * cs, lat=lat0 - rows * cs, elev=region["elev"][rows, cols],
                 tdi=region["tdi"][rows, cols], lst=region["lst"][:, rows, cols].T)
    kr = krige(P, st, cells, idx, ref_lat, cfg, device, cfg["k_neighbors_anom"])
    normal, var, ok, gain = kr["normal"], kr["var"], kr["ok"], kr["gain"]
    ka = gain.shape[1]

    dailies = []
    for t0, month_idx in chunks:
        nt = len(month_idx)
        a = T(st["anoms"][:, idx[:, :ka], t0 : t0 + nt])                  # (V, n, ka, nt)
        m = torch.as_tensor(np.asarray(month_idx), device=device, dtype=torch.long)
        d = normal[:, :, m] + P.einsum("nk,vnkt->vnt", gain, a)           # (V, n, nt)
        okd = ok[:, :, m]
        if d.shape[0] == 2:
            cross = okd[0] & okd[1] & (d[1] < d[0])
            mid = 0.5 * (d[0] + d[1])
            d = torch.stack([torch.where(cross, mid, d[0]), torch.where(cross, mid, d[1])])
        dailies.append(torch.where(okd, d, torch.nan).transpose(1, 2).cpu().double().numpy())
    host = lambda x: x.transpose(1, 2).cpu().double().numpy()  # noqa: E731
    nan = torch.tensor(float("nan"), dtype=normal.dtype, device=normal.device)
    return dict(normal=host(torch.where(ok, normal, nan)),
                se=host(torch.where(ok, torch.sqrt(var)[None].expand_as(normal), nan)),
                ok=ok.transpose(1, 2).cpu().numpy(), daily=dailies, gap_km=gap_km)
