"""Plain reference of the station-parameter cell: TopoWx's station-side
stages before the grid, as the configuration states them.

* Variogram parameters of station s, month m: its ``k_fit`` nearest other
  stations; their normals detrended by a weighted regression on (elev, TDI,
  LST of m) centred and scaled at s (bisquare weights, the configuration's
  ridge); the empirical semivariogram of the residuals in ``n_bins``
  equal-width bins up to ``max_dist_frac`` of the largest pair distance;
  an exponential model fitted by weighted least squares (weights N / h^2)
  with the damped Gauss-Newton loop the configuration states (``gn_iters``
  steps from nugget = half the first bin, sill = the mean of the upper half,
  range = a third of the cutoff; damping halved on improvement, doubled
  otherwise; parameters kept in their box).
* Leave-one-out normals of station s at neighbourhood size k: the normals
  chain of ``reference/grid.py`` at s's own location and covariates over its
  k nearest other stations; the error against its own normal. The program
  ranks neighbours by float32 cosines, which part stations ~50 m apart in
  distance at 50 km: where the k-th and the next lie closer than a tie
  margin the set is not determined, and the caller leaves that entry out.
* Leave-one-out dailies at anomaly size ka: that normal (k = the base size)
  plus the gain row of the first ka neighbours applied to their anomalies;
  the station's mean absolute error over the days.
All batched in torch, in ``Prec``'s precision.
"""

from __future__ import annotations

import numpy as np
import torch

from reference.grid import _design, _normal_matrix, _weights, haversine, krige
from reference.precision import Prec


def loo_neighbours(lon, lat, targets, k: int, device, with_gap: bool = False):
    """(n, k) the k nearest other stations of each target, float64; with
    ``with_gap`` also (n,) the km between the k-th and the next."""
    t = np.asarray(targets)
    d = haversine(*(torch.as_tensor(x, device=device, dtype=torch.float64) for x in (
        lon[t][:, None], lat[t][:, None], lon[None, :], lat[None, :]))).cpu().numpy()
    d[np.arange(len(t)), t] = np.inf
    order = np.argsort(d, axis=1, kind="stable")
    if not with_gap:
        return order[:, :k]
    ds = np.take_along_axis(d, order[:, k - 1 : k + 1], axis=1)
    return order[:, :k], ds[:, 1] - ds[:, 0]


def _cells(st, t):
    return dict(lon=st["lon"][t], lat=st["lat"][t], elev=st["elev"][t], tdi=st["tdi"][t],
                lst=st["lst"][t])


def loo_normal_errors(st: dict, targets, ks, cfg: dict, prec: str, device) -> tuple:
    """({k: (n, 12) LOO normal minus the station's own normal}, {k: (n,) km
    between the k-th neighbour and the next})."""
    P = Prec(prec)
    ref_lat = np.full(len(targets), float(np.mean(st["lat"])))
    out, gaps = {}, {}
    for k in ks:
        idx, gaps[int(k)] = loo_neighbours(st["lon"], st["lat"], targets, k, device, True)
        kr = krige(P, st, _cells(st, targets), idx, ref_lat, cfg, device)
        out[int(k)] = (kr["normal"][0].double().cpu().numpy()
                       - st["norm"][0][np.asarray(targets)].astype(np.float64))
    return out, gaps


def loo_daily_mae(st: dict, targets, kas, k: int, month_idx, cfg: dict, prec: str,
                  device) -> tuple:
    """({ka: (n,) mean absolute LOO daily error}, {ka: (n,) km between the
    ka-th neighbour and the next})."""
    P = Prec(prec)
    t = np.asarray(targets)
    ref_lat = np.full(len(t), float(np.mean(st["lat"])))
    idx = loo_neighbours(st["lon"], st["lat"], t, k + 1, device)
    d = haversine(*(torch.as_tensor(x, device=device, dtype=torch.float64) for x in (
        st["lon"][t][:, None], st["lat"][t][:, None], st["lon"][idx], st["lat"][idx]))).cpu().numpy()
    idx = idx[:, :k]
    m = torch.as_tensor(np.asarray(month_idx), device=device)
    truth = torch.as_tensor(st["norm"][0][t][:, month_idx] + st["anoms"][0][t],
                            device=device, dtype=torch.float64)
    out, gaps = {}, {}
    for ka in kas:
        ka = min(int(ka), k)
        kr = krige(P, st, _cells(st, t), idx, ref_lat, cfg, device, ka)
        a = P.t(st["anoms"][0][idx[:, :ka]], device)                      # (n, ka, T)
        pred = kr["normal"][0][:, m] + P.einsum("nk,nkt->nt", kr["gain"], a)
        out[ka] = (pred.double() - truth).abs().mean(1).cpu().numpy()
        gaps[ka] = np.minimum(d[:, ka] - d[:, ka - 1], d[:, k] - d[:, k - 1])
    return out, gaps


def _solve3(A, b):
    a = [[A[..., i, j] for j in range(3)] for i in range(3)]
    c00 = a[1][1] * a[2][2] - a[1][2] * a[2][1]
    c01 = a[0][2] * a[2][1] - a[0][1] * a[2][2]
    c02 = a[0][1] * a[1][2] - a[0][2] * a[1][1]
    c10 = a[1][2] * a[2][0] - a[1][0] * a[2][2]
    c11 = a[0][0] * a[2][2] - a[0][2] * a[2][0]
    c12 = a[0][2] * a[1][0] - a[0][0] * a[1][2]
    c20 = a[1][0] * a[2][1] - a[1][1] * a[2][0]
    c21 = a[0][1] * a[2][0] - a[0][0] * a[2][1]
    c22 = a[0][0] * a[1][1] - a[0][1] * a[1][0]
    det = a[0][0] * c00 + a[0][1] * c10 + a[0][2] * c20
    det = torch.where(torch.abs(det) > 1e-30, det, torch.full_like(det, 1e-30))
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([(c00 * b0 + c01 * b1 + c02 * b2) / det,
                        (c10 * b0 + c11 * b1 + c12 * b2) / det,
                        (c20 * b0 + c21 * b1 + c22 * b2) / det], -1)


def empirical(P: Prec, pair, resid, n_bins: int, max_dist_frac: float):
    """(gamma, h, npairs, cutoff) of each neighbourhood's residuals."""
    k = pair.shape[-1]
    iu = torch.triu(torch.ones((k, k), dtype=torch.bool, device=pair.device), 1)
    pm = iu & (pair > 0)
    dmax = torch.amax(torch.where(pm, pair, 0.0), dim=(-2, -1))
    cutoff = torch.clamp(dmax * max_dist_frac, min=1e-3)
    width = cutoff / n_bins
    dv = resid[..., :, None] - resid[..., None, :]
    sv = 0.5 * dv * dv
    b = torch.clamp((pair / width[..., None, None]).to(torch.int64), 0, n_bins - 1)
    inr = pm & (pair <= cutoff[..., None, None])
    onehot = torch.nn.functional.one_hot(torch.where(inr, b, n_bins), n_bins + 1)[..., :n_bins]
    oh = onehot.to(pair.dtype)
    cnt = oh.sum(dim=(-3, -2))
    g = (oh * sv[..., None]).sum(dim=(-3, -2)) / torch.clamp(cnt, min=1.0)
    h = (oh * pair[..., None]).sum(dim=(-3, -2)) / torch.clamp(cnt, min=1.0)
    return g, h, cnt, cutoff


def fit(P: Prec, gamma, h, npairs, cutoff, n_iters: int, min_bins: int = 4):
    """(nugget, psill, range, ok, w) of the damped Gauss-Newton WLS fit."""
    ok_b = npairs > 0
    w = torch.where(ok_b, npairs / torch.clamp(h, min=1e-3) ** 2, 0.0)
    w = w / (w.sum(-1, keepdim=True) + 1e-30)
    nb = gamma.shape[-1]
    pos = torch.arange(nb, device=gamma.device)
    first = torch.gather(gamma, -1, torch.argmin(torch.where(ok_b, pos, nb), -1)[..., None])[..., 0]
    sel = ok_b & (pos >= int(nb * 0.5))
    full = torch.where(ok_b, gamma, 0.0).sum(-1) / torch.clamp(ok_b.sum(-1), min=1)
    tail = torch.where(sel.sum(-1) > 0, torch.where(sel, gamma, 0.0).sum(-1)
                       / torch.clamp(sel.sum(-1), min=1), full)
    sill0 = torch.clamp(tail, min=1e-8)
    nug = torch.minimum(torch.clamp(first * 0.5, min=0.0), 0.9 * sill0)
    ps = torch.clamp(sill0 - nug, min=1e-8)
    rg = torch.clamp(cutoff / 3.0, min=1e-2)
    rng_hi = torch.clamp(torch.amax(torch.where(ok_b, h, 0.0), -1) * 10.0, min=1.0)

    def sse_of(a, b_, c):
        model = a[..., None] + b_[..., None] * (1 - torch.exp(-h / torch.clamp(c[..., None], min=1e-6)))
        r = torch.where(ok_b, gamma - model, 0.0)
        return (w * r * r).sum(-1)

    eye = torch.eye(3, dtype=gamma.dtype, device=gamma.device)
    lam = torch.full_like(nug, 1e-3)
    sse = sse_of(nug, ps, rg)
    for _ in range(n_iters):
        rgc = torch.clamp(rg, min=1e-6)
        e = torch.exp(-h / rgc[..., None])
        r = torch.where(ok_b, gamma - (nug[..., None] + ps[..., None] * (1 - e)), 0.0)
        J = torch.stack([torch.ones_like(h), 1 - e, -(ps[..., None] * h / rgc[..., None] ** 2) * e], -1)
        Jw = J * w[..., None]
        A = P.einsum("...ji,...jk->...ik", Jw, J)
        g = P.einsum("...ji,...j->...i", Jw, r)
        diag = torch.diagonal(A, dim1=-2, dim2=-1).sum(-1)[..., None, None] / 3.0
        d = _solve3(A + (lam[..., None, None] * diag + 1e-30) * eye, g)
        nn_ = torch.clamp(nug + d[..., 0], min=0.0)
        pn = torch.clamp(ps + d[..., 1], min=1e-8)
        rn = torch.minimum(torch.clamp(rg + d[..., 2], min=1e-2), rng_hi)
        sn = sse_of(nn_, pn, rn)
        better = sn < sse
        nug, ps, rg = (torch.where(better, x, y) for x, y in ((nn_, nug), (pn, ps), (rn, rg)))
        sse = torch.where(better, sn, sse)
        lam = torch.clamp(torch.where(better, lam * 0.5, lam * 2.0), 1e-8, 1e8)
    return nug, ps, rg, ok_b.sum(-1) >= min_bins, w


def variogram_fits(st: dict, stations, months, vcfg: dict, icfg: dict, prec: str, device):
    """Fits of the (station, month) pairs: dict of nugget, psill, range, ok,
    and the reference's bins (gamma, h, w) to judge any fit by."""
    P = Prec(prec)
    T = lambda x: P.t(x, device)  # noqa: E731
    s, m = np.asarray(stations), np.asarray(months)
    idx = loo_neighbours(st["lon"], st["lat"], s, vcfg["k_fit_neighbors"], device)
    slon, slat = T(st["lon"][idx]), T(st["lat"][idx])
    dist = haversine(T(st["lon"][s])[:, None], T(st["lat"][s])[:, None], slon, slat)
    pair = haversine(slon[:, :, None], slat[:, :, None], slon[:, None, :], slat[:, None, :])
    w = _weights(dist, torch.ones_like(dist, dtype=torch.bool))
    cov = torch.stack([T(st["elev"][idx]), T(st["tdi"][idx]), T(st["lst"][idx, m[:, None]])], -1)
    cpt = torch.stack([T(st["elev"][s]), T(st["tdi"][s]), T(st["lst"][s, m])], -1)
    X = _design(cov, cpt, w)
    A = _normal_matrix(P, X, w, icfg["ridge"])
    y = T(st["norm"][0][idx, m[:, None]])
    beta = torch.linalg.solve(A, P.einsum("nkp,nk,nk->np", X, w, y)[..., None])[..., 0]
    resid = y - P.einsum("nkp,np->nk", X, beta)
    g, h, cnt, cutoff = empirical(P, pair, resid, vcfg["n_bins"], vcfg["max_dist_frac"])
    nug, ps, rg, ok, wb = fit(P, g, h, cnt, cutoff, vcfg["gn_iters"])
    host = lambda x: x.double().cpu().numpy()  # noqa: E731
    return dict(nugget=host(nug), psill=host(ps), range=host(rg), ok=ok.cpu().numpy(),
                gamma=host(g), h=host(h), w=host(wb), bin_ok=(cnt > 0).cpu().numpy())


def curve_gap(fit_a: dict, fit_b: dict) -> np.ndarray:
    """Per pair: the weighted RMS distance between the two fitted curves over
    ``fit_b``'s bins, over ``fit_b``'s sill."""
    def curve(f):
        return f["nugget"][:, None] + f["psill"][:, None] * (
            1 - np.exp(-fit_b["h"] / np.maximum(f["range"][:, None], 1e-6)))
    d = np.where(fit_b["bin_ok"], curve(fit_a) - curve(fit_b), 0.0)
    return np.sqrt((fit_b["w"] * d * d).sum(-1)) / (fit_b["nugget"] + fit_b["psill"])
