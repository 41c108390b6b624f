"""Plain reference of the infill cell: TopoWx's PPCA infill of a station's
daily series (BASELINE config #3), as the configuration states it.

* Predictors of a target: the ``n_neighbors`` stations of its block whose
  standardised series correlate best with its own over their jointly
  observed days (|r|; a pair with fewer than 30 such days scores 0 and, with
  coordinates, falls back to proximity, 1e-4 / (1 + km), below any real
  correlation); scored in float64. Daily series keep their seasonal cycle,
  so the best scores lie within ~1e-5 of each other and float32 and float64
  rank them apart: the selection is judged by the scores of what was chosen
  (each within a tie margin of the n-th best), and the EM is then run on
  the chosen set.
* The EM of probabilistic PCA over [target | predictors], q components:
  centred on the observed means, initialised from the top-q eigenvectors of
  the zero-filled covariance (float64, as the configuration states), then
  E- and M-steps until the relative change of the imputed entries falls to
  ``tol`` or ``max_iters``; the state a target reached is frozen, and one
  more step from it gives the reconstruction. Observed entries are kept;
  imputed ones are rescaled to each month's observed variance.
* Monthly normals: the means of the filled series by calendar month.

Batched over targets in torch, in ``Prec``'s precision (the EM; the
initialisation is float64 in both).
"""

from __future__ import annotations

import numpy as np
import torch

from reference.precision import Prec

EARTH_RADIUS_KM = 6371.0087714


def _haversine_np(lon1, lat1, lon2, lat2):
    lon1, lat1, lon2, lat2 = map(np.deg2rad, (lon1, lat1, lon2, lat2))
    a = (np.sin((lat2 - lat1) / 2) ** 2
         + np.cos(lat1) * np.cos(lat2) * np.sin((lon2 - lon1) / 2) ** 2)
    return 2 * EARTH_RADIUS_KM * np.arcsin(np.sqrt(np.clip(a, 0, 1)))


def scores(obs: np.ndarray, lon, lat, targets, device) -> np.ndarray:
    """(B, S) float64 predictor scores of the ``targets`` (rows of ``obs``,
    (S, T) with NaN where missing) against every station: |r| + 1, or the
    proximity fallback; -1 for the target itself."""
    mask = np.isfinite(obs)
    mu = np.nanmean(obs, axis=1)
    sd = np.nanstd(obs, axis=1) + 1e-6
    xs = torch.as_tensor(np.where(mask, (obs - mu[:, None]) / sd[:, None], 0.0), device=device)
    m = torch.as_tensor(mask, dtype=torch.float64, device=device)
    t = torch.as_tensor(np.asarray(targets), device=device)
    cnt = m[t] @ m.T
    sx, sy = xs[t] @ m.T, m[t] @ xs.T
    sxx, syy = (xs[t] ** 2) @ m.T, m[t] @ (xs ** 2).T
    sxy = xs[t] @ xs.T
    nn = torch.clamp(cnt, min=1.0)
    cov = sxy / nn - (sx / nn) * (sy / nn)
    vx = torch.clamp(sxx / nn - (sx / nn) ** 2, min=1e-12)
    vy = torch.clamp(syy / nn - (sy / nn) ** 2, min=1e-12)
    score = torch.abs(torch.where(cnt < 30, 0.0, cov / torch.sqrt(vx * vy))).cpu().numpy()
    d = _haversine_np(lon[targets][:, None], lat[targets][:, None], lon[None, :], lat[None, :])
    score = np.where(score > 0, score + 1.0, 1e-4 / (1.0 + d))
    score[np.arange(len(targets)), targets] = -1.0
    return score


def best(score: np.ndarray, n: int) -> np.ndarray:
    """The n best stations by ``score``, best first."""
    return np.argsort(-score, axis=1, kind="stable")[:, :n]


def selection_faults(score: np.ndarray, chosen: np.ndarray, targets, tie: float) -> int:
    """Targets whose ``chosen`` predictors are not n distinct other
    stations each scoring within ``tie`` of the n-th best score."""
    n = chosen.shape[1]
    nth = -np.sort(-score, axis=1)[:, n - 1]
    faults = 0
    for j, t in enumerate(targets):
        c = chosen[j]
        faults += bool(len(set(c.tolist())) != n or t in c
                       or (score[j, c] < nth[j] - tie).any())
    return faults


def _em_step(P, X, W, c, sig2, T, eye):
    Xc = X - c[:, None, :]
    M = P.einsum("bvq,bvr->bqr", W, W) + sig2[:, None, None] * eye
    Minv = torch.linalg.inv(M)
    Z = P.einsum("btq,bqr->btr", P.einsum("btv,bvq->btq", Xc, W), Minv)
    Sxz = P.einsum("btv,btq->bvq", Xc, Z)
    Szz = P.einsum("btq,btr->bqr", Z, Z) + T * sig2[:, None, None] * Minv
    Wn = torch.linalg.solve(Szz, Sxz.transpose(-1, -2)).transpose(-1, -2)
    low = P.einsum("btq,bvq->btv", Z, Wn)
    cn = c + (Xc - low).mean(dim=-2)
    recon = low + cn[:, None, :]
    sig2n = torch.clamp((X - recon).square().mean(dim=(-2, -1)), min=1e-8)
    return recon, Wn, cn, sig2n


def ppca_fill(Y: np.ndarray, M: np.ndarray, q: int, max_iters: int, tol: float, prec: str,
              device):
    """Filled (B, T, V) and iterations (B,) of the EM on ``Y`` (B, T, V),
    observed where ``M``."""
    P = Prec(prec)
    Yt = torch.as_tensor(np.where(M, Y, 0.0), device=device, dtype=P.dtype)
    mask = torch.as_tensor(M, device=device)
    m = mask.to(P.dtype)
    B, T, V = Yt.shape
    mu = Yt.sum(-2) / (m.sum(-2) + 1e-30)
    Yc = torch.where(mask, Yt - mu[:, None, :], 0.0)
    # initialisation, float64 in either precision
    Y64, m64 = Yc.double(), m.double()
    cov = torch.einsum("btv,btw->bvw", Y64, Y64) / torch.clamp(
        torch.einsum("btv,btw->bvw", m64, m64), min=1.0)
    evals, evecs = torch.linalg.eigh(cov)
    W = (evecs[..., -q:] * torch.sqrt(torch.clamp(evals[..., -q:], min=1e-6))[..., None, :]).to(P.dtype)
    sig2 = torch.clamp(evals[..., :-q].mean(-1), min=1e-6).to(P.dtype)
    eye = torch.eye(q, dtype=P.dtype, device=device)
    X, c = Yc, torch.zeros((B, V), dtype=P.dtype, device=device)
    active = torch.ones(B, dtype=torch.bool, device=device)
    n_it = torch.zeros(B, dtype=torch.int64, device=device)
    for _ in range(max_iters):
        if not bool(active.any()):
            break
        recon, Wn, cn, sig2n = _em_step(P, X, W, c, sig2, T, eye)
        Xn = torch.where(mask, Yc, recon)
        a3 = active[:, None, None]
        Xn = torch.where(a3, Xn, X)
        W = torch.where(a3, Wn, W)
        c = torch.where(active[:, None], cn, c)
        sig2 = torch.where(active, sig2n, sig2)
        delta = torch.sqrt((Xn - X).square().mean(dim=(-2, -1))) / torch.sqrt(
            Xn.square().mean(dim=(-2, -1)) + 1e-12)
        n_it += active
        active = active & (delta > tol)
        X = Xn
    recon, _, _, _ = _em_step(P, X, W, c, sig2, T, eye)
    full = recon + mu[:, None, :]
    Ytrue = torch.as_tensor(Y, device=device, dtype=P.dtype)
    return torch.where(mask, Ytrue, full), n_it


def variance_adjust(filled: torch.Tensor, obs: torch.Tensor, month_idx: torch.Tensor):
    """Imputed entries of each month rescaled about their mean to the
    observed entries' standard deviation (ratio within 0.25-4, only with
    more than 10 observed, more than 2 imputed and an imputed variance above
    1e-8)."""
    out = filled
    for mth in range(12):
        in_m = (month_idx == mth)[None, :]
        so, si = in_m & obs, in_m & ~obs
        no, ni = so.sum(1), si.sum(1)
        mo = torch.where(so, filled, 0.0).sum(1) / torch.clamp(no, min=1)
        vo = torch.where(so, (filled - mo[:, None]) ** 2, 0.0).sum(1) / torch.clamp(no - 1, min=1)
        mi = torch.where(si, filled, 0.0).sum(1) / torch.clamp(ni, min=1)
        vi = torch.where(si, (filled - mi[:, None]) ** 2, 0.0).sum(1) / torch.clamp(ni - 1, min=1)
        good = (no > 10) & (ni > 2) & (vi > 1e-8)
        ratio = torch.clamp(torch.sqrt(torch.where(good, vo / torch.clamp(vi, min=1e-8), 1.0)),
                            0.25, 4.0)
        out = torch.where(si, mi[:, None] + (filled - mi[:, None]) * ratio[:, None], out)
    return out


def reference(obs: np.ndarray, targets, chosen, month_idx, ppca: dict, prec: str, device):
    """Filled series (B, T) and normals (B, 12), numpy, of the ``targets`` of
    a block (``obs`` (S, T) with NaN), each over [target | its ``chosen``
    predictors]."""
    cols = np.concatenate([np.asarray(targets)[:, None], chosen], axis=1)  # (B, V)
    Y = np.transpose(obs[cols], (0, 2, 1))                                 # (B, T, V)
    M = np.isfinite(Y)
    filled, n_it = ppca_fill(np.where(M, Y, 0.0), M, min(ppca["n_components"], cols.shape[1] - 1),
                             ppca["max_iters"], ppca["tol"], prec, device)
    midx = torch.as_tensor(np.asarray(month_idx), device=device)
    tgt = variance_adjust(filled[..., 0], torch.as_tensor(M[..., 0], device=device), midx)
    normals = torch.stack([tgt[:, midx == mth].mean(1) for mth in range(12)], 1)
    host = lambda x: x.double().cpu().numpy()  # noqa: E731
    return dict(filled=host(tgt), normals=host(normals), n_iters=n_it.cpu().numpy())
