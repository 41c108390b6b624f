"""Moving-window variogram-parameter build (port of ``topotpu.interp.params``).

At each station, take its k_fit nearest valid stations (the station itself
left out by index), detrend their monthly normals with GWR on (elev, tdi,
lst_m), fit an exponential variogram to the residuals, and store (nugget,
psill, range) for each of the 12 months. Gridded runs interpolate these
per-station parameters to cells instead of refitting.

Every station and month is fitted on the device in one batched pass per
month: 12 calls of ``station_residuals`` -> ``empirical_variogram`` ->
``fit_exp_variogram``, with no host round trip inside the loop.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from topotpu_torch.core.config import InterpParams, VariogramParams
from topotpu_torch.geo.distance import pairwise_km_from_xyz, unit_xyz
from topotpu_torch.geo.neighbors import distance_weights, select_neighbors
from topotpu_torch.interp.convert import to_tensor
from topotpu_torch.kernels.wls import batched_wls, center_design
from topotpu_torch.stats.variogram import empirical_variogram, fit_exp_variogram


class KrigParamsResult(NamedTuple):
    vario: torch.Tensor  # (S, 12, 3) nugget/psill/range per station per month
    sse: torch.Tensor    # (S, 12) weighted fit SSE
    ok: torch.Tensor     # (S, 12) fit usable


def krig_params_to_numpy(res: KrigParamsResult) -> KrigParamsResult:
    """The same result as numpy arrays (the JAX package's form on the host)."""
    return KrigParamsResult(*(t.cpu().numpy() for t in res))


def station_residuals(lon, lat, elev, tdi, valid_m, lst_m, norm_m, k: int,
                      iparams: InterpParams):
    """One month's fit inputs for every station: the pair distances (S, k, k)
    within its k-neighbourhood (itself left out by index), the GWR residuals
    of the neighbours' normals (S, k, 0 where masked) and the mask (S, k).

    Trend design: covariates only (elev, tdi, lst_m), centred and scaled at
    the station; locality enters through the window weights."""
    nbr = select_neighbors(lon, lat, lon, lat, valid_m, k=k,
                           exclude_idx=torch.arange(lon.shape[0], device=lon.device))
    w = distance_weights(nbr.dist, nbr.mask, iparams.weight_kernel)
    nbr_cov = torch.stack([elev[nbr.idx], tdi[nbr.idx], lst_m[nbr.idx]], dim=-1)
    X, _, _ = center_design(nbr_cov, torch.stack([elev, tdi, lst_m], dim=-1), w)
    y = norm_m[nbr.idx]
    beta = batched_wls(X, y, w, iparams.ridge)
    fitted = torch.einsum("skp,sp->sk", X, beta)
    resid = torch.where(nbr.mask, y - fitted, torch.zeros_like(y))
    xyz = unit_xyz(lon, lat)[nbr.idx]
    return pairwise_km_from_xyz(xyz, xyz), resid, nbr.mask


def build_krig_params(
    stn_lon, stn_lat, stn_elev, stn_tdi,
    stn_lst,    # (S, 12)
    stn_norm,   # (S, 12)
    stn_valid,  # (S, 12) bool
    vparams: VariogramParams,
    iparams: InterpParams,
    device: torch.device | str,
) -> KrigParamsResult:
    """Fit per-station monthly exponential variograms on ``device``.

    Inputs are numpy arrays (or tensors) shaped like the serial station
    attributes; they are moved to ``device`` as float32 once. The result stays
    on the device (``krig_params_to_numpy`` brings it to the host)."""
    f = lambda a: to_tensor(a, device)  # noqa: E731
    lon, lat, elev, tdi, lst, norm = map(f, (stn_lon, stn_lat, stn_elev, stn_tdi,
                                             stn_lst, stn_norm))
    valid = to_tensor(stn_valid, device, torch.bool)
    varios, sses, oks = [], [], []
    for m in range(12):
        dp, resid, mask = station_residuals(lon, lat, elev, tdi, valid[:, m], lst[:, m],
                                            norm[:, m], vparams.k_fit_neighbors, iparams)
        emp = empirical_variogram(dp, resid, mask, n_bins=vparams.n_bins,
                                  max_dist_frac=vparams.max_dist_frac)
        fit = fit_exp_variogram(emp, n_iters=vparams.gn_iters)
        varios.append(torch.stack([fit.nugget, fit.psill, fit.rng], dim=-1))
        sses.append(fit.sse)
        oks.append(fit.ok & valid[:, m])
    return KrigParamsResult(vario=torch.stack(varios, dim=1), sse=torch.stack(sses, dim=1),
                            ok=torch.stack(oks, dim=1))


def fill_failed_fits(vario: np.ndarray, ok: np.ndarray) -> np.ndarray:
    """Replace failed per-station fits with the monthly median of good fits
    (host-side post-pass; with no good fit in a month, (0, 1, 100))."""
    out = np.array(vario, copy=True)
    for m in range(vario.shape[1]):
        good = ok[:, m]
        if good.any():
            med = np.median(vario[good, m, :], axis=0)
        else:
            med = np.array([0.0, 1.0, 100.0])
        out[~good, m, :] = med
    return out
