"""The benchmark's synthetic world, made from the seed on the device.

A frozen copy of the arithmetic of ``topotpu_torch/io/synthetic.py::make_world``
(the program's generator, which a later change to the program may move),
written in torch so that it runs on the GPU in a few large calls from a
``torch.Generator`` seeded with the run's seed: a DEM of smoothed noise,
TDI from its gradient, 12 monthly LST rasters, stations at random cells with
monthly normals from the known linear trend plus one Gaussian-process
residual field of a known exponential variogram, and daily anomalies from
spatially loaded AR(1) synoptic modes plus station noise. It differs from
its origin where the benchmark needs more: a world that extends beyond the
produced region (``margin_km``), a station count set by a density, a second
variable (tmax: the first's normals plus a diurnal range field, anomalies
partly its own, so that crossings occur for the reconcile), and mode
centres and loadings scaled to the world's extent.

Every seed gives the same sizes: the station count follows from the
extent and the density alone.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import scipy.signal
import torch

EARTH_RADIUS_KM = 6371.0087714
TREND = (-0.0065, -0.8, 0.35, 12.0)  # lapse (C/m), tdi, lst, constant: make_world's


class Stations(NamedTuple):
    """Per-station arrays on the host: lon / lat float64, the rest float32."""

    lon: np.ndarray
    lat: np.ndarray
    elev: np.ndarray
    tdi: np.ndarray
    lst: np.ndarray      # (S, 12)
    norm: np.ndarray     # (V, S, 12)
    vario: np.ndarray    # (S, 12, 3): the residual field's variogram, every month
    anoms: np.ndarray    # (V, S, T)


class Region(NamedTuple):
    """The produced region's rasters (float32 / bool, row 0 north) and grid."""

    lon0: float  # centre of the upper-left cell
    lat0: float
    cellsize: float
    elev: np.ndarray
    tdi: np.ndarray
    lst: np.ndarray      # (12, R, C)
    landmask: np.ndarray


def haversine_km(lon1, lat1, lon2, lat2):
    """Great-circle km, torch, in the inputs' dtype."""
    lon1, lat1, lon2, lat2 = (torch.deg2rad(x) for x in (lon1, lat1, lon2, lat2))
    a = (torch.sin((lat2 - lat1) / 2) ** 2
         + torch.cos(lat1) * torch.cos(lat2) * torch.sin((lon2 - lon1) / 2) ** 2)
    return 2 * EARTH_RADIUS_KM * torch.asin(torch.sqrt(torch.clamp(a, 0, 1)))


def _smooth(a: torch.Tensor, iters: int) -> torch.Tensor:
    for _ in range(iters):
        a = 0.25 * (torch.roll(a, 1, 0) + torch.roll(a, -1, 0)
                    + torch.roll(a, 1, 1) + torch.roll(a, -1, 1))
    return a


def _trend(month: int, elev, tdi, lst_m):
    lapse, tdi_c, lst_c, const = TREND
    return const + 10.0 * math.cos((month - 6.5) * math.pi / 6.0) + lapse * elev \
        + tdi_c * tdi + lst_c * lst_m


def extent(region_rows, region_cols, lon_min, lat_max, cellsize, margin_km):
    """The world's (rows, cols, row_off, col_off, lon0, lat0): the region with
    ``margin_km`` on every side (in longitude at the world's northern edge,
    where degrees are shortest) and a little more."""
    mlat = margin_km / 111.32 + 0.05
    mlon = margin_km / (111.32 * math.cos(math.radians(lat_max + mlat))) + 0.05
    r_off, c_off = math.ceil(mlat / cellsize), math.ceil(mlon / cellsize)
    return (region_rows + 2 * r_off, region_cols + 2 * c_off, r_off, c_off,
            lon_min + cellsize / 2 - c_off * cellsize, lat_max - cellsize / 2 + r_off * cellsize)


def make(seed: int, device, *, region_rows, region_cols, lon_min, lat_max, cellsize,
         margin_km, km2_per_station, ndays, vario, dtr_mean, dtr_sd, mode_km,
         km2_per_mode, own_anom_frac, n_stations=None) -> tuple[Region, Stations]:
    """The world of ``seed``: the region's rasters and every station of the
    world around it, with ``ndays`` days of anomalies for each of two
    variables. ``n_stations``, where given, replaces the density's count."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    f32 = dict(dtype=torch.float32, device=device)
    rows, cols, r_off, c_off, wlon0, wlat0 = extent(region_rows, region_cols, lon_min,
                                                     lat_max, cellsize, margin_km)

    elev = _smooth(torch.randn((rows, cols), generator=g, **f32), 15)
    elev = 1500.0 + 2500.0 * (elev - elev.min()) / (elev.max() - elev.min() + 1e-9)
    gy, gx = torch.gradient(elev)
    tdi = _smooth(gx.abs() + gy.abs(), 4)
    tdi = (tdi - tdi.mean()) / (tdi.std() + 1e-9)
    lst = torch.stack([8.0 * math.cos((m - 7) * math.pi / 6.0) - 0.0055 * elev + 15.0
                       + 0.5 * _smooth(torch.randn((rows, cols), generator=g, **f32), 8)
                       for m in range(1, 13)])
    dtr = _smooth(torch.randn((rows, cols), generator=g, **f32), 30)
    dtr = dtr_mean + dtr_sd * (dtr - dtr.mean()) / (dtr.std() + 1e-9)

    # stations at random cells of the world, at its density
    lat_mid = wlat0 - 0.5 * rows * cellsize
    area = (rows * cellsize * 111.32) * (cols * cellsize * 111.32 * math.cos(math.radians(lat_mid)))
    S = int(n_stations or round(area / km2_per_station))
    pick = torch.randperm(rows * cols, generator=g, device=device)[:S]
    rr, cc = pick // cols, pick % cols
    f64 = dict(dtype=torch.float64, device=device)
    jit = (torch.rand((2, S), generator=g, **f64) - 0.5) * 0.8 * cellsize
    lon = wlon0 + cc.double() * cellsize + jit[0]
    lat = wlat0 - rr.double() * cellsize + jit[1]
    s_elev = elev[rr, cc] + 10.0 * torch.randn(S, generator=g, **f32)
    s_tdi, s_lst, s_dtr = tdi[rr, cc], lst[:, rr, cc].T, dtr[rr, cc]

    nugget, psill, rng_km = vario
    d = haversine_km(lon[:, None], lat[:, None], lon[None, :], lat[None, :])
    cov = psill * torch.exp(-d / rng_km)
    cov.diagonal().fill_(psill + nugget + 1e-9)
    resid = torch.linalg.cholesky(cov) @ torch.randn(S, generator=g, **f64)
    del d, cov
    norm_a = torch.stack([_trend(m, s_elev, s_tdi, s_lst[:, m - 1]) for m in range(1, 13)], 1)
    norm_a = norm_a + resid.float()[:, None]
    norm = torch.stack([norm_a, norm_a + s_dtr[:, None]])

    # synoptic modes: AR(1) series (the recursion on the host, exactly, by
    # lfilter), loaded on stations by distance to the modes' centres
    n_modes = max(8, int(round(area / km2_per_mode)))
    eps = 2.0 * torch.randn((2, n_modes, ndays), generator=g, **f64).cpu().numpy()
    z = torch.as_tensor(scipy.signal.lfilter([1.0], [1.0, -0.75], eps, axis=-1), **f32)
    centres = torch.rand((2, n_modes, 2), generator=g, **f64)
    clon = lon.min() + centres[..., 0] * (lon.max() - lon.min())
    clat = lat.min() + centres[..., 1] * (lat.max() - lat.min())
    anoms = []
    for v in range(2):
        load = torch.exp(-haversine_km(lon[:, None], lat[:, None], clon[v][None], clat[v][None])
                         / mode_km).float()
        anoms.append(load @ z[v])
    anoms[1] = (1.0 - own_anom_frac) * anoms[0] + own_anom_frac * anoms[1]
    anoms = torch.stack(anoms) + 0.3 * torch.randn((2, S, ndays), generator=g, **f32)
    anoms -= anoms.mean(dim=-1, keepdim=True)

    reg = (slice(r_off, r_off + region_rows), slice(c_off, c_off + region_cols))
    host = lambda t: t.cpu().numpy()  # noqa: E731
    region = Region(lon0=lon_min + cellsize / 2, lat0=lat_max - cellsize / 2, cellsize=cellsize,
                    elev=host(elev[reg]), tdi=host(tdi[reg]), lst=host(lst[(slice(None),) + reg]),
                    landmask=np.ones((region_rows, region_cols), bool))
    stations = Stations(
        lon=host(lon), lat=host(lat), elev=host(s_elev), tdi=host(s_tdi), lst=host(s_lst),
        norm=host(norm), vario=np.tile(np.asarray(vario, np.float32), (S, 12, 1)),
        anoms=host(anoms))
    return region, stations
