"""The synthetic world, and tile inputs and station arrays from it.

``SyntheticWorld`` and ``make_world`` are the port's own copy of the JAX
package's generator (numpy only; the same seed gives the same world bit for
bit, ``tests/test_torch_core.py``). No real GHCN/SNOTEL/MODIS data ships with
the repository, so every test and drive runs on a synthetic but physically
structured world:

* a DEM built from smoothed random ridges (drives the lapse-rate signal),
* a TDI (topographic dissection) raster derived from the DEM,
* 12 monthly LST rasters = seasonal cycle + elevation coupling + noise,
* stations sampled at random land cells, monthly normals generated from a
  *known* linear covariate model + a Gaussian-process residual field with a
  *known* exponential variogram (so kriging has a recoverable ground truth),
* daily anomalies from an AR(1) synoptic process shared across stations with
  distance-decaying spatial correlation.

``tile_inputs_from_world`` is the torch counterpart of its namesake in the
JAX package, ``station_arrays_from_world`` gives the numpy station arrays
that the station-side stages of both packages take, and
``station_network_from_world`` the gappy daily observation matrix that the
infill stage takes.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from topotpu_torch.core.dates import get_days_metadata
from topotpu_torch.core.device import COMPUTE_DTYPE
from topotpu_torch.core.grid import GridSpec
from topotpu_torch.interp.point import (
    MonthLayout,
    TileInputs,
    group_days_by_month,
    month_layout,
)
from topotpu_torch.oracle.numpy_ref import haversine_km


@dataclasses.dataclass
class SyntheticWorld:
    grid: GridSpec
    elev: np.ndarray      # (nrows, ncols) m
    tdi: np.ndarray       # (nrows, ncols)
    lst: np.ndarray       # (12, nrows, ncols) deg C
    landmask: np.ndarray  # (nrows, ncols) bool
    # stations
    stn_lon: np.ndarray
    stn_lat: np.ndarray
    stn_elev: np.ndarray
    stn_tdi: np.ndarray
    stn_lst: np.ndarray   # (S, 12)
    stn_norm: np.ndarray  # (S, 12) true monthly normals at stations
    stn_anoms: np.ndarray  # (S, ndays) daily anomalies
    # ground truth for scoring
    true_vario: tuple     # (nugget, psill, range_km) of the residual GP
    trend_coef: np.ndarray
    resid_field_fn: object  # callable (lon, lat) -> GP residual (exact, via conditioning)
    ndays: int
    # callable (lon, lat) -> (N, ndays) noise-free daily-anomaly field (the
    # synoptic modes evaluated at arbitrary points, per-point demeaned like
    # stn_anoms) — ground truth for daily-value spot checks; None if absent
    anom_field_fn: object = None

    @property
    def n_stations(self) -> int:
        return self.stn_lon.shape[0]

    def true_normal(self, lon, lat, elev, tdi, lst_m, month):
        """Trend part of the true normal at arbitrary points + GP residual."""
        t = _trend(self.trend_coef, month, elev, tdi, lst_m)
        return t + self.resid_field_fn(lon, lat)


def _smooth2d(a: np.ndarray, iters: int = 12) -> np.ndarray:
    """Cheap separable box smoothing (no scipy dependency needed on host)."""
    for _ in range(iters):
        a = 0.25 * (
            np.roll(a, 1, 0) + np.roll(a, -1, 0) + np.roll(a, 1, 1) + np.roll(a, -1, 1)
        )
    return a


def _trend(coef, month, elev, tdi, lst_m):
    lapse, tdi_c, lst_c, const = coef
    seasonal = 10.0 * np.cos((month - 6.5) * np.pi / 6.0)
    return const + seasonal + lapse * elev + tdi_c * tdi + lst_c * lst_m


def make_world(
    rng: np.random.Generator,
    nrows: int = 100,
    ncols: int = 100,
    n_stations: int = 200,
    ndays: int = 365,
    lon_min: float = -106.0,
    lat_max: float = 41.0,
    cellsize: float = 1.0 / 120.0,
    vario=(0.05, 1.0, 40.0),
    ocean_frac: float = 0.0,
) -> SyntheticWorld:
    grid = GridSpec(
        lon0=lon_min + cellsize / 2,
        lat0=lat_max - cellsize / 2,
        cellsize=cellsize,
        nrows=nrows,
        ncols=ncols,
    )
    lon_g, lat_g = grid.lonlat_grids()

    elev = _smooth2d(rng.normal(size=(nrows, ncols)), 15)
    elev = 1500.0 + 2500.0 * (elev - elev.min()) / (np.ptp(elev) + 1e-9)
    gy, gx = np.gradient(elev)
    tdi = _smooth2d(np.abs(gx) + np.abs(gy), 4)
    tdi = (tdi - tdi.mean()) / (tdi.std() + 1e-9)

    months = np.arange(1, 13)
    lst = np.stack(
        [
            8.0 * np.cos((m - 7) * np.pi / 6.0)
            - 0.0055 * elev
            + 15.0
            + 0.5 * _smooth2d(rng.normal(size=(nrows, ncols)), 8)
            for m in months
        ]
    )

    landmask = np.ones((nrows, ncols), bool)
    if ocean_frac > 0:
        blob = _smooth2d(rng.normal(size=(nrows, ncols)), 20)
        landmask = blob > np.quantile(blob, ocean_frac)

    # --- stations at random land cells ---
    land_idx = np.flatnonzero(landmask.ravel())
    if n_stations > land_idx.size:
        raise ValueError(
            f"n_stations={n_stations} exceeds the {land_idx.size} land cells "
            f"of a {nrows}x{ncols} grid at ocean_frac={ocean_frac}; "
            f"raise --grid (or lower --stations)"
        )
    pick = rng.choice(land_idx, size=n_stations, replace=False)
    rr, cc = np.unravel_index(pick, (nrows, ncols))
    stn_lon, stn_lat = grid.cell_lonlat(rr, cc)
    # de-grid jitter so stations aren't exactly at cell centers
    stn_lon = stn_lon + rng.uniform(-0.4, 0.4, n_stations) * cellsize
    stn_lat = stn_lat + rng.uniform(-0.4, 0.4, n_stations) * cellsize
    stn_elev = elev[rr, cc] + rng.normal(0, 10, n_stations)
    stn_tdi = tdi[rr, cc]
    stn_lst = lst[:, rr, cc].T  # (S, 12)

    # --- true normals: linear trend + GP residual with known variogram ---
    trend_coef = np.array([-0.0065, -0.8, 0.35, 12.0])  # lapse, tdi, lst, const
    nugget, psill, rng_km = vario
    d = haversine_km(
        stn_lon[:, None], stn_lat[:, None], stn_lon[None, :], stn_lat[None, :]
    )
    cov = psill * np.exp(-d / rng_km)
    np.fill_diagonal(cov, psill + nugget)
    Lc = np.linalg.cholesky(cov + 1e-9 * np.eye(n_stations))
    resid_stn = Lc @ rng.normal(size=n_stations)  # one shared residual field

    stn_norm = np.stack(
        [
            _trend(trend_coef, m, stn_elev, stn_tdi, stn_lst[:, m - 1]) + resid_stn
            for m in months
        ],
        axis=1,
    )

    # Conditional-mean GP evaluator for scoring at arbitrary points (exact
    # simple-kriging conditioning on the station residuals, float64).
    cov_inv_resid = np.linalg.solve(cov, resid_stn)

    def resid_field_fn(lon, lat):
        dq = haversine_km(
            np.atleast_1d(lon)[:, None],
            np.atleast_1d(lat)[:, None],
            stn_lon[None, :],
            stn_lat[None, :],
        )
        return (psill * np.exp(-dq / rng_km)) @ cov_inv_resid

    # --- daily anomalies: spatially correlated AR(1) synoptics ---
    n_modes = 8
    centers = rng.uniform(
        [stn_lon.min(), stn_lat.min()], [stn_lon.max(), stn_lat.max()], (n_modes, 2)
    )
    dmode = haversine_km(
        stn_lon[:, None], stn_lat[:, None], centers[None, :, 0], centers[None, :, 1]
    )
    loadings = np.exp(-dmode / 120.0)  # (S, n_modes)
    phi = 0.75
    z = np.zeros((ndays, n_modes))
    eps = rng.normal(size=(ndays, n_modes)) * 2.0
    for t in range(1, ndays):
        z[t] = phi * z[t - 1] + eps[t]
    z[0] = eps[0]
    stn_anoms = (loadings @ z.T) + 0.3 * rng.normal(size=(n_stations, ndays))
    # anomalies must be zero-mean per station-month by construction; enforce
    stn_anoms -= stn_anoms.mean(axis=1, keepdims=True)

    def anom_field_fn(lon, lat):
        """Noise-free synoptic anomaly field at arbitrary points (same
        mode loadings + AR(1) series the stations sampled, same per-point
        demeaning; excludes the 0.3 C station noise) — daily-value ground
        truth for spot checks. Pure closure over already-drawn (centers,
        z): adds no rng draws, so worlds regenerate bit-identically."""
        dq = haversine_km(
            np.atleast_1d(lon)[:, None], np.atleast_1d(lat)[:, None],
            centers[None, :, 0], centers[None, :, 1],
        )
        a = np.exp(-dq / 120.0) @ z.T  # (N, ndays)
        return a - a.mean(axis=1, keepdims=True)

    return SyntheticWorld(
        grid=grid,
        elev=elev,
        tdi=tdi,
        lst=lst,
        landmask=landmask,
        stn_lon=stn_lon,
        stn_lat=stn_lat,
        stn_elev=stn_elev,
        stn_tdi=stn_tdi,
        stn_lst=stn_lst,
        stn_norm=stn_norm,
        stn_anoms=stn_anoms,
        true_vario=vario,
        trend_coef=trend_coef,
        resid_field_fn=resid_field_fn,
        ndays=ndays,
        anom_field_fn=anom_field_fn,
    )


def krig_rows_from_world(
    world: SyntheticWorld,
    rows: np.ndarray,
    cols: np.ndarray,
    k: int,
    stn_valid: np.ndarray | None = None,
) -> dict:
    """Neighbourhoods of the cells (rows, cols) of ``world`` in the layout
    of the batch-last kernels (the fused OK solve, the daily contraction):
    float32 numpy planes ``xyz3k`` (3k, C) unit-sphere coordinates,
    coordinate-major, ``dist_t`` (k, C) km and ``mask_t`` (k, C) 0/1, plus the
    neighbour ``idx`` (C, k). The k nearest valid stations are chosen in
    float64 numpy."""
    lon, lat = world.grid.cell_lonlat(rows, cols)
    S = world.n_stations
    valid = np.ones(S, bool) if stn_valid is None else np.asarray(stn_valid, bool)
    d = haversine_km(lon[:, None], lat[:, None], world.stn_lon[None], world.stn_lat[None])
    d = np.where(valid[None, :], d, np.inf)
    idx = np.argsort(d, axis=1, kind="stable")[:, :k]
    dist = np.take_along_axis(d, idx, axis=1)
    mask = np.isfinite(dist)
    dist = np.where(mask, dist, 0.0)

    lonr, latr = np.deg2rad(world.stn_lon), np.deg2rad(world.stn_lat)
    xyz = np.stack(
        [np.cos(latr) * np.cos(lonr), np.cos(latr) * np.sin(lonr), np.sin(latr)], -1
    )
    out = dict(xyz3k=xyz[idx].transpose(2, 1, 0).reshape(-1, len(idx)), dist_t=dist.T,
               mask_t=mask.T)
    out = {name: np.ascontiguousarray(a, np.float32) for name, a in out.items()}
    out["idx"] = idx
    return out


class _Days:
    """Minimal DaysMetadata stand-in: the layout needs only month_idx."""

    def __init__(self, month_idx: np.ndarray):
        self.month_idx = month_idx
        self.ndays = len(month_idx)


def tile_inputs_from_world(
    world: SyntheticWorld,
    days_month_idx: np.ndarray,
    rows: np.ndarray,
    cols: np.ndarray,
    device: torch.device | str,
    dtype: torch.dtype = COMPUTE_DTYPE,
    stn_vario: np.ndarray | None = None,
) -> tuple[TileInputs, MonthLayout]:
    """TileInputs for the cells (rows, cols) of ``world`` on ``device``.
    Station variogram parameters default to the world's true ones; every
    station is valid in every month."""
    lon, lat = world.grid.cell_lonlat(rows, cols)
    S = world.n_stations
    if stn_vario is None:
        stn_vario = np.tile(np.array(world.true_vario, np.float64), (S, 12, 1))
    layout = month_layout(_Days(days_month_idx))
    anoms = group_days_by_month(world.stn_anoms.astype(np.float32), layout)
    t = lambda a: torch.as_tensor(np.asarray(a), device=device).to(dtype)  # noqa: E731
    ti = TileInputs(
        cell_lon=t(lon),
        cell_lat=t(lat),
        cell_elev=t(world.elev[rows, cols]),
        cell_tdi=t(world.tdi[rows, cols]),
        cell_lst=t(world.lst[:, rows, cols].T),
        cell_mask=torch.as_tensor(world.landmask[rows, cols], device=device),
        stn_lon=t(world.stn_lon),
        stn_lat=t(world.stn_lat),
        stn_elev=t(world.stn_elev),
        stn_tdi=t(world.stn_tdi),
        stn_lst=t(world.stn_lst),
        stn_norm=t(world.stn_norm),
        stn_vario=t(stn_vario),
        stn_valid=torch.ones((S, 12), dtype=torch.bool, device=device),
        stn_anoms=t(np.moveaxis(anoms, 1, 0)),
    )
    return ti, layout


class StationArrays(NamedTuple):
    """A station network as the station-side stages take it (numpy)."""

    lon: np.ndarray        # (S,)
    lat: np.ndarray        # (S,)
    elev: np.ndarray       # (S,)
    tdi: np.ndarray        # (S,)
    lst: np.ndarray        # (S, 12)
    norm: np.ndarray       # (S, 12) monthly normals
    vario: np.ndarray      # (S, 12, 3) float32 nugget/psill/range
    valid: np.ndarray      # (S, 12) bool
    anoms: np.ndarray      # (S, T) float32 daily anomalies
    month_idx: np.ndarray  # (T,) month of each day, 0-11

    def krig(self) -> tuple:
        """The eight leading arguments of the x-val and nnghs stages: lon,
        lat, elev, tdi, lst, norm, vario, valid."""
        return tuple(self[:8])


def station_arrays_from_world(world: SyntheticWorld, start: str = "2015-01-01") -> StationArrays:
    """The station arrays of ``world``, its days starting on ``start``.
    Variogram parameters are the world's true ones; every station is valid
    in every month."""
    S = world.n_stations
    d0 = np.datetime64(start, "D")
    days = get_days_metadata(d0, d0 + np.timedelta64(world.ndays - 1, "D"))
    return StationArrays(
        lon=world.stn_lon, lat=world.stn_lat, elev=world.stn_elev, tdi=world.stn_tdi,
        lst=world.stn_lst, norm=world.stn_norm,
        vario=np.tile(np.asarray(world.true_vario, np.float32), (S, 12, 1)),
        valid=np.ones((S, 12), bool),
        anoms=world.stn_anoms.astype(np.float32),
        month_idx=days.month_idx,
    )


def station_network_from_world(
    world: SyntheticWorld, month_idx: np.ndarray, missing_frac: float, seed: int
) -> tuple[np.ndarray, np.ndarray]:
    """(truth, obs): the (S, T) float32 daily station series of ``world``,
    truth = stn_norm[month] + stn_anoms, and obs = truth with entries
    missing (NaN) at random, each with probability ``missing_frac``, drawn
    from ``default_rng(seed)``."""
    S = world.n_stations
    truth = (world.stn_norm[np.arange(S)[:, None], month_idx[None, :]]
             + world.stn_anoms).astype(np.float32)
    gaps = np.random.default_rng(seed).uniform(size=truth.shape) < missing_frac
    return truth, np.where(gaps, np.float32(np.nan), truth)
