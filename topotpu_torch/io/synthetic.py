"""Tile inputs and station arrays from a synthetic world.

The world itself comes from ``topotpu.io.synthetic.make_world`` (numpy only);
``tile_inputs_from_world`` is the torch counterpart of its namesake there, and
``station_arrays_from_world`` gives the numpy station arrays that the
station-side stages of both packages take, and ``station_network_from_world``
the gappy daily observation matrix that the infill stage takes.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from topotpu.core.dates import get_days_metadata
from topotpu.io.synthetic import SyntheticWorld
from topotpu.oracle.numpy_ref import haversine_km
from topotpu_torch.core.device import COMPUTE_DTYPE
from topotpu_torch.interp.point import (
    MonthLayout,
    TileInputs,
    group_days_by_month,
    month_layout,
)


def krig_rows_from_world(
    world: SyntheticWorld,
    rows: np.ndarray,
    cols: np.ndarray,
    k: int,
    month: int = 0,
    stn_valid: np.ndarray | None = None,
) -> dict:
    """Inputs of ``kernels.krig_normals.krig_normals_fused`` for the cells
    (rows, cols) of ``world`` and one month, as float32 numpy (rows, C)
    planes, plus the neighbour ``idx`` (C, k).

    The k nearest valid stations are chosen in float64 numpy, so the JAX
    package and the port can be fed identical neighbourhoods. Trend
    covariates are (elev, tdi, lst_month), anomaly covariates (elev, x_km,
    y_km); cell rows 0-2 are the trend covariates, rows 3-5 the anomaly
    ones. Station variogram parameters are the world's true ones."""
    lon, lat = world.grid.cell_lonlat(rows, cols)
    S = world.n_stations
    valid = np.ones(S, bool) if stn_valid is None else np.asarray(stn_valid, bool)
    d = haversine_km(lon[:, None], lat[:, None], world.stn_lon[None], world.stn_lat[None])
    d = np.where(valid[None, :], d, np.inf)
    idx = np.argsort(d, axis=1, kind="stable")[:, :k]
    dist = np.take_along_axis(d, idx, axis=1)
    mask = np.isfinite(dist)
    dist = np.where(mask, dist, 0.0)

    kx = 111.32 * np.cos(np.deg2rad(world.stn_lat.mean()))
    lonr, latr = np.deg2rad(world.stn_lon), np.deg2rad(world.stn_lat)
    xyz = np.stack(
        [np.cos(latr) * np.cos(lonr), np.cos(latr) * np.sin(lonr), np.sin(latr)], -1
    )
    vario = np.broadcast_to(np.asarray(world.true_vario, np.float64), (S, 3))

    def planes(per_stn):  # (S, n) -> (n k, C), covariate-major
        g = per_stn[idx]  # (C, k, n)
        return g.transpose(2, 1, 0).reshape(-1, len(idx))

    cell = np.zeros((8, len(idx)))
    cell[:3] = [world.elev[rows, cols], world.tdi[rows, cols], world.lst[month, rows, cols]]
    cell[3:6] = [world.elev[rows, cols], lon * kx, lat * 111.32]
    out = dict(
        xyz3k=planes(xyz),
        dist_t=dist.T,
        mask_t=mask.T,
        covs_t=planes(np.stack([world.stn_elev, world.stn_tdi, world.stn_lst[:, month]], 1)),
        cell_t=cell,
        norm_t=planes(world.stn_norm[:, month : month + 1]),
        vario_t=planes(vario),
        acovs_t=planes(np.stack([world.stn_elev, world.stn_lon * kx, world.stn_lat * 111.32], 1)),
    )
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
