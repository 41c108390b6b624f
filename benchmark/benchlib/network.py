"""The station network of the network cells, made from the seed: the
configuration's stations over its extent (``benchlib/world.py``, on the
device), their true monthly normals and daily anomalies over the span, and
the observations with ``missing_frac`` of them missing at random."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from benchlib import world


class Network(NamedTuple):
    st: world.Stations   # stations; norm (2, S, 12), anoms (2, S, T): tmin first
    months: np.ndarray   # (T,) month of each day, 0-11
    truth: np.ndarray    # (S, T) float32 tmin: normal of the month + anomaly
    obs: np.ndarray      # truth with NaN where missing


def calendar(start: str, end: str) -> np.ndarray:
    d = np.arange(np.datetime64(start, "D"), np.datetime64(end, "D") + 1)
    return d.astype("datetime64[M]").astype(int) % 12


def network(ctx) -> Network:
    cfg = ctx.config
    months = calendar(cfg["start_date"], cfg["end_date"])
    w = cfg["world"]
    rows = int(round((cfg["lat_max"] - cfg["lat_min"]) / cfg["world_cellsize_deg"]))
    cols = int(round((cfg["lon_max"] - cfg["lon_min"]) / cfg["world_cellsize_deg"]))
    _, st = world.make(ctx.seed, ctx.device, region_rows=rows, region_cols=cols,
                       lon_min=cfg["lon_min"], lat_max=cfg["lat_max"],
                       cellsize=cfg["world_cellsize_deg"], margin_km=0.0,
                       km2_per_station=1.0, ndays=len(months), vario=tuple(w["vario"]),
                       dtr_mean=w["dtr_mean_C"], dtr_sd=w["dtr_sd_C"],
                       mode_km=w["synoptic_mode_km"], km2_per_mode=w["km2_per_synoptic_mode"],
                       own_anom_frac=w["tmax_own_anomaly_frac"], n_stations=cfg["n_stations"])
    truth = (st.norm[0][:, months] + st.anoms[0]).astype(np.float32)
    gaps = np.random.default_rng(ctx.seed).random(truth.shape) < cfg["missing_frac"]
    return Network(st=st, months=months, truth=truth,
                   obs=np.where(gaps, np.float32(np.nan), truth))
