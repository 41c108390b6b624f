"""Driver of the grid cells: TopoWx's daily grid production through
``TileEngine.run_production_pair`` (tmin, tmax), direct to a mosaic on the
run-global int16 lattice, reconcile on, in chunks of ``years_per_chunk``.

Set-up: the world from the seed (``benchlib/world.py``), the engine's inputs,
the sampled cells, the sink's buffers, and a warm-up: the same engine over
the region's first tile for the span's first two chunks (a leap year and
another), which builds or loads the kernels and runs every shape the window
runs. Window: production from the span's start; the engine stops at the
first chunk boundary past ``--seconds`` and, where the span runs out first,
production starts again from its first chunk. Check: every completed
chunk's manifest holds both variables of every tile, covered as its land,
``viol`` 0; and the sampled cells' normals, se and dailies of every chunk
in the window, from the sink, against the plain reference
(``reference/grid.py``), in float64 on the device.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import sys
import time

import numpy as np

from benchlib import sink as sinks
from benchlib import world
from benchlib.runner import Check
from benchlib.timed_engine import timed_engine
from reference import grid as ref_grid

VARS = ("tmin", "tmax")


def calendar(start: str, end: str):
    """Days, their years and their months (0-11), numpy."""
    d = np.arange(np.datetime64(start, "D"), np.datetime64(end, "D") + 1)
    return d, d.astype("datetime64[Y]").astype(int) + 1970, d.astype("datetime64[M]").astype(int) % 12


def _chunk_starts(years):
    """Each year's first day offset and its day count (chunks of one year)."""
    first = np.flatnonzero(np.r_[True, years[1:] != years[:-1]])
    return first, np.diff(np.r_[first, len(years)])


def lattice(cfg: dict):
    """The run-global daily lattice (scale, offset) as float32, from the
    configuration's pack window."""
    lo, hi = cfg["pack_temp_lo"], cfg["pack_temp_hi"]
    return float(np.float32((hi - lo) / 65500.0)), float(np.float32(0.5 * (hi + lo)))


def _world_args(cfg: dict, ndays: int) -> dict:
    w = cfg["world"]
    return dict(region_rows=cfg["region_rows"], region_cols=cfg["region_cols"],
                lon_min=cfg["region_lon_min"], lat_max=cfg["region_lat_max"],
                cellsize=cfg["cellsize_deg"], margin_km=cfg["margin_km"],
                km2_per_station=cfg["km2_per_station"], ndays=ndays,
                vario=tuple(w["vario"]), dtr_mean=w["dtr_mean_C"], dtr_sd=w["dtr_sd_C"],
                mode_km=w["synoptic_mode_km"], km2_per_mode=w["km2_per_synoptic_mode"],
                own_anom_frac=w["tmax_own_anomaly_frac"])


def setup(ctx):
    import torch

    from topotpu_torch.core.config import InterpParams, TopoConfig
    from topotpu_torch.core.dates import get_days_metadata
    from topotpu_torch.core.grid import GridSpec
    from topotpu_torch.dist.engine import StationSet
    from topotpu_torch.io.rasters import RasterStack

    cfg = ctx.config
    days_np, years, months = calendar(cfg["start_date"], cfg["end_date"])
    region, st = world.make(ctx.seed, ctx.device, **_world_args(cfg, len(days_np)))
    R, C = region.elev.shape
    grid = GridSpec(lon0=region.lon0, lat0=region.lat0, cellsize=region.cellsize, nrows=R,
                    ncols=C)
    rasters = RasterStack(grid, region.elev, region.tdi, region.lst, region.landmask)
    valid = np.ones((len(st.lon), 12), bool)
    sets = [StationSet(lon=st.lon, lat=st.lat, elev=st.elev, tdi=st.tdi, lst=st.lst,
                       norm=st.norm[v], vario=st.vario, valid=valid, anoms=st.anoms[v])
            for v in range(2)]
    interp = InterpParams(k_neighbors=cfg["k_neighbors"], k_neighbors_anom=cfg["k_neighbors_anom"],
                          max_tile_stations=cfg["max_tile_stations"],
                          min_neighbors=cfg["min_neighbors"], ridge=cfg["ridge"],
                          chol_jitter=cfg["chol_jitter"], weight_kernel=cfg["weight_kernel"])
    topo = TopoConfig(start_date=cfg["start_date"], end_date=cfg["end_date"],
                      cellsize=cfg["cellsize_deg"], tile_rows=cfg["tile_rows"],
                      tile_cols=cfg["tile_cols"], output_pack=True, mosaic_direct=True,
                      pack_temp_lo=cfg["pack_temp_lo"], pack_temp_hi=cfg["pack_temp_hi"],
                      pack_se_hi=cfg["pack_se_hi"], interp=interp)

    rng = np.random.default_rng(ctx.seed)
    pick = rng.choice(R * C, int(ctx.cell["sample_cells"]), replace=False)
    rows, cols = np.unravel_index(pick, (R, C))
    Sink = sinks.make_sink(rows, cols)
    Sink.prepare(R, C, VARS)
    deadline = [float("inf")]
    alter = _fault(ctx, rows, cols, cfg) if ctx.options.get("fault") else None
    Engine = timed_engine(ctx.rec, Sink, deadline, ctx.tracer, ctx.tracer.enabled, alter)

    # warm-up: the first tile over the first two chunks, into a sink of its own
    y0 = int(years[0])
    span = days_np[years < y0 + 2 * ctx.traffic["years_per_chunk"]]
    t1 = GridSpec(lon0=grid.lon0, lat0=grid.lat0, cellsize=grid.cellsize,
                  nrows=cfg["tile_rows"], ncols=cfg["tile_cols"])
    tr, tc = cfg["tile_rows"], cfg["tile_cols"]
    one = RasterStack(t1, region.elev[:tr, :tc], region.tdi[:tr, :tc],
                      region.lst[:, :tr, :tc], region.landmask[:tr, :tc])
    Warm = timed_engine(ctx.rec, sinks.make_sink(rows[:0], cols[:0]), [float("inf")],
                        ctx.tracer, False)
    wd = get_days_metadata(str(span[0]), str(span[-1]))
    warm_sets = [dataclasses.replace(s, anoms=s.anoms[:, : len(span)]) for s in sets]
    root = pathlib.Path(ctx.tmpdir)
    Warm(topo, one, wd, root / "warm", device=ctx.device, margin_km=cfg["margin_km"],
         mosaic_paths={v: root / f"warm_{v}" for v in VARS}).run_production_pair(
        *VARS, *warm_sets, years_per_chunk=ctx.traffic["years_per_chunk"], progress=False)
    if ctx.device.type == "cuda":
        torch.cuda.synchronize()
    ctx.rec.spans.clear()
    ctx.rec.counters.clear()
    k, tr, tc = cfg["k_neighbors"], cfg["tile_rows"], cfg["tile_cols"]
    shape = dict(C=tr * tc, k=k, S=cfg["max_tile_stations"], V=2)
    ctx.rec.meta.update(krig_normals=dict(shape, P=24, N=1), scatter_daily_packed=dict(shape),
                        chunk_days={int(t0): int(n) for t0, n in zip(*_chunk_starts(years))})
    return dict(engine=Engine, topo=topo, rasters=rasters, days=get_days_metadata(
        cfg["start_date"], cfg["end_date"]), sets=sets, st=st, region=region, rows=rows,
        cols=cols, sink=Sink, deadline=deadline, months=months, years=years, passes=[])


def window(ctx, s):
    cfg = ctx.config
    root = pathlib.Path(ctx.tmpdir)
    s["deadline"][0] = time.perf_counter() + ctx.seconds
    while True:
        out = root / f"pass{len(s['passes'])}"
        eng = s["engine"](s["topo"], s["rasters"], s["days"], out, device=ctx.device,
                          margin_km=cfg["margin_km"],
                          mosaic_paths={v: out / f"mosaic_{v}" for v in VARS})
        eng.run_production_pair(*VARS, *s["sets"], years_per_chunk=ctx.traffic["years_per_chunk"],
                                progress=False)
        s["passes"].append(out)
        if time.perf_counter() >= s["deadline"][0]:
            return


def release(ctx, s):
    """Keep what the check reads (the sink's samples, normals and se, the
    manifests' paths, the inputs); let go of the engine and device memory."""
    import torch

    Sink = s["sink"]
    keep = dict(snapshots={v: list(Sink.SNAPSHOTS[v]) for v in VARS},
                normal={v: Sink.OPEN[v].normal[:, s["rows"], s["cols"]].copy() for v in VARS},
                se={v: Sink.OPEN[v].se[:, s["rows"], s["cols"]].copy() for v in VARS})
    Sink.BUFFERS.clear()
    Sink.OPEN.clear()
    out = {k: s[k] for k in ("st", "region", "rows", "cols", "months", "years", "passes")}
    out.update(keep)
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def _manifest_faults(ctx, s) -> tuple[int, int]:
    """(tile-pairs recorded complete, faults): a missing entry, coverage
    other than the tile's land, ``viol`` other than 0, or (first chunk)
    normals or se short of the land count."""
    cfg = ctx.config
    R, C = s["region"].elev.shape
    tr, tc = cfg["tile_rows"], cfg["tile_cols"]
    land = {}
    for tid in range(-(-R // tr) * -(-C // tc)):
        r0, c0 = divmod(tid, -(-C // tc))
        land[tid] = int(s["region"].landmask[r0 * tr : (r0 + 1) * tr, c0 * tc : (c0 + 1) * tc].sum())
    done, faults = 0, 0
    for p in s["passes"]:
        for chunk in sorted(pathlib.Path(p).glob("chunk_*/manifest.json")):
            tiles = json.loads(chunk.read_text())["tiles"]
            first = chunk.parent.name == f"chunk_{s['years'][0]}_{s['years'][0]}"
            for tid, n_land in land.items():
                entries = [tiles.get(f"{v}_{tid:05d}") for v in VARS]
                bad = any(e is None for e in entries)
                for e in entries:
                    if e is None:
                        continue
                    ver = e.get("verify", {})
                    bad |= ver.get("covered") != n_land or ver.get("viol") != 0
                    if first:
                        bad |= ver.get("normal") != n_land or ver.get("se") != n_land
                faults += bool(bad)
                done += not bad
    return done, faults


def _quantized(x, scale, offset):
    """``x`` on the lattice and back, NaN kept (the control's values)."""
    q = np.clip(np.rint((x - offset) / scale), -32767, 32767)
    return q * scale + offset


def check(ctx, s):
    cfg = ctx.config
    scale, offset = lattice(cfg)
    st = s["st"]
    sd = dict(lon=st.lon, lat=st.lat, elev=st.elev, tdi=st.tdi, lst=st.lst, norm=st.norm,
              vario=st.vario, anoms=st.anoms)
    reg = s["region"]
    region = dict(lon0=reg.lon0, lat0=reg.lat0, cellsize=reg.cellsize, elev=reg.elev,
                  tdi=reg.tdi, lst=reg.lst)
    snaps = list(zip(*(s["snapshots"][v] for v in VARS)))
    chunks = [(t0, s["months"][t0 : t0 + a.shape[0]]) for (t0, a), _ in snaps]
    want = ref_grid.reference(sd, region, cfg, s["rows"], s["cols"], chunks, "f64", ctx.device)

    if ctx.options.get("control"):
        got = ref_grid.reference(sd, region, cfg, s["rows"], s["cols"], chunks, "tf32",
                                 ctx.device)
        se_scale, se_off = float(np.float32(cfg["pack_se_hi"] / 65500.0)), float(
            np.float32(0.5 * cfg["pack_se_hi"]))
        normal = _quantized(got["normal"], scale, offset)
        se = _quantized(got["se"], se_scale, se_off)
        daily = [_quantized(d, scale, offset) for d in got["daily"]]
    else:
        normal = np.stack([s["normal"][v] for v in VARS]).astype(np.float64)
        se = np.stack([s["se"][v] for v in VARS]).astype(np.float64)
        daily = []
        for pair in snaps:
            q = np.stack([a for _, a in pair]).astype(np.float64)  # (V, nt, n)
            daily.append(np.where(q == sinks.SENTINEL, np.nan, q * scale + offset))

    # a cell whose k-th and next pool stations lie within tie_km: float32
    # distances do not determine its neighbourhood, so it is not compared
    det = want["gap_km"] >= float(ctx.cell["tie_km"])
    print(f"grid check: {int((~det).sum())} of {len(det)} sampled cells at a tie of their "
          f"k-th neighbour (within {ctx.cell['tie_km']} km), not compared", file=sys.stderr)

    def gap(a, b):
        both = np.isfinite(a) & np.isfinite(b) & det
        return float(np.abs(a[both] - b[both]).max()) if both.any() else 0.0

    mismatch = int((np.isfinite(normal) != np.isfinite(want["normal"])).sum()
                   + (np.isfinite(se) != np.isfinite(want["se"])).sum()
                   + sum(int((np.isfinite(d) != np.isfinite(w)).sum())
                         for d, w in zip(daily, want["daily"])))
    done, faults = _manifest_faults(ctx, s)
    attempted = int(ctx.rec.counters["tile_pairs"])
    lim = ctx.cell["limits"]
    # se goes with the normals: its float32 and its TF32 errors both lie under
    # half its lattice step (2.4e-4 C), so alone no limit parts the two
    checks = [
        Check("normal_se_err_C", max(gap(normal, want["normal"]), gap(se, want["se"])),
              lim["normal_se_err_C"]),
        Check("daily_err_C", max((gap(d, w) for d, w in zip(daily, want["daily"])), default=0.0),
              lim["daily_err_C"]),
        Check("ok_mismatch", mismatch, 0),
        Check("manifest_faults", faults + abs(attempted - done), 0),
        Check("chunks_compared_short", max(0, 1 - len(snaps)), 0),
    ]
    return checks, attempted, faults + abs(attempted - done)


def _fault(ctx, rows, cols, cfg):
    """The tests' planted fault: the first sampled cell's first daily value
    of tmin, 0.49 C (200 lattice steps) off where the step produces it."""
    tr, tc = cfg["tile_rows"], cfg["tile_cols"]
    r, c = int(rows[0]), int(cols[0])

    def alter(engine, spec, out):
        if engine.mosaic_t0 == 0 and spec.row0 <= r < spec.row0 + tr and spec.col0 <= c < spec.col0 + tc:
            out.buf[0, (r - spec.row0) * tc + (c - spec.col0)] += 200
    return alter
