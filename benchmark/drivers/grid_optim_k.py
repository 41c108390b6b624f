"""Driver of the grid at per-region neighbourhood sizes: the grid cell's
production (``drivers/grid_production.py``, whose parts it uses unchanged)
with each tile at its dominant region's (k, ka) a variable, as the program
runs the optim-nnghs table: ``cli/steps.py::_nnghs_table_core`` turns a
region raster and each variable's per-region sizes into the tile table, and
every ``TileEngine`` of the run takes it (``k_table``).

Set-up: ``grid_production``'s (the world, the engine's inputs, the sampled
cells, the sink, its warm-up), then the region raster (blocks of
``block_tiles`` x ``block_tiles`` tiles, numbered row-major), the table,
and a second warm-up: one engine over the region's first ``side`` x
``side`` tiles (``side`` ** 2 at least the number of regions), tile i at
region i's sizes, over the span's first two chunks, so that every distinct
(tmin, tmax) size set of the table runs before the window. Window:
production from the span's start, every engine with the table. Check:
``grid_production``'s, against ``reference/grid_sized.py`` at each sampled
cell's sizes, and ``k_table_faults``: a tile-pair whose manifest records,
for either variable, sizes other than its region's in the configuration,
or none.
"""

from __future__ import annotations

import dataclasses
import json
import math
import pathlib
import time
import types

import numpy as np

from benchlib import catalog
from benchlib import sink as sinks
from benchlib.runner import Check
from benchlib.timed_engine import timed_engine
from reference import grid_sized

gp = catalog.load_module("drivers", "grid_production")
VARS = gp.VARS


def regions(cfg: dict, nrows: int, ncols: int):
    """The region raster (nrows, ncols) int32, its ids, and each variable's
    per-region (k, ka) arrays, as ``_nnghs_table_core`` takes them."""
    tr, tc, b = cfg["tile_rows"], cfg["tile_cols"], cfg["regions"]["block_tiles"]
    n_cols = -(-ncols // (tc * b))
    n = -(-nrows // (tr * b)) * n_cols
    if n > len(cfg["nnghs"]["tmin"]):
        raise ValueError(f"{n} regions and sizes for {len(cfg['nnghs']['tmin'])}")
    r, c = np.ogrid[:nrows, :ncols]
    reg = ((r // (tr * b)) * n_cols + c // (tc * b)).astype(np.int32)
    ks = {v: tuple(np.array([s[i] for s in cfg["nnghs"][v][:n]]) for i in (0, 1))
          for v in VARS}
    return reg, np.arange(n), ks


def region_sizes(cfg: dict, nrows: int, ncols: int) -> dict:
    """tile id -> {var: [k, ka]} of the tile's region, from the
    configuration alone: what the manifests must record."""
    tr, tc, b = cfg["tile_rows"], cfg["tile_cols"], cfg["regions"]["block_tiles"]
    t_cols = -(-ncols // tc)
    n_cols = -(-t_cols // b)
    out = {}
    for tid in range(-(-nrows // tr) * t_cols):
        ti, tj = divmod(tid, t_cols)
        reg = (ti // b) * n_cols + tj // b
        out[tid] = {v: [int(x) for x in cfg["nnghs"][v][reg]] for v in VARS}
    return out


def setup(ctx):
    import torch

    from topotpu_torch.cli.steps import _nnghs_table_core
    from topotpu_torch.core.dates import get_days_metadata
    from topotpu_torch.core.grid import GridSpec
    from topotpu_torch.io.rasters import RasterStack

    s = gp.setup(ctx)
    cfg = ctx.config
    rasters, topo = s["rasters"], s["topo"]
    R, C = rasters.grid.shape
    reg, ids, ks = regions(cfg, R, C)
    table = _nnghs_table_core(reg, ids, ks, rasters, topo)
    if ctx.options.get("k_table_fault"):  # the tests' fault: tile 0 at another region's sizes
        table[0] = next(e for e in table.values() if e != table[0])

    # warm-up: every size set of the table, tile i of a side x side block at region i's
    side = math.isqrt(len(ids) - 1) + 1
    tr, tc = cfg["tile_rows"], cfg["tile_cols"]
    g = rasters.grid
    wgrid = GridSpec(lon0=g.lon0, lat0=g.lat0, cellsize=g.cellsize, nrows=side * tr,
                     ncols=side * tc)
    w = (slice(0, side * tr), slice(0, side * tc))
    warm = RasterStack(wgrid, rasters.elev[w], rasters.tdi[w], rasters.lst[(slice(None),) + w],
                       rasters.landmask[w])
    wr, wc = np.ogrid[: side * tr, : side * tc]
    wreg = ((wr // tr) * side + wc // tc).astype(np.int32)
    wks = {v: tuple(np.resize(a, side * side) for a in ks[v]) for v in VARS}
    wtable = _nnghs_table_core(wreg, np.arange(side * side), wks, warm, topo)
    days_np, years, _ = gp.calendar(cfg["start_date"], cfg["end_date"])
    span = days_np[years < int(years[0]) + 2 * ctx.traffic["years_per_chunk"]]
    wsets = [dataclasses.replace(st, anoms=st.anoms[:, : len(span)]) for st in s["sets"]]
    Warm = timed_engine(ctx.rec, sinks.make_sink(s["rows"][:0], s["cols"][:0]),
                        [float("inf")], ctx.tracer, False)
    root = pathlib.Path(ctx.tmpdir)
    Warm(topo, warm, get_days_metadata(str(span[0]), str(span[-1])), root / "warm_k",
         device=ctx.device, margin_km=cfg["margin_km"],
         mosaic_paths={v: root / f"warm_k_{v}" for v in VARS}, k_table=wtable,
         ).run_production_pair(*VARS, *wsets, years_per_chunk=ctx.traffic["years_per_chunk"],
                               progress=False)
    if ctx.device.type == "cuda":
        torch.cuda.synchronize()
    ctx.rec.spans.clear()
    ctx.rec.counters.clear()
    ctx.rec.meta["krig_normals_sized"] = dict(C=tr * tc, S=cfg["max_tile_stations"],
                                              V=len(VARS), N=1)
    s.update(k_table=table, want_k=region_sizes(cfg, R, C))
    return s


def window(ctx, s):
    """``grid_production``'s window, every engine with the table."""
    cfg = ctx.config
    root = pathlib.Path(ctx.tmpdir)
    s["deadline"][0] = time.perf_counter() + ctx.seconds
    while True:
        out = root / f"pass{len(s['passes'])}"
        eng = s["engine"](s["topo"], s["rasters"], s["days"], out, device=ctx.device,
                          margin_km=cfg["margin_km"],
                          mosaic_paths={v: out / f"mosaic_{v}" for v in VARS},
                          k_table=s["k_table"])
        eng.run_production_pair(*VARS, *s["sets"], years_per_chunk=ctx.traffic["years_per_chunk"],
                                progress=False)
        s["passes"].append(out)
        if time.perf_counter() >= s["deadline"][0]:
            return


def release(ctx, s):
    out = gp.release(ctx, s)
    out["want_k"] = s["want_k"]
    return out


def _k_table_faults(s) -> int:
    """Tile-pairs of the completed chunks whose manifest records, for either
    variable, sizes other than the tile's region's, or none."""
    faults = 0
    for p in s["passes"]:
        for chunk in sorted(pathlib.Path(p).glob("chunk_*/manifest.json")):
            tiles = json.loads(chunk.read_text())["tiles"]
            for tid, want in s["want_k"].items():
                faults += any((tiles.get(f"{v}_{tid:05d}") or {}).get("k") != want[v]
                              for v in VARS)
    return faults


def check(ctx, s):
    """``grid_production``'s check, its reference at each sampled cell's
    sizes, and ``k_table_faults``."""
    cfg = ctx.config
    tr, tc = cfg["tile_rows"], cfg["tile_cols"]
    tiles = (s["rows"] // tr) * -(-s["region"].elev.shape[1] // tc) + s["cols"] // tc
    sizes = np.array([[s["want_k"][int(t)][v] for t in tiles] for v in VARS])  # (V, n, 2)
    # this driver's own copy of grid_production: its reference, and the
    # control's, take the sizes
    gp.ref_grid = types.SimpleNamespace(
        reference=lambda *args: grid_sized.reference(*args, sizes))
    checks, attempted, failed = gp.check(ctx, s)
    k_faults = _k_table_faults(s)
    return checks + [Check("k_table_faults", k_faults, 0)], attempted, failed + k_faults
