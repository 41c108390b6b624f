"""Driver of the four-rank grid cell: TopoWx's daily grid production as a job
of ``processes`` processes on one host, one card each, through
``TileEngine(ctx=...)`` and ``run_production_pair`` (tmin, tmax) direct to a
shard a rank, reconcile on, in chunks of ``years_per_chunk``.

This process is rank 0, the coordinator, on ``cuda:0``; it starts the other
ranks (``benchlib/ranks.py``, which has the steps every rank runs) and
builds or loads the kernels before any of them joins.

Set-up: every rank's world from the seed on its own card, its warm-up, and
a barrier. Window: from the barrier that opens it to the one that closes it,
which rank 0 leaves when the slowest rank has stopped at its first chunk
boundary past rank 0's start plus ``--seconds``. Release: the workers'
results (their counters, span records, memory peaks and shards at the
sampled cells); every chunk's manifests merged by the coordinator
(``multihost.merge_manifests``). Check: the product assembled from the
shards by ``reference/shards.py`` at the sampled cells against the plain
reference (``reference/grid.py``) in float64; every merged manifest; the
shards' attributes, claims and world digests; the workers' exits.
"""

from __future__ import annotations

import json
import pathlib
import sys
import threading
import time

import numpy as np

from benchlib import catalog
from benchlib import ranks
from benchlib.runner import Check
from reference import grid as ref_grid
from reference import shards as ref_shards

VARS = ranks.VARS
SENTINEL = -32768


def setup(ctx):
    import torch

    count = int(ctx.config["processes"])
    job = dict(name=ctx.name, cell=ctx.cell, config=ctx.config, traffic=ctx.traffic,
               seed=ctx.seed, seconds=ctx.seconds, trace=bool(ctx.tracer.enabled),
               options=ctx.options, processes=count, tmp=ctx.tmpdir)
    ranks.job_file(ctx.tmpdir).write_text(json.dumps(job))
    gang = ranks.Gang(ctx.tmpdir, count, float(ctx.cell["worker_bound_s"]))
    gang.start()
    try:
        if ctx.device.type == "cuda":
            ranks.build_kernels()
        mh = gang.join()
        s = ranks.setup_rank(job, mh, ctx.rec, ctx.tracer)
        if s["device"] != ctx.device:
            raise RuntimeError(f"rank 0 steps on {s['device']}, the harness measures {ctx.device}")
        _barrier(gang, "set-up done")
    except BaseException:
        gang.stop()
        raise
    s.update(gang=gang, count=count)
    # rank 0's step shapes, for the one-card cell's kernel rooflines
    gp = catalog.load_module("drivers", "grid_production")
    cfg = ctx.config
    shape = dict(C=cfg["tile_rows"] * cfg["tile_cols"], k=cfg["k_neighbors"],
                 S=cfg["max_tile_stations"], V=2)
    ctx.rec.meta.update(krig_normals=dict(shape, P=24, N=1), scatter_daily_packed=dict(shape),
                        chunk_days={int(t0): int(n)
                                    for t0, n in zip(*gp._chunk_starts(s["years"]))})
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
    return s


def _barrier(gang, name):
    """A barrier of rank 0 that a dead or late worker turns into an error
    naming it."""
    from topotpu_torch.dist import multihost

    try:
        multihost.barrier(name)
    except Exception as e:
        raise RuntimeError(f"grid ranks, at {name!r}: {gang.fault or e}\n{gang.logs()}") from e


def window(ctx, s):
    gang = s["gang"]
    gang.on_fault = lambda: s["deadline"].__setitem__(0, float("-inf"))  # stop at the next chunk
    kill = ctx.options.get("kill")  # the tests': (rank, seconds into the window)
    if kill:
        threading.Timer(kill[1], gang.procs[kill[0]].kill).start()
    try:
        deadline = ranks.open_window(s["count"], time.perf_counter() + ctx.seconds)
        gang.limit = deadline + gang.bound_s
        ranks.run_window(s, deadline)
    except BaseException as e:
        gang.stop()
        if gang.fault is None:
            raise
        raise RuntimeError(f"grid ranks: {gang.fault} (rank_faults {max(1, len(gang.dead))})\n"
                           f"{gang.logs()}") from e
    gang.guarding = False  # no collective is left to wait in: results() bounds the rest
    if gang.fault is not None:  # the watch fired as the window closed
        gang.stop()
        raise RuntimeError(f"grid ranks: {gang.fault}\n{gang.logs()}")
    s["t_end"] = time.perf_counter()


def release(ctx, s):
    """The workers' results and rank 0's own, every chunk's manifests merged,
    the fullest card's peak as the run's; the engines and shard buffers let
    go."""
    import torch
    import torch.distributed as dist

    from topotpu_torch.dist import multihost
    from topotpu_torch.utils.profiling import recorded

    gang = s["gang"]
    try:
        got = gang.results(s["t_end"])
    finally:
        gang.stop()
    records = recorded(*ctx.rec.window) if ctx.rec.trace is not None else []
    own = ranks.shard_result(s, ctx.rec, ctx.rec.memory_peak_bytes, records)
    results = {0: own, **got}
    merge_faults = 0
    for d in sorted(pathlib.Path(ctx.tmpdir).glob("pass*/chunk_*")):
        try:
            multihost.merge_manifests(d)
        except RuntimeError:  # a tile claimed by two ranks
            merge_faults += 1
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    metas = [r[0] for r in results.values() if r is not None]
    ctx.rec.meta["ranks"] = [dict(rank=m["rank"], var_cell_days=m["var_cell_days"],
                                  tile_pairs=m["tile_pairs"], records=m["records"])
                             for m in metas]
    ctx.rec.memory_peak_bytes = max(m["memory_peak_bytes"] for m in metas)
    for m in metas:
        print(f"grid ranks: rank {m['rank']} pid {m['pid']} on {m['device']}: contexts on cards "
              f"{m['contexts']}, {m['tile_pairs']} tile-pairs, {len(m['chunks'])} chunks, "
              f"peak {m['memory_peak_bytes']} B", file=sys.stderr)
    s["sink"].BUFFERS.clear()
    s["sink"].OPEN.clear()
    out = {k: s[k] for k in ("st", "region", "rows", "cols", "months", "years", "cfg", "count",
                             "digest")}
    out.update(results=results, dead=sorted(gang.dead), merge_faults=merge_faults)
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def _land_tiles(s) -> dict:
    """{tile id: land cells} of the region."""
    cfg = s["cfg"]
    R, C = s["region"].elev.shape
    tr, tc = cfg["tile_rows"], cfg["tile_cols"]
    per_row = -(-C // tc)
    land = {}
    for tid in range(-(-R // tr) * per_row):
        r0, c0 = divmod(tid, per_row)
        n = int(s["region"].landmask[r0 * tr : (r0 + 1) * tr, c0 * tc : (c0 + 1) * tc].sum())
        if n:
            land[tid] = n
    return land


def _manifest_faults(ctx, s, sequence, finished) -> tuple[int, int]:
    """(tile-pairs recorded complete, faults) over the merged manifests:
    chunk j must hold every land tile of the ranks that finished it, and no
    other, each covered as its land, ``viol`` 0, and (a pass's first chunk)
    normals and se over its land."""
    land = _land_tiles(s)
    count = s["count"]
    done, faults = 0, s["merge_faults"]
    for j, chunk in enumerate(sequence):
        path = pathlib.Path(ctx.tmpdir) / f"pass{chunk['pass_']}" / chunk["name"] / "manifest.json"
        tiles = json.loads(path.read_text())["tiles"] if path.is_file() else {}
        ranks_in = {r for r, n in finished.items() if n > j}
        want = {f"{v}_{tid:05d}" for tid in land if tid % count in ranks_in for v in VARS}
        faults += len(set(tiles) - want)  # a tile of a rank that did not finish the chunk
        for tid, n_land in land.items():
            if tid % count not in ranks_in:
                continue
            entries = [tiles.get(f"{v}_{tid:05d}") for v in VARS]
            bad = any(e is None for e in entries)
            for e in entries:
                if e is None:
                    continue
                ver = e.get("verify", {})
                bad |= ver.get("covered") != n_land or ver.get("viol") != 0
                if chunk["t0"] == 0:
                    bad |= ver.get("normal") != n_land or ver.get("se") != n_land
            faults += bool(bad)
            done += not bad
    return done, faults


def product(s) -> dict:
    """The job's product at the sampled cells, assembled from the ranks'
    shards by ``reference/shards.py``: normals and se (V, 12, n) float32,
    each chunk's dailies (V, nt, n) int16 and the cells whose owner finished
    it; the chunks in order, the chunks each rank finished, and the shard
    faults (attributes, claims, world digests, cells written by another than
    their owner)."""
    cfg, count = s["cfg"], s["count"]
    results = s["results"]
    metas = {r: v[0] for r, v in results.items() if v is not None}
    arrays = {r: v[1] for r, v in results.items() if v is not None}
    finished = {r: len(m["chunks"]) for r, m in metas.items()}
    sequence = max(metas.values(), key=lambda m: len(m["chunks"]))["chunks"]

    land = _land_tiles(s)
    faults = sum(m["digest"] != s["digest"] for m in metas.values())
    for r, m in metas.items():
        n_own = sum(1 for t in land if t % count == r)
        faults += sum(ref_shards.attr_faults(a, r, count, n_own)
                      for v in VARS for a in m["attrs"][v])
        faults += sum(1 for a, b in zip(m["chunks"], sequence)
                      if (a["pass_"], a["t0"]) != (b["pass_"], b["t0"]))
    for j in range(len(sequence)):
        faults += ref_shards.claim_faults(
            [metas[r]["chunks"][j]["tiles"] if finished.get(r, 0) > j else []
             for r in range(count)], count)

    rows, cols = s["rows"], s["cols"]
    n = len(rows)
    owner = ref_shards.owners(ref_shards.tile_ids(rows, cols, cfg["tile_rows"], cfg["tile_cols"],
                                                  s["region"].elev.shape[1]), count)

    def from_shards(key, wrote_key, shape, fill, dtype, j=-1):
        """Every rank's ``key`` (of chunk ``j``, where given) assembled; a
        rank without it wrote nothing."""
        nonlocal faults
        vals, wrote = [], []
        for r in range(count):
            have = r in arrays and finished.get(r, 0) > j
            vals.append(arrays[r][key] if have else np.full(shape, fill, dtype))
            wrote.append(arrays[r][wrote_key] if have else np.zeros(n, bool))
        out, foreign = ref_shards.assemble(np.stack(vals), np.stack(wrote), owner, fill)
        faults += int(foreign.sum())
        return out

    out = dict(normal=np.stack([from_shards(f"{v}.normal", f"{v}.monthly", (12, n), np.nan,
                                            np.float32) for v in VARS]),
               se=np.stack([from_shards(f"{v}.se", f"{v}.monthly", (12, n), np.nan, np.float32)
                            for v in VARS]),
               daily=[], comparable=[], sequence=sequence, finished=finished, metas=metas)
    for j, chunk in enumerate(sequence):
        out["daily"].append(np.stack([from_shards(f"{v}.daily.{j}", f"{v}.wrote.{j}",
                                                  (chunk["nt"], n), SENTINEL, np.int16, j)
                                      for v in VARS]))
        out["comparable"].append(np.array([finished.get(int(o), 0) > j for o in owner]))
    out["shard_faults"] = faults
    return out


def check(ctx, s):
    cfg = s["cfg"]
    gp = catalog.load_module("drivers", "grid_production")
    scale, offset = gp.lattice(cfg)
    p = product(s)
    sequence, finished, metas = p["sequence"], p["finished"], p["metas"]
    comparable = p["comparable"]
    rank_faults = len(set(s["dead"]) | {r for r, v in s["results"].items() if v is None})
    rows, cols = s["rows"], s["cols"]
    n = len(rows)
    st = s["st"]
    sd = dict(lon=st.lon, lat=st.lat, elev=st.elev, tdi=st.tdi, lst=st.lst, norm=st.norm,
              vario=st.vario, anoms=st.anoms)
    reg = s["region"]
    region = dict(lon0=reg.lon0, lat0=reg.lat0, cellsize=reg.cellsize, elev=reg.elev,
                  tdi=reg.tdi, lst=reg.lst)
    chunks = [(c["t0"], s["months"][c["t0"] : c["t0"] + c["nt"]]) for c in sequence]
    want = ref_grid.reference(sd, region, cfg, rows, cols, chunks, "f64", ctx.device)
    if ctx.options.get("control"):
        got = ref_grid.reference(sd, region, cfg, rows, cols, chunks, "tf32", ctx.device)
        se_scale, se_off = float(np.float32(cfg["pack_se_hi"] / 65500.0)), float(
            np.float32(0.5 * cfg["pack_se_hi"]))
        normal = gp._quantized(got["normal"], scale, offset)
        se = gp._quantized(got["se"], se_scale, se_off)
        daily = [gp._quantized(d, scale, offset) for d in got["daily"]]
    else:
        normal = p["normal"].astype(np.float64)
        se = p["se"].astype(np.float64)
        daily = [np.where(q == SENTINEL, np.nan, q.astype(np.float64) * scale + offset)
                 for q in p["daily"]]

    det = want["gap_km"] >= float(ctx.cell["tie_km"])
    print(f"grid ranks check: {int((~det).sum())} of {n} sampled cells at a tie of their k-th "
          f"neighbour (within {ctx.cell['tie_km']} km), not compared; chunks finished by rank "
          f"{finished}", file=sys.stderr)

    def gap(a, b, keep):
        both = np.isfinite(a) & np.isfinite(b) & det & keep
        return float(np.abs(a[both] - b[both]).max()) if both.any() else 0.0

    every = np.ones(n, bool)
    mismatch = int((np.isfinite(normal) != np.isfinite(want["normal"])).sum()
                   + (np.isfinite(se) != np.isfinite(want["se"])).sum()
                   + sum(int(((np.isfinite(d) != np.isfinite(w)) & c).sum())
                         for d, w, c in zip(daily, want["daily"], comparable)))
    done, faults = _manifest_faults(ctx, s, sequence, finished)
    attempted = sum(m["tile_pairs"] for m in metas.values())
    lim = ctx.cell["limits"]
    checks = [
        Check("normal_se_err_C", max(gap(normal, want["normal"], every),
                                     gap(se, want["se"], every)), lim["normal_se_err_C"]),
        Check("daily_err_C", max((gap(d, w, c) for d, w, c in
                                  zip(daily, want["daily"], comparable)), default=0.0),
              lim["daily_err_C"]),
        Check("ok_mismatch", mismatch, 0),
        Check("manifest_faults", faults + abs(attempted - done), 0),
        Check("shard_faults", p["shard_faults"], 0),
        Check("rank_faults", rank_faults, 0),
        Check("chunks_compared_short", max(0, 1 - min(finished.values(), default=0)), 0),
    ]
    return checks, attempted, faults + abs(attempted - done)
