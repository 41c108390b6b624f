"""The grid job over several processes: one process a card, each owning the
tiles with ``tile_id % count == rank``, each writing its own shard and its
own manifest a chunk (``dist/multihost.py``, ``TileEngine(ctx=...)``).

Rank 0 is the harness's process (``drivers/grid_ranks.py``); it starts the
other ranks as processes of this file, which it names the job's scratch
directory and the coordinator's address:

    python3 benchmark/benchlib/ranks.py <rank> <host:port> <scratch dir>

The scratch directory holds the job (``job.json``: the cell, its
configuration and traffic, the seed, the window's length, the options) and,
at the end, each worker's result (``rank<r>.npz`` and ``rank<r>.json``) and
log (``rank<r>.log``). Every rank runs the same steps (``setup_rank``,
``open_window``, ``run_window``, ``shard_result``):

* set-up: ``init_multihost``; the rank's card from ``local_mesh``, which
  makes it the process's current device; the world
  from the seed on that card, and its digest; the sampled cells; a shard of
  the rank's own tiles (``benchlib/shard_sink.py``); a warm-up over its
  first owned tile for two chunks; a look at which cards the process holds
  a context on: any but its own fails set-up;
* the window opens at ``multihost.barrier("window start")``, with rank 0's
  deadline sent to every rank; each rank runs production passes and stops
  at its first chunk boundary past it, then waits at
  ``multihost.barrier("window end")``, which rank 0 leaves when the slowest
  rank is done;
* a traced run profiles every rank alike; a worker returns its counters,
  its program span records, its card's memory peak and its shard at the
  sampled cells, unless it loaded JAX or the JAX package: then it exits
  with an error and no result.

Rank 0 watches the workers (``Gang``): a worker that dies, or that has not
reached the end of the window 60 s (the cell's ``worker_bound_s``) past the
deadline, has every worker killed; the collective rank 0 waits in then fails
(gloo reports the closed connection), and should it not, rank 0 ends itself
with an error. A worker dies with rank 0 (``PR_SET_PDEATHSIG``).
"""

from __future__ import annotations

import atexit
import dataclasses
import hashlib
import json
import os
import pathlib
import signal
import socket
import subprocess
import sys
import threading
import time
import types

import numpy as np

HERE = pathlib.Path(__file__).resolve().parent
BENCH = HERE.parent
ROOT = BENCH.parent
VARS = ("tmin", "tmax")
KERNELS = ("krig_normals", "scatter_daily")  # the grid step's libraries
GRACE_S = 20.0  # after the workers are killed, the longest rank 0 waits to see its call fail


def job_file(tmp) -> pathlib.Path:
    return pathlib.Path(tmp) / "job.json"


def result_files(tmp, rank: int):
    return pathlib.Path(tmp) / f"rank{rank}.npz", pathlib.Path(tmp) / f"rank{rank}.json"


def log_file(tmp, rank: int) -> pathlib.Path:
    return pathlib.Path(tmp) / f"rank{rank}.log"


def build_kernels() -> None:
    """Rank 0 builds (or finds) the step's CUDA libraries before any worker
    joins the job; the workers only load them."""
    from topotpu_torch.kernels import _build

    for name in KERNELS:
        _build.build(name)


class Gang:
    """Ranks 1 .. count-1 as processes of this file, and rank 0's watch over
    them (see the module docstring)."""

    def __init__(self, tmp, count: int, bound_s: float):
        self.tmp = pathlib.Path(tmp)
        self.count = count
        self.bound_s = bound_s
        self.procs: dict = {}
        self.sock = None
        self.coordinator = None
        self.limit = None      # perf_counter time by which the current wait must end
        self.on_fault = None   # called from the watch when it kills the workers
        self.fault = None      # what went wrong, for the error rank 0 raises
        self.dead: set = set()
        self.guarding = True   # until the window has closed: rank 0 may wait in a collective
        self._done = threading.Event()
        self._thread = None

    def start(self) -> None:
        """Bind the coordinator's port, start the workers and the watch."""
        if self.count == 1:
            return
        self.sock = socket.socket()
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen()
        self.coordinator = f"127.0.0.1:{self.sock.getsockname()[1]}"
        atexit.register(self.stop)
        for rank in range(1, self.count):
            with open(log_file(self.tmp, rank), "w") as out:
                self.procs[rank] = subprocess.Popen(
                    [sys.executable, str(HERE / "ranks.py"), str(rank), self.coordinator,
                     str(self.tmp)],
                    cwd=ROOT, stdout=out, stderr=subprocess.STDOUT, stdin=subprocess.DEVNULL)
        self._thread = threading.Thread(target=self._watch, name="rank-watch", daemon=True)
        self._thread.start()

    def join(self):
        """Rank 0's ``init_multihost``, serving the rendezvous on the port
        bound in ``start``."""
        from topotpu_torch.dist import multihost

        if self.count == 1:
            return multihost.init_multihost(None, 1, 0)
        fd = os.dup(self.sock.fileno())
        os.environ[multihost.COORDINATOR_FD_ENV] = str(fd)
        try:
            return multihost.init_multihost(self.coordinator, self.count, 0)
        finally:
            os.environ.pop(multihost.COORDINATOR_FD_ENV, None)
            self.sock.close()

    def _watch(self) -> None:
        while not self._done.wait(0.2):
            if not self.guarding:
                continue
            dead = {r for r, p in self.procs.items() if p.poll() not in (None, 0)}
            late = self.limit is not None and time.perf_counter() > self.limit
            if not dead and not late:
                continue
            self.dead |= dead
            self.fault = (f"worker(s) {sorted(dead)} died" if dead else
                          f"a worker had not finished {self.bound_s:.0f} s past the window")
            self.kill()
            if self.on_fault is not None:
                self.on_fault()
            if not self._done.wait(GRACE_S):
                print(f"grid ranks: {self.fault}; rank 0 still waits {GRACE_S:.0f} s after the "
                      f"workers were killed, and ends\n{self.logs()}", file=sys.stderr, flush=True)
                os._exit(1)
            return

    def logs(self, tail: int = 3000) -> str:
        out = []
        for rank in sorted(self.procs):
            path = log_file(self.tmp, rank)
            text = path.read_text(errors="replace")[-tail:] if path.is_file() else ""
            out.append(f"--- rank {rank} (exit {self.procs[rank].poll()}):\n{text}")
        return "\n".join(out)

    def kill(self) -> None:
        for p in self.procs.values():
            if p.poll() is None:
                p.kill()

    def results(self, t_end: float) -> dict:
        """Each worker's result, waiting until ``t_end`` + the bound at the
        most: {rank: (meta, arrays) or None where there is none}. A worker
        that died, or had not exited by then, is in ``dead``."""
        self.guarding = False
        limit = t_end + self.bound_s
        got: dict = {}
        while len(got) < len(self.procs) and time.perf_counter() < limit:
            for rank, p in self.procs.items():
                npz, meta = result_files(self.tmp, rank)
                if rank not in got and meta.is_file():
                    with np.load(npz) as z:
                        got[rank] = (json.loads(meta.read_text()), dict(z))
                elif rank not in got and p.poll() is not None:
                    got[rank] = None
            time.sleep(0.05)
        for rank, p in self.procs.items():
            try:
                p.wait(timeout=max(0.0, limit - time.perf_counter()))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
            if p.returncode != 0:
                self.dead.add(rank)
        return {r: got.get(r) for r in self.procs}

    def stop(self) -> None:
        """End the watch and every worker that still runs."""
        self._done.set()
        self.kill()
        for p in self.procs.values():
            p.wait()
        if self.sock is not None:
            self.sock.close()


def world_digest(region, st) -> str:
    """A digest of the station table and the rasters, as every rank made them."""
    h = hashlib.blake2b(digest_size=16)
    for a in (st.lon, st.lat, st.elev, st.tdi, st.lst, st.norm, st.vario, st.anoms, region.elev,
              region.tdi, region.lst, region.landmask):
        h.update(np.ascontiguousarray(a).reshape(-1).view(np.uint8))
    return h.hexdigest()


def contexts() -> list | None:
    """The indices of the cards this process holds a CUDA context on, or None
    where torch cannot tell."""
    import torch

    has = getattr(torch._C, "_cuda_hasPrimaryContext", None)
    if has is None or not torch.cuda.is_available():
        return None
    return [i for i in range(torch.cuda.device_count()) if has(i)]


def _fault(rows, cols, tile_rows, tile_cols, owned_mask):
    """The tests' planted fault in a rank's shard: the first sampled cell of
    its tiles, its first daily value of tmin, 0.49 C (200 lattice steps) off
    where the step produces it."""
    first = np.flatnonzero(owned_mask)
    if not len(first):
        raise ValueError("the faulty rank owns no sampled cell")
    r, c = int(rows[first[0]]), int(cols[first[0]])

    def alter(engine, spec, out):
        if (engine.mosaic_t0 == 0 and spec.row0 <= r < spec.row0 + tile_rows
                and spec.col0 <= c < spec.col0 + tile_cols):
            out.buf[0, (r - spec.row0) * tile_cols + (c - spec.col0)] += 200
    return alter


class _NoTracer:
    def boundary(self) -> None:
        pass


def setup_rank(job: dict, mh, rec, tracer=None) -> dict:
    """Everything of a rank before its window (see the module docstring)."""
    import torch

    from benchlib import catalog, shard_sink, world
    from benchlib.timed_engine import timed_engine
    from topotpu_torch.core.config import InterpParams, TopoConfig
    from topotpu_torch.core.dates import get_days_metadata
    from topotpu_torch.core.grid import GridSpec
    from topotpu_torch.dist import multihost
    from topotpu_torch.dist.engine import StationSet
    from topotpu_torch.dist.multihost import MultihostContext
    from topotpu_torch.io.rasters import RasterStack

    gp = catalog.load_module("drivers", "grid_production")
    tracer = tracer or _NoTracer()
    cfg, rank, count = job["config"], mh.process_index, mh.process_count
    dev = multihost.local_mesh().devices[0]  # the rank's card, as its engines will take it
    days_np, years, months = gp.calendar(cfg["start_date"], cfg["end_date"])
    region, st = world.make(job["seed"], dev, **gp._world_args(cfg, len(days_np)))
    if dev.type == "cuda":
        torch.cuda.empty_cache()  # the world's temporaries: no deployment holds them
    digest: list = []
    hashing = threading.Thread(target=lambda: digest.append(world_digest(region, st)),
                               name="world-digest")
    hashing.start()

    R, C = region.elev.shape
    tr, tc = cfg["tile_rows"], cfg["tile_cols"]
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
                      cellsize=cfg["cellsize_deg"], tile_rows=tr, tile_cols=tc,
                      output_pack=True, mosaic_direct=True,
                      pack_temp_lo=cfg["pack_temp_lo"], pack_temp_hi=cfg["pack_temp_hi"],
                      pack_se_hi=cfg["pack_se_hi"], interp=interp)

    rng = np.random.default_rng(job["seed"])
    pick = rng.choice(R * C, int(job["cell"]["sample_cells"]), replace=False)
    rows, cols = np.unravel_index(pick, (R, C))
    Sink = shard_sink.make_sink(rows, cols, tr, tc, R, C, rank, count)
    Sink.prepare(VARS)
    deadline = [float("inf")]
    faulty = job["options"].get("fault_rank")
    alter = _fault(rows, cols, tr, tc, Sink.MINE) if faulty == rank else None
    traced = bool(job["trace"])
    Engine = timed_engine(rec, Sink, deadline, tracer, traced, alter)

    # warm-up: the rank's first tile over the span's first two chunks, into
    # a shard of its own, on the card local_mesh gives the rank
    first = int(Sink.OWNED[0])
    r0, c0 = (first // -(-C // tc)) * tr, (first % -(-C // tc)) * tc
    span = days_np[years < int(years[0]) + 2 * job["traffic"]["years_per_chunk"]]
    t1 = GridSpec(lon0=grid.lon0 + c0 * grid.cellsize, lat0=grid.lat0 - r0 * grid.cellsize,
                  cellsize=grid.cellsize, nrows=tr, ncols=tc)
    one = RasterStack(t1, region.elev[r0 : r0 + tr, c0 : c0 + tc],
                      region.tdi[r0 : r0 + tr, c0 : c0 + tc],
                      region.lst[:, r0 : r0 + tr, c0 : c0 + tc],
                      region.landmask[r0 : r0 + tr, c0 : c0 + tc])
    Warm = timed_engine(rec, shard_sink.make_sink(rows[:0], cols[:0], tr, tc, tr, tc, 0, 1),
                        [float("inf")], tracer, False)
    warm_sets = [dataclasses.replace(s, anoms=s.anoms[:, : len(span)]) for s in sets]
    root = pathlib.Path(job["tmp"])
    warm_dir = root / f"warm{rank}"
    Warm(topo, one, get_days_metadata(str(span[0]), str(span[-1])), warm_dir,
         margin_km=cfg["margin_km"], ctx=MultihostContext(),
         mosaic_paths={v: warm_dir / f"mosaic_{v}" for v in VARS}).run_production_pair(
        *VARS, *warm_sets, years_per_chunk=job["traffic"]["years_per_chunk"], progress=False)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        held = contexts()
        if held is not None and held != [dev.index]:
            raise RuntimeError(f"rank {rank} steps on {dev} and holds CUDA contexts on cards "
                               f"{held}: its work is not confined to its own card")
    hashing.join()
    rec.spans.clear()
    rec.counters.clear()
    return dict(engine=Engine, topo=topo, rasters=rasters, sets=sets, st=st, region=region,
                rows=rows, cols=cols, sink=Sink, deadline=deadline, months=months, years=years,
                days=get_days_metadata(cfg["start_date"], cfg["end_date"]), root=root, mh=mh,
                device=dev, digest=digest[0], cfg=cfg, years_per_chunk=job["traffic"][
                    "years_per_chunk"], passes=[])


def open_window(count: int, deadline: float | None = None) -> float:
    """Every rank: the barrier that opens the window, then rank 0's
    ``deadline`` (``perf_counter``, the host's monotonic clock, which every
    process of the host shares) handed to all."""
    import torch
    import torch.distributed as dist

    from topotpu_torch.dist import multihost

    multihost.barrier("window start")
    if count == 1:
        return deadline
    t = torch.tensor([0.0 if deadline is None else deadline], dtype=torch.float64)
    dist.broadcast(t, src=0)
    return float(t[0])


def run_window(s: dict, deadline: float) -> None:
    """Production passes from the span's start until the first chunk
    boundary past ``deadline`` (a pass that reaches the span's end starts
    again from its first chunk), then the barrier that closes the window."""
    from topotpu_torch.dist import multihost

    s["deadline"][0] = deadline
    while True:
        out = s["root"] / f"pass{len(s['passes'])}"
        s["sink"].PASS = len(s["passes"])
        eng = s["engine"](s["topo"], s["rasters"], s["days"], out, margin_km=s["cfg"]["margin_km"],
                          ctx=s["mh"], mosaic_paths={v: out / f"mosaic_{v}" for v in VARS})
        eng.run_production_pair(*VARS, *s["sets"], years_per_chunk=s["years_per_chunk"],
                                progress=False)
        s["passes"].append(out)
        if time.perf_counter() >= s["deadline"][0]:
            break
    multihost.barrier("window end")


def shard_result(s: dict, rec, peak: int, records) -> tuple[dict, dict]:
    """What a rank hands on: (meta, arrays). Meta: rank, pid, card, world
    digest, counters, memory peak, the chunks it finished, its shards'
    attributes, the cards it holds a context on, its program span records
    (name, t0, t1 in ``perf_counter`` ns). Arrays, a variable each: every
    finished chunk's dailies at the sampled cells and which it wrote; the
    normals and se there."""
    Sink, mh = s["sink"], s["mh"]
    years = s["years"]
    chunks, arrays = [], {}
    for j, snap in enumerate(Sink.SNAPSHOTS.get(VARS[0], [])):
        t0, nt = snap["t0"], snap["daily"].shape[0]
        chunks.append(dict(pass_=snap["pass_"], t0=int(t0), nt=int(nt),
                           name=f"chunk_{years[t0]}_{years[t0 + nt - 1]}",
                           tiles=[int(t) for t in snap["tiles"]]))
    for v in VARS:
        for j, snap in enumerate(Sink.SNAPSHOTS.get(v, [])):
            arrays[f"{v}.daily.{j}"] = snap["daily"]
            arrays[f"{v}.wrote.{j}"] = snap["wrote"]
        normal, se, ok = Sink.monthly_at_samples(v)
        arrays.update({f"{v}.normal": normal, f"{v}.se": se, f"{v}.monthly": ok})
    dev = s["device"]
    meta = dict(rank=mh.process_index, pid=os.getpid(), device=str(dev), digest=s["digest"],
                tile_pairs=int(rec.counters["tile_pairs"]),
                var_cell_days=int(rec.counters["var_cell_days"]), memory_peak_bytes=int(peak),
                chunks=chunks, attrs={v: Sink.ATTRS.get(v, []) for v in VARS},
                contexts=contexts() if dev.type == "cuda" else None,
                records=[(r.name, r.t0, r.t1) for r in records])
    return meta, arrays


def _die_with_parent() -> None:
    """Have the kernel kill this process when rank 0 exits (Linux)."""
    try:
        import ctypes

        ctypes.CDLL("libc.so.6").prctl(1, signal.SIGKILL)  # PR_SET_PDEATHSIG
    except (OSError, AttributeError):
        pass


def worker(rank: int, coordinator: str, tmp: str) -> int:
    """One worker rank, start to end (see the module docstring)."""
    _die_with_parent()
    sys.path[:0] = [str(ROOT), str(BENCH)]  # the program, then the harness
    from benchlib import runner

    runner._allocator()  # the harness process's malloc settings, before any thread starts
    job = json.loads(job_file(tmp).read_text())
    import torch

    from benchlib.record import Record
    from topotpu_torch.dist import multihost

    count = int(job["processes"])
    mh = multihost.init_multihost(coordinator, count, rank)
    rec = Record()
    s = setup_rank(job, mh, rec)
    dev = s["device"]
    if dev.type == "cuda":
        from topotpu_torch.kernels import _build

        for name in KERNELS:  # built by rank 0 before any worker joined: never twice
            if not _build.library_path(name).is_file():
                raise RuntimeError(f"{name}: rank 0's build is missing")
    prof = None
    if job["trace"]:  # started before the barrier, as rank 0's harness starts its own after it
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        prof.__enter__()  # on the rank's card, which local_mesh made current in set-up
    multihost.barrier("set-up done")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    deadline = open_window(count)
    run_window(s, deadline)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    records = []
    if prof is not None:
        from topotpu_torch.utils.profiling import recorded

        prof.__exit__(None, None, None)
        records = recorded()
    peak = int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0
    meta, arrays = shard_result(s, rec, peak, records)
    if job["options"].get("banned_rank") == rank:  # the tests' planted fault
        sys.modules.setdefault("topotpu", types.ModuleType("topotpu"))
    banned = runner.banned_modules()
    if banned:  # no result: rank 0 counts the rank under rank_faults
        raise SystemExit(f"rank {rank} loaded {', '.join(banned)}: the benchmark may load "
                         f"neither JAX nor the JAX package")
    npz, meta_path = result_files(tmp, rank)
    np.savez(npz, **arrays)
    part = meta_path.with_suffix(".part")
    part.write_text(json.dumps(meta))
    part.replace(meta_path)  # the meta last: its presence says the result is whole
    return 0


if __name__ == "__main__":
    sys.exit(worker(int(sys.argv[1]), sys.argv[2], sys.argv[3]))
