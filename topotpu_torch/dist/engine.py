"""Production tile engine: host orchestration around the device step (the
port of ``topotpu.dist.engine`` to one GPU).

Parity target: the reference's gridded-production program
``bin/mpi_interp_tair.py`` (SURVEY.md §3.1) — rank 0 queueing tiles, workers
interpolating cells, a dedicated writer rank serializing netCDF output —
plus its idempotent-restart behavior (SURVEY.md §5: a crashed run is resumed
by re-queuing tiles whose output is missing).

On one GPU the same machinery is:

* the worker pool is ONE tile step on the card (``interp.point``'s
  ``interp_tile_pair_flat`` and its single-variable forms); tiles stream
  through it, and only the main thread launches work;
* three stages, one thread each. The main thread prepares a tile's host
  inputs, stages them through a pinned host buffer (one non-blocking copy),
  launches the step, and starts the copy of its product into a pinned host
  buffer taken from a bounded pool, with a CUDA event behind it. A fetch
  thread waits on that event (the wait releases the GIL) and hands numpy
  views of the buffer on. A writer thread writes the tile (HDF5 tile files,
  or straight into the final mosaic), records the manifest and returns the
  buffer to the pool. Bounded queues keep up to PIPELINE_DEPTH tiles in
  flight a stage, and the pool holds as many buffers as the pipeline holds
  tiles, so the main thread waits for a buffer when the writer falls
  behind. Nothing in the pipeline waits for the whole device;
* restart = a JSON manifest + atomic tile files: every completed tile is
  recorded after its write; on resume, completed tiles are skipped.

The engine runs on the device it is given, or on the first CUDA device
(``core.device.cuda_device`` raises where there is none). On CPU tensors, as
the tests ask for, the step takes its kernels' plain versions and the fetch
is a ``.numpy()`` view of the product. Several GPUs (the JAX engine's device
mesh and its per-process mosaic shards) are not ported yet.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import pathlib
import threading
import time
from typing import Iterator

import numpy as np
import torch

from topotpu_torch.core import constants as _C
from topotpu_torch.core.config import TopoConfig
from topotpu_torch.core.dates import DaysMetadata, get_days_metadata
from topotpu_torch.core.device import cuda_device
from topotpu_torch.core.grid import Tiling, TileSpec
from topotpu_torch.dist.multihost import MultihostContext
from topotpu_torch.interp.convert import fixed_scales_from_config
from topotpu_torch.interp.point import (
    FlatTileResult,
    MonthLayout,
    PairTileInputs,
    TileInputs,
    VarFields,
    check_slot_of_day,
    group_days_by_month,
    interp_tile,
    interp_tile_flat,
    interp_tile_pair_flat,
    month_layout,
    ungroup_days,
)
from topotpu_torch.io.ncdf import FILL_I16, TileWriter
from topotpu_torch.io.rasters import RasterStack
from topotpu_torch.utils.status import StatusCheck

_TORCH_DTYPE = {np.dtype(np.float32): torch.float32, np.dtype(bool): torch.bool}


@dataclasses.dataclass
class StationSet:
    """Host-side station arrays for one variable (the serial DB contents)."""

    lon: np.ndarray      # (S,)
    lat: np.ndarray
    elev: np.ndarray
    tdi: np.ndarray
    lst: np.ndarray      # (S, 12)
    norm: np.ndarray     # (S, 12)
    vario: np.ndarray    # (S, 12, 3)
    valid: np.ndarray    # (S, 12) bool
    anoms: np.ndarray    # (S, ndays) calendar order, serially complete

    @property
    def n(self) -> int:
        return self.lon.shape[0]


@dataclasses.dataclass
class TileTask:
    spec: TileSpec
    inputs: TileInputs    # on the engine's device
    pool_idx: np.ndarray  # (S_pool,) indices into the full station set


class _Staging:
    """Pinned host staging of a tile's inputs. The fields are laid out in one
    pinned byte buffer and reach the device in one non-blocking copy, as
    views of one device buffer. Each layout (a chunk of another length has
    another one) has a ring of ``depth`` buffers, allocated at first use; a
    buffer is written again only after the event recorded behind its last
    copy has completed, so a later tile's prepare never overwrites inputs the
    device has not read yet."""

    ALIGN = 64  # bytes; every field starts on a multiple

    def __init__(self, device: torch.device, depth: int):
        self.device = device
        self.depth = depth
        self._rings: dict = {}  # layout -> [[pinned buffer, event or None], ...]
        self._uses: dict = {}   # layout -> uploads so far

    @property
    def nbytes(self) -> int:
        """Pinned host bytes held."""
        return sum(buf.numel() for ring in self._rings.values() for buf, _ in ring)

    def upload(self, fields: dict) -> dict:
        """{name: host array} -> {name: tensor on the device}."""
        layout = tuple((name, a.shape, a.dtype) for name, a in fields.items())
        offsets, total = [], 0
        for a in fields.values():
            offsets.append(total)
            total += -(-a.nbytes // self.ALIGN) * self.ALIGN
        ring = self._rings.setdefault(layout, [])
        n = self._uses.get(layout, 0)
        self._uses[layout] = n + 1
        if len(ring) < self.depth:
            ring.append([torch.empty(total, dtype=torch.uint8, pin_memory=True), None])
        slot = ring[n % self.depth]
        host, copied = slot
        if copied is not None:
            copied.synchronize()
        raw = host.numpy()
        for a, off in zip(fields.values(), offsets):
            raw[off : off + a.nbytes].view(a.dtype).reshape(a.shape)[...] = a
        dev = host.to(self.device, non_blocking=True)
        slot[1] = torch.cuda.Event()
        slot[1].record()
        return {
            name: dev[off : off + a.nbytes].view(_TORCH_DTYPE[a.dtype]).view(a.shape)
            for (name, a), off in zip(fields.items(), offsets)
        }


class _PinnedPool:
    """Pinned host buffers for the fetch, keyed by the product's field shapes
    and dtypes (a 366-day chunk has more rows than a 365-day one). At most
    ``cap`` buffers of a key exist, each allocated at first need (pinning host
    memory takes milliseconds); ``take`` waits while all of them are out,
    which is the pipeline's back-pressure."""

    def __init__(self, cap: int):
        self.cap = cap
        self.allocated: dict = {}  # key -> buffers made
        self._free: dict = {}      # key -> buffers not in use
        self._cond = threading.Condition()

    @property
    def nbytes(self) -> int:
        """Pinned host bytes held."""
        return sum(
            n * sum(int(np.prod(shape)) * torch.empty(0, dtype=dt).element_size()
                    for shape, dt in key)
            for key, n in self.allocated.items()
        )

    def take(self, key) -> list:
        with self._cond:
            while True:
                free = self._free.setdefault(key, [])
                if free:
                    return free.pop()
                if self.allocated.get(key, 0) < self.cap:
                    self.allocated[key] = self.allocated.get(key, 0) + 1
                    break
                self._cond.wait()
        return [torch.empty(shape, dtype=dt, pin_memory=True) for shape, dt in key]

    def give(self, key, bufs: list) -> None:
        with self._cond:
            self._free[key].append(bufs)
            self._cond.notify_all()


class _InFlight:
    """A step's product (a NamedTuple of CUDA tensors) on its way into pinned
    host buffers from ``pool``: the copies are enqueued behind the step with
    an event after them. ``wait`` blocks on the event and returns the product
    as numpy views of the buffers; ``release`` hands the buffers back, once
    the writer is done with them."""

    def __init__(self, result, pool: _PinnedPool):
        self.kind = type(result)
        self.absent = [f is None for f in result]
        fields = [f for f in result if f is not None]
        self.key = tuple((tuple(f.shape), f.dtype) for f in fields)
        self.pool = pool
        self.bufs = pool.take(self.key)
        for buf, f in zip(self.bufs, fields):
            buf.copy_(f, non_blocking=True)
        self.copied = torch.cuda.Event()
        self.copied.record()

    def wait(self):
        self.copied.synchronize()
        views = iter([buf.numpy() for buf in self.bufs])
        return self.kind(*(None if gone else next(views) for gone in self.absent))

    def release(self) -> None:
        if self.bufs is not None:
            self.pool.give(self.key, self.bufs)
            self.bufs = None


def _to_numpy(x):
    """The host side of a CPU product: tensors as numpy views, NamedTuples
    and dicts mapped, anything else as it is (a CUDA tensor raises)."""
    if isinstance(x, torch.Tensor):
        return x.numpy()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_to_numpy(v) for v in x))
    if isinstance(x, dict):
        return {k: _to_numpy(v) for k, v in x.items()}
    return x


def _release(fut) -> None:
    if isinstance(fut, _InFlight):
        fut.release()


class TileEngine:
    """Tile production on one device (see the module docstring)."""

    # the direct-mode mosaic writer class: None is io.ncdf.MosaicWriter,
    # resolved in _open_mosaic; a subclass may name another class with its
    # interface (fresh, path, write_tile, read_tile_raw, read_monthly_back,
    # finalize, close)
    MOSAIC_WRITER = None

    def __init__(
        self,
        config: TopoConfig,
        rasters: RasterStack,
        days: DaysMetadata,
        out_dir: str | pathlib.Path,
        device: torch.device | str | None = None,
        margin_km: float = 250.0,
        ctx: MultihostContext | None = None,
        mosaic_paths: dict[str, pathlib.Path] | None = None,
        k_table: dict | None = None,
    ):
        self.config = config
        self.rasters = rasters
        self.days = days
        self.layout: MonthLayout = month_layout(days)
        self.out_dir = pathlib.Path(out_dir)
        self.out_dir.mkdir(parents=True, exist_ok=True)
        self.tiling = Tiling(rasters.grid, config.tile_rows, config.tile_cols)
        self.margin_km = margin_km
        # the card unless the caller names a device; no card raises
        self.device = cuda_device() if device is None else torch.device(device)
        # station-pool cap accounting (see prepare): total in-tile stations
        # dropped by max_tile_stations across the run — nonzero means silent
        # accuracy loss at tile edges; surfaced once as a warning and
        # queryable by callers and tests
        self.pool_in_tile_dropped = 0
        self._pool_cap_warned = False
        # each process owns a strided tile subset and its own manifest file
        # (single-writer by disjointness)
        self.ctx = ctx or MultihostContext()
        self.manifest_path = self.out_dir / self.ctx.manifest_name()
        self.manifest = self._load_manifest()

        # Packed mode: the whole tile product leaves the device as ONE int16
        # buffer (FlatTileResult), one copy to the host a tile.
        self._flat = bool(config.output_pack)
        # Direct-to-mosaic mode: the writer thread places tiles straight into
        # the final mosaic on the run-global pack grid (io.ncdf.MosaicWriter
        # docstring has the full story). Requires the packed path and knowing
        # the mosaic paths.
        self.mosaic_paths = dict(mosaic_paths or {})
        self._direct = bool(
            self._flat and config.mosaic_direct and self.mosaic_paths
        )
        self._mosaic: dict = {}       # var -> open mosaic writer
        self._mosaic_fresh: set = set()  # vars whose mosaic was (re)created
        self._slot_dev = None         # device slot_of_day, uploaded once
        self._scales_dev: dict = {}   # n_vars -> device fixed pack scales
        self._mosaic_owned = True     # chunk sub-engines borrow the parent's
        self.mosaic_t0 = 0            # time offset (chunked production)
        self._full_dates = None       # parent's full calendar for chunk subs
        # two step variants: month-shared station validity (detected per run
        # from the station set; saves 11 of 12 top-k selections) or not
        self._fns = {flag: self._step_fn(config.interp, flag) for flag in (False, True)}
        self._fn = self._fns[False]
        self._pair_fns: dict | None = None  # built lazily by run_pair
        # optim-nnghs consumption (SURVEY §2.16): tile_id -> {var: (k_norm,
        # k_anom)} from the nnghs.h5 artifact (the CLI builds it from the
        # tile's dominant region). Tiles absent from the table use the
        # config k.
        self.k_table = k_table
        self._var_fns: dict = {}  # (shared, params) -> single-var tile fn
        # pinned host memory, shared with the chunk sub-engines: the input
        # staging ring and the fetch buffers, as many as the pipeline holds
        # tiles (PIPELINE_DEPTH a queue, one in each of the three threads)
        self._staging = _Staging(self.device, self.PIPELINE_DEPTH)
        self._fetch_pool = _PinnedPool(2 * self.PIPELINE_DEPTH + 3)

    # ------------------------------------------------------- step functions
    def _step_fn(self, params, shared: bool):
        """Single-variable tile step: ``fn(inputs, slot[, fixed_scales=])``
        -> FlatTileResult in packed mode, ``fn(inputs)`` -> TileResult
        otherwise."""
        if self._flat:
            return functools.partial(interp_tile_flat, params=params, shared_validity=shared)
        return functools.partial(interp_tile, params=params, shared_validity=shared)

    def _get_pair_fn(self, shared: bool, reconcile: bool = False,
                     params=None):
        """Two-variable step ``fn(pair, slot[, fixed_scales=])`` ->
        FlatTileResult, one per (validity mode, reconcile, mode, params)."""
        if self._pair_fns is None:
            self._pair_fns = {}
        key = (shared, reconcile, self._direct, params)
        if key not in self._pair_fns:
            self._pair_fns[key] = functools.partial(
                interp_tile_pair_flat, params=params or self.config.interp,
                shared_validity=shared, reconcile=reconcile,
            )
        return self._pair_fns[key]

    # -------------------------------------------- optimized-k (optim-nnghs)
    def _params_for(self, spec: TileSpec, *vars_):
        """Per-tile InterpParams override from the optim-nnghs table, or
        None for the config defaults. Neighbor selection runs once at the
        max size over the variables; each variable's solve masks its own
        trailing slots (interp/point.py k_per_var)."""
        if not self.k_table:
            return None
        ent = self.k_table.get(spec.tile_id)
        if not ent:
            return None
        base = self.config.interp
        ks, kas = [], []
        for v in vars_:
            kn, ka = ent.get(v, (base.k_neighbors, base.k_neighbors_anom))
            ks.append(int(kn))
            kas.append(int(ka))
        k_sel = max(ks + kas)
        return dataclasses.replace(
            base, k_neighbors=k_sel, k_neighbors_anom=max(kas),
            k_per_var=tuple(ks), ka_per_var=tuple(kas),
        )

    def _manifest_k(self, spec: TileSpec, var: str):
        """[k_norm, k_anom] this tile+variable actually ran with, for the
        manifest (the audit trail that the optimized k reached production),
        or None when the config default applied."""
        if not self.k_table:
            return None
        ent = self.k_table.get(spec.tile_id)
        if not ent or var not in ent:
            return None
        return [int(ent[var][0]), int(ent[var][1])]

    # ------------------------------------------------- direct-mosaic output
    def _fixed_scales(self, n_vars: int = 1) -> np.ndarray:
        """Run-global int16 pack grid (config pack bounds): (6*n_vars,) f32
        of per-plane (scale, offset) — dailies and normals on the temperature
        window, se on [0, pack_se_hi]."""
        return fixed_scales_from_config(self.config, n_vars)

    def _mosaic_path(self, var: str) -> pathlib.Path:
        """The file THIS process writes: the final mosaic single-process,
        or this process's shard (mosaic_<var>_pNNN.h5) in a run over several
        processes."""
        path = self.mosaic_paths[var]
        if self.ctx.process_count > 1:
            return path.with_name(
                f"{path.stem}_p{self.ctx.process_index:03d}{path.suffix}"
            )
        return path

    def _open_mosaic(self, var: str):
        """Open/create the direct-mode mosaic for ``var``. MAIN thread only,
        before the pipeline starts (the writer thread then has exclusive
        use); a recreated (fresh) mosaic invalidates manifest entries that
        claimed tiles the old file held."""
        if var in self._mosaic:
            return self._mosaic[var]
        writer = self.MOSAIC_WRITER
        if writer is None:
            from topotpu_torch.io.ncdf import MosaicWriter as writer

        sc = self._fixed_scales()
        dates = (
            self._full_dates if self._full_dates is not None
            else self.days.date64
        )
        w = writer(
            self._mosaic_path(var), var, self.rasters.grid, dates,
            float(sc[0]), float(sc[1]),
            self.config.tile_rows, self.config.tile_cols,
            compress=self.config.output_compress,
        )
        if w.fresh:
            self._mosaic_fresh.add(var)
            self._drop_manifest_var(var)
            n_tile_claims = sum(
                1 for k in self.manifest["tiles"] if k.startswith(var + "_")
            )
            if n_tile_claims:
                print(
                    f"[engine] NOTE: starting a fresh direct-mode mosaic for "
                    f"{var} while the manifest holds {n_tile_claims} completed "
                    f"per-tile claims; direct mode recomputes those tiles "
                    f"into the mosaic (to reuse the tile files instead, run "
                    f"the mosaic stage with mosaic_direct=false)",
                    flush=True,
                )
        self._mosaic[var] = w
        return w

    def _drop_manifest_var(self, var: str) -> None:
        """Invalidate manifest claims for ``var`` whose data lived in the
        just-recreated mosaic. Claims that point at per-tile files are NOT
        dropped — those files still exist on disk and remain valid state
        for a per-tile resume or a tile-merge mosaic pass (mode switches
        must not silently destroy the manifest-is-checkpoint contract)."""
        mosaic_name = self._mosaic_path(var).name
        stale = [
            k for k, info in self.manifest["tiles"].items()
            if k.startswith(var + "_") and info.get("file") == mosaic_name
        ]
        for k in stale:
            del self.manifest["tiles"][k]
        if stale:
            self._save_manifest()

    def _close_mosaics(self, reconciled: bool = False,
                       finalize: bool = True) -> None:
        """``finalize=False`` (error path): release the file handles without
        stamping ``complete`` — the manifest keeps the resume state."""
        if not self._mosaic_owned:
            return
        if finalize and self._mosaic:
            # each shard records ITS OWN tile count + identity
            n_land = sum(
                1 for t in self.tiling.land_tiles(self.rasters.landmask)
                if self.ctx.owns_tile(t.tile_id)
            )
            for w in self._mosaic.values():
                w.finalize(
                    n_land, reconciled=reconciled,
                    process_index=self.ctx.process_index,
                    process_count=self.ctx.process_count,
                )
        for w in self._mosaic.values():
            w.close()
        self._mosaic.clear()

    # files below this size skip writeback pacing (test-size tiles: the
    # per-file fdatasync latency would dominate, and small runs never hit
    # the dirty-page throttle that pacing exists to avoid)
    PACE_MIN_BYTES = 8 << 20

    @classmethod
    def _pace_writeback(cls, path: pathlib.Path) -> None:
        """Flush a finished tile file to disk and drop its page cache.

        At production scale the engine writes tens of GB of tiles; left to
        the kernel, dirty pages accumulate to the vm.dirty_ratio throttle
        and then EVERY write in the writer thread stalls behind bulk
        writeback. fdatasync paces the writer at the disk's true sustained
        rate — which the fetch/compute stages overlap — and FADV_DONTNEED
        keeps the page cache for work that reads, not for data nothing will
        touch until mosaic."""
        import os

        try:
            if path.stat().st_size < cls.PACE_MIN_BYTES:
                return
            fd = os.open(path, os.O_RDONLY)
        except OSError:
            return
        try:
            os.fdatasync(fd)
            os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
        except (AttributeError, OSError):
            pass
        finally:
            os.close(fd)

    # ------------------------------------------------- launch and fetch
    def _start_fetch(self, out):
        """Right after a step's launch: on CUDA, enqueue the copy of its
        product into a pinned buffer of the pool (waiting for a free one);
        on the CPU the product is already on the host."""
        if self.device.type == "cuda":
            return _InFlight(out, self._fetch_pool)
        return out

    @staticmethod
    def _fetch(fut):
        """The fetch thread's half: the product on the host, as numpy."""
        if isinstance(fut, _InFlight):
            return fut.wait()
        return _to_numpy(fut)

    def _dispatch(self, task: TileTask, fn=None):
        """Launch the device step for one tile and start its copy to the
        host, so the transfer overlaps the next tile's prepare. ``fn``
        overrides the engine-default step (per-tile optimized k)."""
        fn = fn or self._fn
        if self._flat:
            slot = self._dev_slot()
            if self._direct:
                out = fn(task.inputs, slot, fixed_scales=self._dev_scales())
            else:
                out = fn(task.inputs, slot)
        else:
            out = fn(task.inputs)
        return self._start_fetch(out)

    def _get_var_fn(self, shared: bool, params):
        """Single-variable tile step for a per-tile InterpParams override
        (optim-nnghs single-var fallback path)."""
        key = (shared, params)
        if key not in self._var_fns:
            self._var_fns[key] = self._step_fn(params, shared)
        return self._var_fns[key]

    def _dev_slot(self) -> torch.Tensor:
        """slot_of_day checked and uploaded ONCE per engine (a chunk has its
        own): the step then takes it as it is, with no host check, copy or
        wait for the device."""
        if self._slot_dev is None:
            slot = check_slot_of_day(self.layout.slot_of_day, self.layout.dpm)
            self._slot_dev = torch.as_tensor(slot, device=self.device)
        return self._slot_dev

    def _dev_scales(self, n_vars: int = 1) -> torch.Tensor:
        """Run-global fixed pack scales uploaded once per (engine, n_vars)."""
        if n_vars not in self._scales_dev:
            self._scales_dev[n_vars] = torch.as_tensor(
                self._fixed_scales(n_vars), device=self.device
            )
        return self._scales_dev[n_vars]

    # ------------------------------------------------------------- manifest
    def _load_manifest(self) -> dict:
        if self.manifest_path.exists():
            return json.loads(self.manifest_path.read_text())
        return {"tiles": {}}

    def _record_tile(self, key: str, info: dict, save: bool = True):
        """``save=False`` defers the manifest file write so a multi-entry
        update (e.g. both variables of a pair) costs one serialization; the
        entry not yet on disk merely stays pending across a crash, and the
        write is idempotent."""
        self.manifest["tiles"][key] = info
        if save:
            self._save_manifest()

    def _save_manifest(self):
        tmp = self.manifest_path.with_suffix(".tmp")
        tmp.write_text(json.dumps(self.manifest, indent=0))
        tmp.replace(self.manifest_path)

    def _tile_key(self, spec: TileSpec, var: str) -> str:
        return f"{var}_{spec.tile_id:05d}"

    def _tile_file(self, spec: TileSpec, var: str) -> pathlib.Path:
        return self.out_dir / f"{var}_tile{spec.tile_id:05d}.h5"

    def _tile_done(self, spec: TileSpec, var: str) -> bool:
        """Manifest + data-presence check. Direct mode holds data inside
        the mosaic (whose _open_mosaic freshness check already invalidated
        mosaic-backed claims if the file was lost), so a claim counts only
        if it points at THIS mosaic — a claim recorded by an earlier
        per-tile run does not put the tile's data into the mosaic.
        Per-tile mode checks the tile file on disk."""
        info = self.manifest["tiles"].get(self._tile_key(spec, var))
        if info is None:
            return False
        if self._direct:
            return info.get("file") == self._mosaic_path(var).name
        return self._tile_file(spec, var).exists()

    def pending_tiles(self, var: str) -> Iterator[TileSpec]:
        for ts in self.tiling.land_tiles(self.rasters.landmask):
            if not self.ctx.owns_tile(ts.tile_id):
                continue
            if self._tile_done(ts, var):
                continue
            yield ts

    # ------------------------------------------------------------- host prep
    def _host_inputs(self, spec: TileSpec, stations: StationSet):
        """The host work of ``prepare``: the tile's cell fields and its
        station pool (inside the tile bbox + margin, nearest-first cap), as
        float32 / bool numpy arrays by TileInputs field; and the pool."""
        cfg = self.config
        tr, tc = cfg.tile_rows, cfg.tile_cols
        elev, tdi, lst, mask = self.rasters.tile_view(
            spec.row0, spec.col0, spec.nrows, spec.ncols
        )

        def pad2(a, fill=0.0):
            out = np.full((tr, tc), fill, a.dtype)
            out[: spec.nrows, : spec.ncols] = a
            return out

        rows = np.arange(tr)[:, None].repeat(tc, 1) + spec.row0
        cols = np.arange(tc)[None, :].repeat(tr, 0) + spec.col0
        lon, lat = self.rasters.grid.cell_lonlat(rows.ravel(), cols.ravel())

        cell_mask = np.zeros((tr, tc), bool)
        cell_mask[: spec.nrows, : spec.ncols] = mask

        # station pool: inside the tile bbox + margin, nearest-first cap
        g = self.rasters.grid
        lat_c = g.lat0 - (spec.row0 + spec.nrows / 2) * g.cellsize
        lon_c = g.lon0 + (spec.col0 + spec.ncols / 2) * g.cellsize
        deg_margin_lat = self.margin_km / 111.32
        deg_margin_lon = self.margin_km / (111.32 * max(np.cos(np.deg2rad(lat_c)), 0.2))
        lat_lo = g.lat0 - (spec.row0 + spec.nrows) * g.cellsize - deg_margin_lat
        lat_hi = g.lat0 - spec.row0 * g.cellsize + deg_margin_lat
        lon_lo = g.lon0 + spec.col0 * g.cellsize - deg_margin_lon
        lon_hi = g.lon0 + (spec.col0 + spec.ncols) * g.cellsize + deg_margin_lon
        in_box = (
            (stations.lat >= lat_lo)
            & (stations.lat <= lat_hi)
            & (stations.lon >= lon_lo)
            & (stations.lon <= lon_hi)
        )
        cand = np.flatnonzero(in_box)
        cap = self.config.interp.max_tile_stations
        if len(cand) > cap:
            d2 = (stations.lon[cand] - lon_c) ** 2 + (stations.lat[cand] - lat_c) ** 2
            kept = cand[np.argsort(d2)[:cap]]
            # Accuracy guard: the cap keeps the NEAREST-TO-TILE-CENTER
            # stations, so a cap smaller than the tile's own station count
            # silently strips edge cells of their local neighborhoods.
            # Dropping an IN-TILE station is the tell (margin stations are
            # legitimately expendable in dense networks).
            lat_ilo = g.lat0 - (spec.row0 + spec.nrows) * g.cellsize
            lat_ihi = g.lat0 - spec.row0 * g.cellsize
            lon_ilo = g.lon0 + spec.col0 * g.cellsize
            lon_ihi = g.lon0 + (spec.col0 + spec.ncols) * g.cellsize
            in_tile = (
                (stations.lat >= lat_ilo) & (stations.lat <= lat_ihi)
                & (stations.lon >= lon_ilo) & (stations.lon <= lon_ihi)
            )
            n_dropped = int(in_tile[cand].sum()) - int(in_tile[kept].sum())
            if n_dropped > 0:
                self.pool_in_tile_dropped += n_dropped
                if not self._pool_cap_warned:
                    self._pool_cap_warned = True
                    print(
                        f"[engine] WARNING: tile {spec.tile_id}: station-pool "
                        f"cap max_tile_stations={cap} drops {n_dropped} "
                        f"stations located INSIDE the tile (of "
                        f"{int(in_tile[cand].sum())} in-tile, {len(cand)} "
                        "candidates) — edge cells lose their local "
                        "neighborhoods and accuracy degrades silently. Use "
                        "smaller tiles or raise interp.max_tile_stations "
                        "above the densest tile's station count.",
                        flush=True,
                    )
            cand = kept
        S = cap
        pool = np.zeros(S, np.int64)
        pool[: len(cand)] = cand
        pool_valid = np.zeros((S, 12), bool)
        pool_valid[: len(cand)] = stations.valid[cand]

        anoms_grouped = group_days_by_month(
            stations.anoms[pool].astype(np.float32), self.layout
        )  # (S, 12, dpm)

        f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
        fields = dict(
            cell_lon=f32(lon),
            cell_lat=f32(lat),
            cell_elev=f32(pad2(elev).ravel()),
            cell_tdi=f32(pad2(tdi).ravel()),
            cell_lst=f32(np.stack([pad2(lst[m]) for m in range(12)], -1).reshape(-1, 12)),
            cell_mask=cell_mask.ravel(),
            stn_lon=f32(stations.lon[pool]),
            stn_lat=f32(stations.lat[pool]),
            stn_elev=f32(stations.elev[pool]),
            stn_tdi=f32(stations.tdi[pool]),
            stn_lst=f32(stations.lst[pool]),
            stn_norm=f32(stations.norm[pool]),
            stn_vario=f32(stations.vario[pool]),
            stn_valid=pool_valid,
            stn_anoms=f32(np.moveaxis(anoms_grouped, 1, 0)),
        )
        return fields, pool

    def _upload(self, fields: dict) -> dict:
        """Host arrays -> tensors on the engine's device: on CUDA through the
        pinned staging ring, one non-blocking copy; on the CPU as they are."""
        if self.device.type == "cuda":
            return self._staging.upload(fields)
        return {n: torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                for n, a in fields.items()}

    def prepare(self, spec: TileSpec, stations: StationSet) -> TileTask:
        fields, pool = self._host_inputs(spec, stations)
        return TileTask(spec=spec, inputs=TileInputs(**self._upload(fields)),
                        pool_idx=pool)

    # ------------------------------------------------------------- writing
    def _write_tile_direct(
        self, spec: TileSpec, var: str, result, save_manifest: bool = True
    ):
        """Direct mode: place the fetched buffer's planes straight into the
        final mosaic (all tiles share the run-global int16 grid, so the
        daily slab is written raw — zero decode or requantization). Normals
        and se land as f32 (decoded from 24 small planes) to keep the mosaic
        dataset layout identical to the assembled two-step one; a chunked
        run writes them only from its first chunk (identical across chunks:
        they derive from the full-period station normals). Returns the daily
        block read back."""
        cfg = self.config
        tr, tc = cfg.tile_rows, cfg.tile_cols
        nr, nc = spec.nrows, spec.ncols
        ndays = self.days.ndays

        buf = np.asarray(result.buf)
        sc = np.asarray(result.scales)
        daily = buf[:ndays].reshape(ndays, tr, tc)[:, :nr, :nc]
        nq = buf[ndays : ndays + 12].reshape(12, tr, tc)[:, :nr, :nc]
        okm = nq != FILL_I16
        normal = se = None
        if self.mosaic_t0 == 0:
            sq = buf[ndays + 12 : ndays + 24].reshape(12, tr, tc)[:, :nr, :nc]
            normal = np.where(
                okm, nq.astype(np.float32) * float(sc[2]) + float(sc[3]),
                np.nan,
            )
            se = np.where(
                okm, sq.astype(np.float32) * float(sc[4]) + float(sc[5]),
                np.nan,
            )
        w = self._mosaic[var]  # opened by run/run_pair on the main thread
        w.write_tile(spec.row0, spec.col0, daily, normal, se,
                     t0=self.mosaic_t0)
        land = self.rasters.landmask[
            spec.row0 : spec.row0 + nr, spec.col0 : spec.col0 + nc
        ]
        # Streamed verification: read the region straight back through the
        # writer while its pages are still cached (the pacing below drops
        # them), count covered land cells and record them in the manifest,
        # so validation need not re-read the whole product. This verifies
        # the write->file->read round trip (layout/offset/day-axis bugs),
        # not physical disk integrity.
        raw_back = w.read_tile_raw(spec.row0, spec.col0, nr, nc,
                                   t0=self.mosaic_t0, nt=daily.shape[0])
        cov_cells = (raw_back != FILL_I16).all(0) & land
        covered = int(cov_cells.sum())
        verify = {"covered": covered}
        if covered < int(land.sum()):
            # Exact cross-chunk coverage: record WHICH land cells this
            # chunk covered (2 KB bitmap per 128x128 tile) so chunked
            # validation can AND bitmaps across chunks. Fully-covered tiles
            # skip the bitmap, so healthy manifests don't grow at all.
            import base64

            verify["cov_bits"] = base64.b64encode(
                np.packbits(cov_cells.reshape(-1)).tobytes()
            ).decode()
        if normal is not None:
            nb, sb = w.read_monthly_back(spec.row0, spec.col0, nr, nc)
            verify["normal"] = int((np.isfinite(nb).all(0) & land).sum())
            verify["se"] = int((np.isfinite(sb).all(0) & land).sum())
        self._pace_writeback(w.path)
        kinfo = self._manifest_k(spec, var)
        self._record_tile(
            self._tile_key(spec, var),
            {
                "file": w.path.name,
                "cells": int(land.sum()),
                "ok_cells": int(okm.all(0).sum()),
                "verify": verify,
                "ts": time.time(),
                **({"k": kinfo} if kinfo else {}),
            },
            save=save_manifest,
        )
        return raw_back

    def _write_tile_flat(
        self, spec: TileSpec, var: str, result, save_manifest: bool = True
    ):
        """Write a FlatTileResult: slice the one fetched int16 buffer straight
        into HDF5 datasets — no host decode/pack/reorder pass at all."""
        if self._direct:
            return self._write_tile_direct(spec, var, result, save_manifest)
        cfg = self.config
        tr, tc = cfg.tile_rows, cfg.tile_cols
        nr, nc = spec.nrows, spec.ncols
        ndays = self.days.ndays

        buf = np.asarray(result.buf)        # (ndays + 24, C) int16
        sc = np.asarray(result.scales)      # (6,) f32
        daily = buf[:ndays].reshape(ndays, tr, tc)[:, :nr, :nc]
        normal = buf[ndays : ndays + 12].reshape(12, tr, tc)[:, :nr, :nc]
        se = buf[ndays + 12 : ndays + 24].reshape(12, tr, tc)[:, :nr, :nc]
        okm = normal != FILL_I16  # device ok already folds in the land mask

        land = self.rasters.landmask[
            spec.row0 : spec.row0 + nr, spec.col0 : spec.col0 + nc
        ]
        sub = self.rasters.grid.subgrid(spec.row0, spec.col0, nr, nc)
        with TileWriter(
            self._tile_file(spec, var), sub, self.days.date64,
            pack=True, compress=self.config.output_compress,
        ) as w:
            w.write_daily_prepacked(
                var, daily, float(sc[0]), float(sc[1]), long_name=f"daily {var}"
            )
            w.write_monthly_prepacked(
                f"{var}_normal", normal, float(sc[2]), float(sc[3]),
                long_name="monthly normal",
            )
            w.write_monthly_prepacked(
                f"{var}_se", se, float(sc[4]), float(sc[5]),
                long_name="kriging standard error",
            )
        self._pace_writeback(self._tile_file(spec, var))
        kinfo = self._manifest_k(spec, var)
        self._record_tile(
            self._tile_key(spec, var),
            {
                "file": self._tile_file(spec, var).name,
                "cells": int(land.sum()),
                "ok_cells": int(okm.all(0).sum()),
                "ts": time.time(),
                **({"k": kinfo} if kinfo else {}),
            },
            save=save_manifest,
        )

    def _write_tile(self, spec: TileSpec, var: str, result) -> None:
        if hasattr(result, "buf"):  # FlatTileResult (packed production mode)
            return self._write_tile_flat(spec, var, result)
        cfg = self.config
        tr, tc = cfg.tile_rows, cfg.tile_cols
        nr, nc = spec.nrows, spec.ncols

        normal = np.asarray(result.normal).reshape(12, tr, tc)[:, :nr, :nc]
        se = np.asarray(result.se).reshape(12, tr, tc)[:, :nr, :nc]
        ok = np.asarray(result.ok).reshape(12, tr, tc)[:, :nr, :nc]
        daily_g = np.asarray(result.daily)  # (12, C, dpm), f32 or int16
        daily = ungroup_days(daily_g.transpose(1, 0, 2), self.layout)
        daily = daily.reshape(tr, tc, -1).transpose(2, 0, 1)[:, :nr, :nc]

        land = self.rasters.landmask[
            spec.row0 : spec.row0 + nr, spec.col0 : spec.col0 + nc
        ]
        okm = ok & land[None, :, :]
        normal = np.where(okm, normal, np.nan)
        se = np.where(okm, se, np.nan)

        sub = self.rasters.grid.subgrid(spec.row0, spec.col0, nr, nc)
        with TileWriter(
            self._tile_file(spec, var), sub, self.days.date64,
            pack=self.config.output_pack, compress=self.config.output_compress,
        ) as w:
            if daily.dtype == np.int16:  # device-packed path
                daily[:, ~okm.all(0)] = np.int16(-32768)
                w.write_daily_prepacked(
                    var, daily,
                    float(result.daily_scale), float(result.daily_offset),
                    long_name=f"daily {var}",
                )
            else:
                daily = np.where(okm.all(0)[None, :, :], daily, np.nan)
                w.write_daily(var, daily, long_name=f"daily {var}")
            w.write_monthly(f"{var}_normal", normal, long_name="monthly normal")
            w.write_monthly(f"{var}_se", se, long_name="kriging standard error")
        self._pace_writeback(self._tile_file(spec, var))
        kinfo = self._manifest_k(spec, var)
        self._record_tile(
            self._tile_key(spec, var),
            {
                "file": self._tile_file(spec, var).name,
                "cells": int(land.sum()),
                "ok_cells": int(okm.all(0).sum()),
                "ts": time.time(),
                **({"k": kinfo} if kinfo else {}),
            },
        )

    # --------------------------------------------------- pipelined run core
    PIPELINE_DEPTH = 3  # per-stage queue bound (tiles in flight per stage)

    def _pipelined(self, pending, step, write, status) -> int:
        """Three-stage tile pipeline shared by run and run_pair.

        main thread   step(spec) -> (spec, fut): host prep, the launch, and
                      the start of the product's copy to the host
        fetch thread  self._fetch(fut): waits for that copy (a CUDA event;
                      the GIL is released while it waits)
        write thread  write(spec, host_result): files + manifest; then the
                      product's pinned buffer goes back to the pool

        The stages map onto the run's three distinct resources (host CPU,
        device + its link, disk), so each tile's transfer overlaps both the
        next tile's prep/compute and the previous tile's file write. Only
        the main thread launches device work, and only the write thread
        touches files — the single-writer-per-file and single-manifest-writer
        discipline of the reference's dedicated MPI writer rank (SURVEY
        §3.1), kept as threads in one process.

        A stage failure aborts the run: upstream stops, queued work is
        discarded (those tiles stay pending in the manifest for a resume;
        their buffers go back to the pool), and the first exception
        re-raises here.

        Failure detection (config.stall_timeout_s > 0): a fetch that never
        completes (a wedged device) blocks the fetch thread forever without
        an exception, so the error path above never fires. A daemon watchdog
        tracks the last pipeline progress event (a dispatch returning, a
        fetch landing, a write completing) and calls ``_on_stall`` once
        nothing has moved for the timeout. The default action hard-exits 75
        (EX_TEMPFAIL): a blocked wait on the device cannot be cancelled, so
        a clean in-process recovery is impossible by construction — the
        manifest (saved per completed tile) plus stage-level resume make
        `relaunch the same command` the cheap, correct recovery, and a
        distinct exit code lets a wrapper loop do that unattended."""
        import queue

        q_fetch: queue.Queue = queue.Queue(maxsize=self.PIPELINE_DEPTH)
        q_write: queue.Queue = queue.Queue(maxsize=self.PIPELINE_DEPTH)
        n_done = 0
        errs: list[BaseException] = []
        progress_t = [time.monotonic()]  # single-writer-per-slot, GIL-atomic
        finished = threading.Event()

        def fetcher():
            while True:
                item = q_fetch.get()
                if item is None:
                    q_write.put(None)
                    return
                spec, fut = item
                if errs:
                    _release(fut)
                    continue  # drain so upstream put() unblocks
                try:
                    host = self._fetch(fut)
                    progress_t[0] = time.monotonic()
                    q_write.put((spec, host, fut))
                except BaseException as e:  # noqa: BLE001 — re-raised below
                    _release(fut)
                    errs.append(e)

        def writer():
            nonlocal n_done
            while True:
                item = q_write.get()
                if item is None:
                    return
                spec, host, fut = item
                try:
                    if errs:
                        continue
                    write(spec, host)
                    n_done += 1
                    progress_t[0] = time.monotonic()
                    status.tick()
                except BaseException as e:  # noqa: BLE001 — re-raised below
                    errs.append(e)
                finally:
                    _release(fut)

        stall_s = int(getattr(self.config, "stall_timeout_s", 0) or 0)

        def watchdog():
            poll = max(1.0, min(15.0, stall_s / 4.0))
            while not finished.wait(poll):
                idle = time.monotonic() - progress_t[0]
                if idle > stall_s:
                    self._on_stall(idle)
                    return

        threads = [
            threading.Thread(target=fetcher, name="tile-fetcher"),
            threading.Thread(target=writer, name="tile-writer"),
        ]
        if stall_s > 0:
            threads.append(threading.Thread(
                target=watchdog, name="tile-watchdog", daemon=True
            ))
        for t in threads:
            t.start()
        try:
            for spec in pending:
                if errs:
                    break
                q_fetch.put(step(spec))
                progress_t[0] = time.monotonic()  # dispatch
        finally:
            q_fetch.put(None)
            # join the workers FIRST: a wedged fetch thread blocks this join
            # forever, and that is exactly the window the watchdog guards —
            # only signal it once the pipeline has genuinely drained
            for t in threads:
                if t.daemon:
                    continue  # the watchdog exits via the event below
                t.join()
            finished.set()
        if errs:
            raise errs[0]
        return n_done

    def _on_stall(self, idle_s: float) -> None:
        """Watchdog action (injectable for tests): a wait on a wedged device
        cannot be cancelled, so print a loud diagnosis and exit 75
        (EX_TEMPFAIL) — the manifest keeps every completed tile and a
        relaunch of the same command resumes (stage-level skip + per-tile
        manifest skip)."""
        import os
        import sys

        print(
            f"[engine] FATAL: no tile-pipeline progress for {idle_s:.0f}s "
            f"(> stall_timeout_s={self.config.stall_timeout_s}) — a device "
            "fetch never completed (the step or the copy of its product to "
            "the host is wedged, and the blocked wait never errors). Exiting "
            "75 so a wrapper can relaunch; the manifest resume makes the "
            "relaunch cheap.",
            flush=True,
        )
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(75)

    # ------------------------------------------------------- production run
    def run_production(
        self,
        var: str,
        stations: StationSet,
        years_per_chunk: int = 4,
        progress: bool = True,
    ) -> int:
        """Config #5 production: the full multi-decade span in fixed-size year
        chunks (the device daily buffer stays ~years_per_chunk*31*12*C
        values instead of the whole 1948-2016 span). Each chunk gets its own
        engine rooted at out_dir/chunk_YYYY_YYYY with independent manifest
        resume; the mosaic step concatenates chunk time axes (direct mode:
        each chunk writes its day range of the ONE full-span mosaic at its
        time offset)."""
        n_done = 0
        if self._direct:
            self._open_mosaic(var)  # full-span file, parent's calendar
        try:
            for sub, day_sel in self._iter_chunk_engines(years_per_chunk):
                n_done += sub.run(
                    var,
                    dataclasses.replace(
                        stations, anoms=stations.anoms[:, day_sel]
                    ),
                    progress=progress,
                )
        except BaseException:
            self._close_mosaics(finalize=False)
            raise
        self._close_mosaics(reconciled=False)
        return n_done

    def _iter_chunk_engines(self, years_per_chunk: int):
        """Yield ``(sub_engine, day_sel)`` per fixed-size year chunk — the
        scaffolding shared by run_production and run_production_pair. The
        chunk's calendar is clamped to the configured span so a start/end
        date not aligned to year boundaries keeps the sliced anomaly axis
        and the chunk calendar the same length. The parent's single-var
        steps and its pinned host pools are shared with each sub (buffers
        are keyed by shape, so chunks of another length add their own)."""
        years = self.days.years
        for c0 in range(0, len(years), years_per_chunk):
            span = years[c0 : c0 + years_per_chunk]
            d0 = max(np.datetime64(f"{span[0]}-01-01"), self.days.date64[0])
            d1 = min(np.datetime64(f"{span[-1]}-12-31"), self.days.date64[-1])
            sub_days = get_days_metadata(str(d0), str(d1))
            day_sel = (
                (self.days.year >= span[0]) & (self.days.year <= span[-1])
            )
            sub = self._chunk_engine(span, sub_days, day_sel)
            sub._fns = self._fns
            sub._var_fns = self._var_fns  # shared dict
            sub._staging = self._staging
            sub._fetch_pool = self._fetch_pool
            yield sub, day_sel

    def _chunk_engine(self, span, sub_days, day_sel) -> "TileEngine":
        """A per-chunk sub-engine (of this engine's class) rooted at its own
        manifest dir. Direct mode: the chunk borrows the parent's open
        full-span mosaics and writes at its day offset; a parent-side fresh
        rebuild invalidates the chunk's manifest claims too."""
        sub = type(self)(
            self.config,
            self.rasters,
            sub_days,
            self.out_dir / f"chunk_{span[0]}_{span[-1]}",
            device=self.device,
            margin_km=self.margin_km,
            ctx=self.ctx,
            mosaic_paths=self.mosaic_paths,
            k_table=self.k_table,
        )
        if self._direct:
            sub._mosaic = self._mosaic
            sub._mosaic_owned = False
            sub._full_dates = self.days.date64
            sub.mosaic_t0 = int(np.flatnonzero(day_sel)[0])
            for v in self._mosaic_fresh:
                sub._drop_manifest_var(v)
        return sub

    # ----------------------------------------------------------- paired run
    @staticmethod
    def _pairable(a: StationSet, b: StationSet) -> bool:
        """The paired step shares neighborhoods across variables, which is
        only sound when both variables see the same station geometry and
        per-month validity (true for the standard pipeline: one network,
        serially-complete after infill)."""
        return (
            a.n == b.n
            and np.array_equal(a.lon, b.lon)
            and np.array_equal(a.lat, b.lat)
            and np.array_equal(a.elev, b.elev)
            and np.array_equal(a.valid, b.valid)
        )

    def prepare_pair(self, spec: TileSpec, a: StationSet, b: StationSet):
        """Host prep for the two-variable step: var A's full TileInputs plus
        var B's station fields gathered over the SAME pool, staged to the
        device together."""
        fields, pool = self._host_inputs(spec, a)
        anoms_b = group_days_by_month(
            b.anoms[pool].astype(np.float32), self.layout
        )
        fields.update(
            b_norm=np.asarray(b.norm[pool], np.float32),
            b_vario=np.asarray(b.vario[pool], np.float32),
            b_anoms=np.moveaxis(anoms_b, 1, 0),
        )
        dev = self._upload(fields)
        bf = VarFields(norm=dev.pop("b_norm"), vario=dev.pop("b_vario"),
                       anoms=dev.pop("b_anoms"))
        task = TileTask(spec=spec, inputs=TileInputs(**dev), pool_idx=pool)
        return task, PairTileInputs(geom=task.inputs, b=bf)

    def _write_tile_pair(
        self, spec: TileSpec, var_a: str, var_b: str, result
    ) -> None:
        """Split the one fetched two-variable buffer and write both."""
        n_rows = self.days.ndays + 24
        buf = np.asarray(result.buf)    # one fetch for both variables
        sc = np.asarray(result.scales)
        will_verify = self._direct and (var_a, var_b) == (_C.TMIN, _C.TMAX)
        raw_a = self._write_tile_flat(
            spec, var_a, FlatTileResult(buf=buf[:n_rows], scales=sc[:6]),
            save_manifest=False,  # one manifest serialization per pair
        )
        raw_b = self._write_tile_flat(
            spec, var_b, FlatTileResult(buf=buf[n_rows:], scales=sc[6:]),
            save_manifest=not will_verify,
        )
        if will_verify and raw_a is not None and raw_b is not None:
            # streamed cross-variable re-check on the READBACK (shared
            # run-global lattice: raw compare, b >= a - 1, valid only in
            # (tmin, tmax) call order); recorded per pair so validation
            # needs no second pass over the product
            both = (raw_a != FILL_I16) & (raw_b != FILL_I16)
            viol = int((both & (
                raw_b.astype(np.int32) < raw_a.astype(np.int32) - 1
            )).sum())
            pairs = int(both.sum())
            for v in (var_a, var_b):
                info = self.manifest["tiles"].get(self._tile_key(spec, v))
                if info is not None:
                    info.setdefault("verify", {}).update(
                        viol=viol, pairs=pairs
                    )
            self._save_manifest()

    def run_pair(
        self,
        var_a: str,
        var_b: str,
        stations_a: StationSet,
        stations_b: StationSet,
        progress: bool = True,
    ) -> dict:
        """Interpolate BOTH variables per tile in one device pass.

        The reference runs a full gridded pass per variable
        (bin/mpi_interp_tair.py once for tmin, once for tmax); here the
        second variable shares the tile's neighborhoods, GWR gains, daily
        contraction, host prep and the single fetch, paying only its kriging
        solve. Falls back to two sequential runs when the station sets
        differ or packed output is disabled. Returns per-variable tile
        counts {var_a: n, var_b: n} (they can differ on the fallback path
        when one variable resumes further along than the other)."""
        if not (self._flat and self._pairable(stations_a, stations_b)):
            return {
                var_a: self.run(var_a, stations_a, progress),
                var_b: self.run(var_b, stations_b, progress),
            }
        shared = bool(
            np.all(stations_a.valid == stations_a.valid[:, :1])
        )
        # Direct mode reconciles daily tmin<=tmax ON DEVICE: with the
        # run-global shared pack grid both variables quantize the collapsed
        # midpoint to the same int16 lattice point, so the mosaic stage's
        # whole reconcile pass vanishes. The device step enforces
        # var_b >= var_a, so gate it on the actual (tmin, tmax) call order —
        # any other pairing leaves the mosaics marked unreconciled and the
        # mosaic stage's direct branch applies the host reconcile instead.
        reconcile = self._direct and (var_a, var_b) == (_C.TMIN, _C.TMAX)
        fn = self._get_pair_fn(shared, reconcile=reconcile)
        if self._direct:
            for v in (var_a, var_b):
                self._open_mosaic(v)
        slot = self._dev_slot()
        pending = [
            ts
            for ts in self.tiling.land_tiles(self.rasters.landmask)
            if self.ctx.owns_tile(ts.tile_id)
            and not all(self._tile_done(ts, v) for v in (var_a, var_b))
        ]
        status = StatusCheck(
            total=len(pending), unit="tiles", enabled=progress,
            items_per=2 * self.config.tile_rows * self.config.tile_cols,
        )
        fixed = self._dev_scales(2) if self._direct else None

        def step(spec):
            task, pair = self.prepare_pair(spec, stations_a, stations_b)
            p_spec = self._params_for(spec, var_a, var_b)
            fn_spec = fn if p_spec is None else self._get_pair_fn(
                shared, reconcile=reconcile, params=p_spec
            )
            if fixed is not None:
                out = fn_spec(pair, slot, fixed_scales=fixed)
            else:
                out = fn_spec(pair, slot)
            return task.spec, self._start_fetch(out)

        try:
            n_done = self._pipelined(
                pending, step,
                lambda spec, host: self._write_tile_pair(
                    spec, var_a, var_b, host
                ),
                status,
            )
        except BaseException:
            self._close_mosaics(finalize=False)
            raise
        self._close_mosaics(reconciled=reconcile)
        return {var_a: n_done, var_b: n_done}

    def run_production_pair(
        self,
        var_a: str,
        var_b: str,
        stations_a: StationSet,
        stations_b: StationSet,
        years_per_chunk: int = 4,
        progress: bool = True,
    ) -> dict:
        """Chunked multi-decade production for both variables at once; same
        chunking/resume semantics as run_production. Returns per-variable
        tile counts summed over chunks."""
        n_done = {var_a: 0, var_b: 0}
        if self._direct:
            for v in (var_a, var_b):
                self._open_mosaic(v)
        try:
            for sub, day_sel in self._iter_chunk_engines(years_per_chunk):
                if self._pair_fns is not None:
                    sub._pair_fns = self._pair_fns
                chunk_done = sub.run_pair(
                    var_a,
                    var_b,
                    dataclasses.replace(
                        stations_a, anoms=stations_a.anoms[:, day_sel]
                    ),
                    dataclasses.replace(
                        stations_b, anoms=stations_b.anoms[:, day_sel]
                    ),
                    progress=progress,
                )
                for v, c in chunk_done.items():
                    n_done[v] += c
                if sub._pair_fns is not None:
                    self._pair_fns = sub._pair_fns
        except BaseException:
            self._close_mosaics(finalize=False)
            raise
        # each chunk's run_pair reconciled its day range on device — unless
        # the sets aren't pairable (every chunk then fell back to two single
        # runs; anoms slicing never changes geometry/validity, so checking
        # the full sets here decides it for all chunks) or the call order
        # isn't (tmin, tmax); the mosaic stage's direct branch
        # host-reconciles unreconciled pairs
        self._close_mosaics(
            reconciled=self._pairable(stations_a, stations_b)
            and (var_a, var_b) == (_C.TMIN, _C.TMAX)
        )
        return n_done

    # ------------------------------------------------------------- main loop
    def run(self, var: str, stations: StationSet, progress: bool = True) -> int:
        """Interpolate all pending tiles for one variable. Returns #tiles."""
        shared = bool(np.all(stations.valid == stations.valid[:, :1]))
        self._fn = self._fns[shared]
        if self._direct:
            self._open_mosaic(var)  # main thread, before the writer starts
        pending = list(self.pending_tiles(var))
        status = StatusCheck(
            total=len(pending), unit="tiles", enabled=progress,
            items_per=self.config.tile_rows * self.config.tile_cols,
        )

        def step(spec):
            task = self.prepare(spec, stations)
            p_spec = self._params_for(spec, var)
            fn_spec = None if p_spec is None else self._get_var_fn(
                shared, p_spec
            )
            return task.spec, self._dispatch(task, fn=fn_spec)

        try:
            n_done = self._pipelined(
                pending, step,
                lambda spec, host: self._write_tile(spec, var, host),
                status,
            )
        except BaseException:
            self._close_mosaics(finalize=False)
            raise
        # single-variable runs carry no cross-variable reconcile; the mosaic
        # stage's direct branch applies the host reconcile pass when both
        # variables' mosaics exist unreconciled
        self._close_mosaics(reconciled=False)
        return n_done
