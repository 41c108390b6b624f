"""netCDF4-compatible HDF5 tile and mosaic files (the port's own copy of the
JAX package's ``io/ncdf.py``; no libnetcdf needed).

Parity target: the reference's tiled netCDF output (SURVEY.md §2.15 — tile
assembly + CF-metadata writer inside ``bin/mpi_interp_tair.py``). The
netCDF-4 format IS HDF5 plus dimension scales and a few attributes, so this
module writes files that netCDF readers (and any HDF5 reader) open directly:

* one dataset per variable with attached dimension scales (time/lat/lon),
* CF attributes (units, standard_name, _FillValue, grid bounds),
* optional int16 packing (scale_factor/add_offset) — the convention climate
  archives use; halves output bandwidth.

Tile writes are atomic: <name>.tmp then os.replace, so a crashed run never
leaves a half-written tile and the manifest can trust file presence
(SURVEY.md §5 idempotent-restart contract).

A run over several processes writes one full-grid mosaic shard a process;
``build_virtual_mosaic`` publishes them as one master file whose datasets
map each tile to its shard (an HDF5 virtual dataset, no data copied).

``h5py`` is imported inside the functions that open files, so that importing
the module needs none.
"""

from __future__ import annotations

import os
import pathlib

import numpy as np

from topotpu_torch.core.grid import GridSpec

FILL_I16 = np.int16(-32768)
FILL_F32 = np.float32(9.96921e36)  # CF default float fill


def _attach_dims(f, var, dims: tuple[str, ...]):
    for i, d in enumerate(dims):
        var.dims[i].attach_scale(f[d])


def _pack_int16(data: np.ndarray, valid_mask: np.ndarray | None):
    finite = np.isfinite(data)
    if valid_mask is not None:
        finite &= valid_mask
    if finite.any():
        lo = float(data[finite].min())
        hi = float(data[finite].max())
    else:
        lo, hi = 0.0, 1.0
    span = max(hi - lo, 1e-6)
    scale = span / 65500.0
    offset = (hi + lo) / 2.0
    safe = np.where(finite, data, offset)  # avoid NaN->int cast warnings
    packed = np.where(
        finite, np.round((safe - offset) / scale).astype(np.int16), FILL_I16
    )
    return packed, scale, offset


def _write_coords(f, grid: GridSpec, dates: np.ndarray):
    """CF dimension scales + file attrs shared by tile and mosaic writers."""
    lat = grid.lat0 - np.arange(grid.nrows) * grid.cellsize
    lon = grid.lon0 + np.arange(grid.ncols) * grid.cellsize
    epoch = np.datetime64("1948-01-01", "D")
    time = (dates - epoch).astype(np.int32)

    for name, data, units, std in (
        ("lat", lat.astype(np.float64), "degrees_north", "latitude"),
        ("lon", lon.astype(np.float64), "degrees_east", "longitude"),
        ("time", time, "days since 1948-01-01 00:00:00", "time"),
        ("mth", np.arange(1, 13, dtype=np.int32), "month of year", "month"),
    ):
        d = f.create_dataset(name, data=data)
        d.make_scale(name)
        d.attrs["units"] = units
        d.attrs["standard_name"] = std
    f.attrs["Conventions"] = "CF-1.6"
    f.attrs["source"] = "topotpu"
    f.attrs["cellsize"] = grid.cellsize


class TileWriter:
    """Write one tile's interpolation products as a netCDF4-style HDF5 file."""

    def __init__(
        self,
        path: str | pathlib.Path,
        subgrid: GridSpec,
        dates: np.ndarray,  # datetime64[D] calendar day axis
        pack: bool = True,
        compress: int = 1,  # gzip level; 0 = none (host gzip is slow)
    ):
        import h5py

        self.path = pathlib.Path(path)
        self.tmp = self.path.with_suffix(self.path.suffix + ".tmp")
        self.subgrid = subgrid
        self.dates = dates
        self.pack = pack
        self.compress = compress
        self._f = h5py.File(self.tmp, "w")
        self._init_coords()

    def _copts(self):
        # fletcher32: per-chunk checksums verified by HDF5 on EVERY read —
        # on-disk bit rot raises at consumption time instead of decoding to
        # silently wrong temperatures (KNOWN_GAPS #7: the sampled validate
        # cannot visit every tile; this makes the unsampled ones fail loudly
        # the moment anything reads them). Cost is a ~1 MB/chunk checksum
        # pass.
        if self.compress:
            return dict(compression="gzip", compression_opts=self.compress,
                        shuffle=True, fletcher32=True)
        return dict(fletcher32=True)

    def _init_coords(self):
        _write_coords(self._f, self.subgrid, self.dates)

    def write_daily(self, name: str, data: np.ndarray, units="C", long_name=""):
        """data: (ndays, nrows, ncols) float; NaN = masked."""
        f = self._f
        if self.pack:
            packed, scale, offset = _pack_int16(data, None)
            v = f.create_dataset(
                name, data=packed, chunks=(min(64, data.shape[0]),) + data.shape[1:],
                **self._copts(),
            )
            v.attrs["scale_factor"] = np.float32(scale)
            v.attrs["add_offset"] = np.float32(offset)
            v.attrs["_FillValue"] = FILL_I16
        else:
            v = f.create_dataset(
                name, data=np.where(np.isfinite(data), data, FILL_F32),
                chunks=(min(64, data.shape[0]),) + data.shape[1:],
                **self._copts(),
            )
            v.attrs["_FillValue"] = FILL_F32
        v.attrs["units"] = units
        v.attrs["long_name"] = long_name or name
        _attach_dims(f, v, ("time", "lat", "lon"))
        return v

    def write_daily_prepacked(self, name: str, data_i16: np.ndarray,
                              scale: float, offset: float,
                              units="C", long_name=""):
        """data already int16-quantized (device-side packing): (ndays, r, c)
        with FILL_I16 sentinel; scale/offset are the global decode params."""
        f = self._f
        v = f.create_dataset(
            name, data=data_i16,
            chunks=(min(64, data_i16.shape[0]),) + data_i16.shape[1:],
            **self._copts(),
        )
        v.attrs["scale_factor"] = np.float32(scale)
        v.attrs["add_offset"] = np.float32(offset)
        v.attrs["_FillValue"] = FILL_I16
        v.attrs["units"] = units
        v.attrs["long_name"] = long_name or name
        _attach_dims(f, v, ("time", "lat", "lon"))
        return v

    def write_monthly_prepacked(self, name: str, data_i16: np.ndarray,
                                scale: float, offset: float,
                                units="C", long_name=""):
        """(12, nrows, ncols) already int16-quantized (device-side packing)
        with FILL_I16 sentinel; scale/offset are the global decode params."""
        f = self._f
        v = f.create_dataset(name, data=data_i16, **self._copts())
        v.attrs["scale_factor"] = np.float32(scale)
        v.attrs["add_offset"] = np.float32(offset)
        v.attrs["_FillValue"] = FILL_I16
        v.attrs["units"] = units
        v.attrs["long_name"] = long_name or name
        _attach_dims(f, v, ("mth", "lat", "lon"))
        return v

    def write_monthly(self, name: str, data: np.ndarray, units="C", long_name=""):
        """data: (12, nrows, ncols) float; NaN = masked."""
        f = self._f
        v = f.create_dataset(
            name, data=np.where(np.isfinite(data), data, FILL_F32).astype(np.float32),
            fletcher32=True,
        )
        v.attrs["_FillValue"] = FILL_F32
        v.attrs["units"] = units
        v.attrs["long_name"] = long_name or name
        _attach_dims(f, v, ("mth", "lat", "lon"))
        return v

    def close(self):
        self._f.close()
        os.replace(self.tmp, self.path)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            self.close()
        else:  # leave no half-written artifact behind
            self._f.close()
            self.tmp.unlink(missing_ok=True)


class MosaicWriter:
    """Incremental full-grid mosaic written tile-by-tile (direct-to-mosaic
    production mode).

    The two-step path (per-tile files assembled by the mosaic stage) reads
    and rewrites the entire product once more after interpolation, plus a
    host requantization pass. With every tile packed on one run-global
    int16 grid (``interp_tile_pair_flat``'s ``fixed_scales``), the
    engine's writer thread can instead place each fetched tile buffer
    straight into the final mosaic datasets, and the mosaic stage reduces
    to attribute finalization.

    Trade-off vs per-tile files: a mosaic being written is not atomic (no
    tmp+rename at this size); the engine's manifest is the completeness
    record — exactly as it already is for tiles — and tile-region writes
    are idempotent, so a crashed run resumes by rewriting pending tiles in
    place. ``layout="direct"`` + per-variable ``complete`` attrs mark the
    finalized state for downstream stages.

    Single-writer discipline: ONE process (the engine's writer thread) may
    hold a mosaic open.
    """

    def __init__(
        self,
        path: str | pathlib.Path,
        var: str,
        grid: GridSpec,
        dates: np.ndarray,
        daily_scale: float,
        daily_offset: float,
        tile_rows: int,
        tile_cols: int,
        compress: int = 0,
    ):
        import h5py

        self.path = pathlib.Path(path)
        self.var = var
        ndays = len(dates)
        R, Cc = grid.nrows, grid.ncols
        # fresh=True means no prior tile data survived — the engine must
        # then ignore manifest entries for this variable (they would claim
        # tiles the recreated file no longer holds)
        self.fresh = True
        if self.path.exists():
            try:
                f = h5py.File(self.path, "r+")
            except OSError:  # half-written/corrupt file from a crash
                self.path.unlink()
            else:
                ok = (
                    var in f
                    and f[var].shape == (ndays, R, Cc)
                    and "normal" in f
                    # a changed pack grid (config edit between runs) makes
                    # old int16 data undecodable on the new grid — rebuild
                    # (attrs are stored f32; compare at f32 resolution)
                    and float(f[var].attrs.get("scale_factor", 0.0))
                    == float(np.float32(daily_scale))
                    and float(f[var].attrs.get("add_offset", np.nan))
                    == float(np.float32(daily_offset))
                )
                if ok:  # resume: keep already-written tiles
                    # A prior finalize may have stamped complete/reconciled;
                    # this run is about to rewrite tiles in place (forced
                    # recompute after a manifest clear), so the file must
                    # stop claiming completeness until finalize re-stamps it
                    # — otherwise a crash mid-rewrite leaves a half-updated
                    # mosaic that readers accept as whole.
                    for stale in ("complete", "reconciled"):
                        f.attrs.pop(stale, None)
                    self._f = f
                    self.fresh = False
                    return
                f.close()
                self.path.unlink()
        self._f = h5py.File(self.path, "w")
        f = self._f
        _write_coords(f, grid, dates)
        # fletcher32 chunk checksums: any read of a bit-rotted chunk raises
        # (see TileWriter._copts). Writes recompute checksums, so in-place
        # tile rewrites (resume / forced recompute) stay valid; a resumed
        # pre-checksum mosaic keeps its original (unchecked) layout.
        copts = dict(fletcher32=True)
        if compress:
            copts.update(compression="gzip", compression_opts=compress)
        for name, ln in (("normal", "monthly normal"),
                         ("se", "kriging standard error")):
            d = f.create_dataset(
                name, (12, R, Cc), np.float32, fillvalue=np.nan,
                chunks=(12, min(tile_rows, R), min(tile_cols, Cc)), **copts,
            )
            d.attrs["units"] = "C"
            d.attrs["long_name"] = ln
            _attach_dims(f, d, ("mth", "lat", "lon"))
        d = f.create_dataset(
            var, (ndays, R, Cc), np.int16, fillvalue=FILL_I16,
            chunks=(min(32, ndays), min(tile_rows, R), min(tile_cols, Cc)),
            **copts,
        )
        d.attrs["scale_factor"] = np.float32(daily_scale)
        d.attrs["add_offset"] = np.float32(daily_offset)
        d.attrs["_FillValue"] = FILL_I16
        d.attrs["units"] = "C"
        d.attrs["long_name"] = f"daily {var}"
        _attach_dims(f, d, ("time", "lat", "lon"))
        f.attrs["layout"] = "direct"

    def write_tile(
        self,
        row0: int,
        col0: int,
        daily_i16: np.ndarray,      # (nt, nr, nc) on the run-global grid
        normal: np.ndarray | None,  # (12, nr, nc) f32, NaN-masked
        se: np.ndarray | None,
        t0: int = 0,                # time offset (chunked production)
    ) -> None:
        f = self._f
        nt, nr, nc = daily_i16.shape
        sl = (slice(row0, row0 + nr), slice(col0, col0 + nc))
        f[self.var][(slice(t0, t0 + nt),) + sl] = daily_i16
        if normal is not None:
            f["normal"][(slice(None),) + sl] = normal
            f["se"][(slice(None),) + sl] = se
        # flush library buffers so the engine's writeback pacing
        # (fdatasync on a separate fd) sees this tile's pages
        f.flush()

    def read_tile_raw(self, row0: int, col0: int, nr: int, nc: int,
                      t0: int = 0, nt: int | None = None) -> np.ndarray:
        """Read a tile's raw daily block back through the dataset (the
        engine's streamed write-verification; pages are still cached when
        it runs, so this is memory-speed)."""
        d = self._f[self.var]
        if nt is None:
            nt = d.shape[0] - t0
        return d[t0 : t0 + nt, row0 : row0 + nr, col0 : col0 + nc]

    def read_monthly_back(self, row0: int, col0: int, nr: int, nc: int):
        """(normal, se) region readback for streamed verification."""
        sl = (slice(None), slice(row0, row0 + nr), slice(col0, col0 + nc))
        return self._f["normal"][sl], self._f["se"][sl]

    def finalize(self, n_tiles: int, reconciled: bool,
                 process_index: int = 0, process_count: int = 1) -> None:
        """``process_count > 1`` marks this file as one process's SHARD
        of a run over several processes (it holds only the tiles with
        tile_id % process_count == process_index)."""
        self._f.attrs["n_tiles"] = n_tiles
        self._f.attrs["complete"] = True
        self._f.attrs["reconciled"] = bool(reconciled)
        self._f.attrs["process_index"] = process_index
        self._f.attrs["process_count"] = process_count

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def build_virtual_mosaic(
    dst: str | pathlib.Path,
    var: str,
    shard_paths: list,          # per-process shard files, index = process id
    grid: GridSpec,
    dates: np.ndarray,
    land_tiles: list,           # TileSpecs of every land tile in the grid
) -> dict:
    """Assemble the direct-mode shards of a run over several processes into
    ONE published mosaic as an HDF5 virtual dataset (VDS): metadata only, no
    tile data is copied.

    Each shard holds the full-grid-shaped datasets but only its owned tiles
    (tile_id % P == process_index) were ever written; the master maps each
    land tile's region to its owning shard. HDF5 resolves the relative
    source file names against the master's directory, so the whole data_dir
    stays relocatable. Readers are unchanged: a VDS reads like any dataset
    (unmapped ocean regions return the declared fillvalue). A virtual
    dataset cannot carry filters itself, but every read resolves to the
    source shards' chunks, whose fletcher32 checksums ARE verified: bit rot
    in a shard raises through the master too.

    All shards must be finalized (``complete``); raises otherwise. Returns
    {"n_tiles": total, "reconciled": all-shards-reconciled}.
    """
    import h5py

    dst = pathlib.Path(dst)
    P = len(shard_paths)
    n_tiles = 0
    reconciled = True
    meta = []
    for i, sp in enumerate(shard_paths):
        with h5py.File(sp, "r") as f:
            if not f.attrs.get("complete", False):
                raise RuntimeError(
                    f"direct-mode shard {sp.name} is not finalized — rerun "
                    "the interp stage on that host (its manifest resumes)"
                )
            if int(f.attrs.get("process_index", 0)) != i or int(
                f.attrs.get("process_count", 1)
            ) != P:
                raise RuntimeError(
                    f"shard {sp.name}: identity attrs "
                    f"(p{f.attrs.get('process_index')}/"
                    f"{f.attrs.get('process_count')}) do not match its slot "
                    f"(p{i}/{P}) — mixed runs in one data dir?"
                )
            n_tiles += int(f.attrs.get("n_tiles", 0))
            reconciled &= bool(f.attrs.get("reconciled", False))
            d = f[var]
            meta.append({
                "shape": d.shape,
                "dtype": d.dtype,
                "attrs": {k: d.attrs[k] for k in
                          ("scale_factor", "add_offset", "_FillValue",
                           "units", "long_name") if k in d.attrs},
            })
            if meta[0]["shape"] != meta[-1]["shape"] or (
                meta[0]["attrs"].get("scale_factor")
                != meta[-1]["attrs"].get("scale_factor")
            ):
                raise RuntimeError(
                    f"shard {sp.name}: shape/pack grid differs from shard 0 "
                    "— shards are not from one run"
                )
    shape = meta[0]["shape"]
    R, Cc = grid.nrows, grid.ncols

    tmp = dst.with_suffix(dst.suffix + ".tmp")
    with h5py.File(tmp, "w") as f:
        _write_coords(f, grid, dates)
        specs = [
            (var, shape, meta[0]["dtype"],
             FILL_I16 if meta[0]["dtype"] == np.int16 else np.nan,
             ("time", "lat", "lon")),
            ("normal", (12, R, Cc), np.float32, np.nan, ("mth", "lat", "lon")),
            ("se", (12, R, Cc), np.float32, np.nan, ("mth", "lat", "lon")),
        ]
        for name, shp, dt, fill, dims in specs:
            layout = h5py.VirtualLayout(shape=shp, dtype=dt)
            sources = [
                h5py.VirtualSource(sp.name, name, shape=shp)
                for sp in shard_paths
            ]
            for ts in land_tiles:
                sl = (slice(None),
                      slice(ts.row0, ts.row0 + ts.nrows),
                      slice(ts.col0, ts.col0 + ts.ncols))
                layout[sl] = sources[ts.tile_id % P][sl]
            v = f.create_virtual_dataset(name, layout, fillvalue=fill)
            src_attrs = meta[0]["attrs"] if name == var else {}
            for k, val in src_attrs.items():
                v.attrs[k] = val
            _attach_dims(f, v, dims)
        f.attrs["layout"] = "direct"
        f.attrs["virtual"] = True
        f.attrs["n_tiles"] = n_tiles
        f.attrs["n_shards"] = P
        f.attrs["complete"] = True
        f.attrs["reconciled"] = bool(reconciled)
    os.replace(tmp, dst)
    return {"n_tiles": n_tiles, "reconciled": bool(reconciled)}


def decode_array(data: np.ndarray, dset) -> np.ndarray:
    """Unpack raw values already read from ``dset`` (int16-packed or f32),
    applying scale/offset + fill semantics — for readers that keep the raw
    block around (e.g. to re-encode in place)."""
    if data.dtype == np.int16:
        scale = float(dset.attrs.get("scale_factor", 1.0))
        offset = float(dset.attrs.get("add_offset", 0.0))
        out = data.astype(np.float32) * scale + offset
        out[data == FILL_I16] = np.nan
        return out
    out = data.astype(np.float32)
    out[data == FILL_F32] = np.nan
    return out


def read_slice(dset, sl=Ellipsis) -> np.ndarray:
    """Decode a slice of an OPEN h5py dataset (int16-packed or f32),
    applying unpack + fill semantics — for streaming readers that must not
    load the whole variable (validate / cross-variable reconcile)."""
    return decode_array(dset[sl], dset)


def read_var(path, name: str) -> np.ndarray:
    """Read a variable back, applying unpack + fill semantics."""
    import h5py

    with h5py.File(path, "r") as f:
        return read_slice(f[name])
