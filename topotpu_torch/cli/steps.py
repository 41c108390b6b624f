"""Pipeline stage implementations (the port of ``topotpu.cli.steps``).

Parity target: the reference's numbered ``bin/step*.py`` scripts +
``mpi_*.py`` programs (SURVEY.md §2.18) — one function per stage, each
reading one artifact and atomically writing the next (the artifact chain IS
the checkpoint/resume story, SURVEY §5):

  synth-data | download+build-db -> all_obs.h5
  qa          -> qa flags inside all_obs.h5
  homog       -> homog.h5
  infill      -> serial_{tmin,tmax}.h5
  krig-params -> variogram attrs inside serial DBs
  interp      -> tiles/<var>_tileNNNNN.h5 (+manifest)
  mosaic      -> mosaic_<var>.h5

The artifacts keep the JAX package's groups, datasets, attributes and
dtypes, so a data_dir written by either package's CLI is read, resumed and
finished by the other's. Each stage that reaches the device takes it as
``device``. The computation of each such stage (infill, krig-params,
optim-nnghs, interp, point, validate-f64) sits in a private function on
arrays between the reads and the writes of its artifacts, so that a caller
without ``h5py`` can chain the stages on arrays. ``h5py`` is imported only
inside the functions that open files.
"""

from __future__ import annotations

import contextlib
import json
import os
import pathlib

import numpy as np

from topotpu_torch.core import constants as C
from topotpu_torch.core.config import TopoConfig
from topotpu_torch.core.dates import get_days_metadata
from topotpu_torch.io.rasters import RasterStack
from topotpu_torch.io.stndb import StationDB, write_serial_db

# station attributes of a serial DB that the interp-side stages read
_SERIAL_ATTRS = (C.LON, C.LAT, C.ELEV, C.TDI, C.LST, C.NORM, C.BAD,
                 C.VARIO_NUG, C.VARIO_PSILL, C.VARIO_RNG)


def _bit_rot_error(e: OSError) -> RuntimeError:
    return RuntimeError(
        "validate: HDF5 read of the mosaic failed mid-scan "
        f"({e}) — a fletcher32 chunk-checksum mismatch means the bytes "
        "on disk no longer match what the writer verified (bit rot or "
        "an external overwrite); rerun interp for the affected tiles "
        "(manifest resume rewrites them in place)"
    )


@contextlib.contextmanager
def _raise_bit_rot():
    """Translate an HDF5 read failure into the actionable verdict it means.

    Product datasets are written with per-chunk fletcher32 checksums
    (io/ncdf.py), so the dominant cause of an OSError while reading a
    mosaic that opened fine is a checksum mismatch = on-disk bit rot.
    """
    try:
        yield
    except OSError as e:
        raise _bit_rot_error(e) from e


def _paths(cfg: TopoConfig) -> dict[str, pathlib.Path]:
    d = pathlib.Path(cfg.data_dir)
    return {
        "root": d,
        "rasters": d / "rasters.h5",
        "all_obs": d / "all_obs.h5",
        "homog": d / "homog.h5",
        "serial_tmin": d / "serial_tmin.h5",
        "serial_tmax": d / "serial_tmax.h5",
        "tiles": d / "tiles",
        "mosaic_tmin": d / "mosaic_tmin.h5",
        "mosaic_tmax": d / "mosaic_tmax.h5",
    }


def _days(cfg: TopoConfig):
    return get_days_metadata(cfg.start_date, cfg.end_date)


def stage_resume_status(cfg: TopoConfig, nrows: int, ncols: int,
                        n_stations: int, seed: int) -> dict[str, bool]:
    """Which `all`-pipeline stages already have their output artifact on
    disk. The artifact chain IS the checkpoint (SURVEY §5 failure/restart):
    every stage writes one atomic artifact, so presence == completion —
    except the two stages that mutate a file in place, which carry explicit
    completion marks (qa: ``qa_complete`` root attr on all_obs.h5;
    krig-params: the VARIO_* station attrs it adds to the serial DBs).

    synth-data is special: skipping it is only sound when the world on
    disk is the world being requested, so it records an identity sidecar
    (synth_meta.json) and a MISMATCH raises — silently regenerating would
    orphan every downstream artifact, and silently keeping the old world
    would not be what the user asked for. ``--redo`` bypasses everything.

    The caller (cli.main, `all` stage) applies these with a cascade: a
    stage may only skip while every upstream stage also skipped, because a
    re-run stage rewrites its artifact and invalidates what follows.
    """
    import h5py

    p = _paths(cfg)
    st: dict[str, bool] = {}

    meta_path = p["root"] / "synth_meta.json"
    synth_ok = (p["rasters"].exists() and p["all_obs"].exists()
                and meta_path.exists())
    if synth_ok:
        meta = json.loads(meta_path.read_text())
        want = {"nrows": int(nrows), "ncols": int(ncols),
                "n_stations": int(n_stations), "seed": int(seed)}
        have = {k: meta.get(k) for k in want}
        if have != want:
            raise ValueError(
                f"data_dir {p['root']} holds a different synthetic world "
                f"({have}) than requested ({want}); pass --redo to "
                "regenerate everything, or use a fresh --data-dir"
            )
    st["synth-data"] = synth_ok

    def _h5_mark(path, attr):
        if not path.exists():
            return False
        try:
            with h5py.File(path, "r") as f:
                return bool(f.attrs.get(attr, 0))
        except OSError:
            return False  # unreadable/corrupt -> re-run the stage

    def _has_vario(path):
        if not path.exists():
            return False
        try:
            with h5py.File(path, "r") as f:
                return C.VARIO_NUG in f["stn"]
        except OSError:
            return False

    st["qa"] = _h5_mark(p["all_obs"], "qa_complete")
    st["homog"] = p["homog"].exists()
    st["infill"] = all(
        p[f"serial_{v}"].exists() for v in (C.TMIN, C.TMAX)
    )
    st["krig-params"] = all(
        _has_vario(p[f"serial_{v}"]) for v in (C.TMIN, C.TMAX)
    )
    st["optim-nnghs"] = (p["root"] / "nnghs.h5").exists()
    # interp self-resumes from per-chunk tile manifests (completed tiles
    # skip inside the engine); mosaic finalization and validate are cheap
    # and are the point of re-running — never skipped here.
    return st


# ------------------------------------------------------------ stage: data


def _synth_world(days, nrows, ncols, n_stations, missing_frac, seed, ocean_frac):
    """The synthetic world and its station observations, drawn from
    ``seed`` in the JAX package's order: (world, station attrs, tmin, tmax)."""
    from topotpu_torch.io.synthetic import make_world

    rng = np.random.default_rng(seed)
    world = make_world(rng, nrows=nrows, ncols=ncols, n_stations=n_stations,
                       ndays=days.ndays, ocean_frac=ocean_frac)
    S = world.n_stations
    tmin = (
        world.stn_norm[np.arange(S)[:, None], days.month_idx[None, :]]
        + world.stn_anoms
    ).astype(np.float32)
    tmax = tmin + 10.0 + 1.5 * rng.standard_normal(tmin.shape).astype(np.float32)
    for arr in (tmin, tmax):
        arr[rng.uniform(size=arr.shape) < missing_frac] = np.nan
    attrs = {
        C.STN_ID: np.array([f"SYNTH{i:05d}" for i in range(S)]),
        C.LON: world.stn_lon,
        C.LAT: world.stn_lat,
        C.ELEV: world.stn_elev,
        C.TDI: world.stn_tdi,
        C.LST: world.stn_lst.astype(np.float32),
    }
    return world, attrs, tmin, tmax


def step_synth_data(cfg: TopoConfig, nrows=96, ncols=96, n_stations=250,
                    missing_frac=0.15, seed=0, ocean_frac=0.1) -> None:
    """Generate the synthetic world (no-network substitute for
    download+build-db, SURVEY §7 step 1). Writes rasters.h5 + all_obs.h5."""
    p = _paths(cfg)
    p["root"].mkdir(parents=True, exist_ok=True)
    days = _days(cfg)
    world, attrs, tmin, tmax = _synth_world(
        days, nrows, ncols, n_stations, missing_frac, seed, ocean_frac
    )
    RasterStack.from_world(world).save(p["rasters"])

    tmp = p["all_obs"].with_suffix(".h5.tmp")
    with StationDB.create(tmp, attrs, days.date64) as db:
        db.set_obs(C.TMIN, tmin)
        db.set_obs(C.TMAX, tmax)
    os.replace(tmp, p["all_obs"])  # artifact rule: tmp+rename
    # resume identity sidecar: `all` skips this stage on re-run only when
    # the requested world matches what is on disk (stage_resume_status)
    meta = {"nrows": int(nrows), "ncols": int(ncols),
            "n_stations": int(n_stations), "seed": int(seed),
            "ocean_frac": float(ocean_frac),
            "missing_frac": float(missing_frac)}
    mtmp = p["root"] / "synth_meta.json.tmp"
    mtmp.write_text(json.dumps(meta))
    os.replace(mtmp, p["root"] / "synth_meta.json")


def step_download(cfg: TopoConfig, opener=None) -> None:
    """Fetch GHCN-D inventory + station files (gated: needs a network
    opener; see io.download)."""
    from topotpu_torch.io import download as dl

    p = _paths(cfg)
    raw = p["root"] / "raw"
    dl.fetch(dl.GHCND_STATIONS, raw / "ghcnd-stations.txt", opener)
    dl.fetch(dl.GHCND_ALL_TAR, raw / "ghcnd_all.tar.gz", opener)


def step_build_db(cfg: TopoConfig) -> dict:
    """Parse raw GHCN-D (+delimited SNOTEL/RAWS) files -> all_obs.h5.
    GHCN input is accepted both as loose ``raw/*.dly`` files and as the
    archive NCEI actually distributes (``raw/ghcnd_all.tar[.gz]``,
    streamed member-by-member)."""
    from topotpu_torch.io.build_db import InsertGhcn, InsertSnotel, InsertRaws, \
        build_station_db, iter_ghcnd_tar, parse_ghcnd_stations

    p = _paths(cfg)
    raw = p["root"] / "raw"
    days = _days(cfg)
    inv_file = raw / "ghcnd-stations.txt"
    inv = parse_ghcnd_stations(inv_file.read_text()) if inv_file.exists() else {}
    ghcn = InsertGhcn(inv)

    reports: dict[str, dict] = {}

    def _stream():
        # one generator end-to-end: build_station_db screens and densifies
        # each station as it arrives, so the 120k-member archive never
        # materializes as a list of observation dicts
        for f in sorted(raw.glob("ghcnd_all.tar*")):
            reports[f.name] = {}
            yield from iter_ghcnd_tar(f, inv, report=reports[f.name])
        for f in sorted(raw.glob("*.dly")):
            yield ghcn.parse_dly(f.read_text())
        for parser, pat in ((InsertSnotel(), "snotel_*.csv"),
                            (InsertRaws(), "raws_*.csv")):
            for f in sorted(raw.glob(pat)):
                yield parser.parse(f.read_text(), f.stem)

    build_station_db(p["all_obs"], _stream(), days).close()
    # archive reconciliation (SURVEY §2.1-2.2): parsed counts vs the
    # inventory — a station listed in ghcnd-stations.txt but absent from
    # the archive is actionable (partial mirror, wrong archive vintage)
    out: dict = {}
    for name, r in reports.items():
        miss = r.pop("missing_from_archive", [])
        out[name] = {**r, "n_missing_from_archive": len(miss)}
        if miss:
            out[name]["missing_sample"] = miss[:20]
            print(
                f"[build-db] WARNING: {name}: {len(miss)} inventory "
                f"stations never appeared in the archive (first: "
                f"{', '.join(miss[:5])}) — partial mirror or mismatched "
                "inventory vintage",
                flush=True,
            )
    return out


# -------------------------------------------------------------- stage: qa


def _qa_core(tmin, tmax, lon, lat, days, spatial: bool = True, rasters=None,
             elev=None, stn_id=None):
    """The QA flags of both variables (the non-spatial checks, then the
    spatial) and the stage report: (tmin flags, tmax flags, report). With
    ``rasters`` the report adds the location check against the DEM."""
    from topotpu_torch.qa import check_coordinates, run_qa_non_spatial, run_qa_spatial

    ft, fx = run_qa_non_spatial(tmin, tmax, days)
    if spatial:
        ft = run_qa_spatial(tmin, ft, lon, lat, days)
        fx = run_qa_spatial(tmax, fx, lon, lat, days)
    out: dict = {}
    # location QA: DEM-witnessed coordinate sanity (SURVEY §2.6's geonames
    # role, offline) — reported only; repairs are an operator decision,
    # exactly as the reference's location QA was
    if rasters is not None:
        loc = check_coordinates(rasters, lon, lat, elev)
        out["coord_suspects"] = int(loc["suspect"].sum())
        out["coord_fixes"] = {
            str(stn_id[i]): {
                "probe": str(loc["probe"][i]),
                "lon": float(loc["fix_lon"][i]),
                "lat": float(loc["fix_lat"][i]),
            }
            for i in np.flatnonzero(loc["probe"] != None)  # noqa: E711
        }
    out.update(
        flag_rate_tmin=float((ft != C.QA_OK).mean()),
        flag_rate_tmax=float((fx != C.QA_OK).mean()),
    )
    return ft, fx, out


def step_qa(cfg: TopoConfig, spatial: bool = True) -> dict:
    p = _paths(cfg)
    days = _days(cfg)
    rasters = RasterStack.load(p["rasters"]) if p["rasters"].exists() else None
    with StationDB(p["all_obs"], "a") as db:
        ft, fx, out = _qa_core(
            db.obs(C.TMIN), db.obs(C.TMAX), db.stn(C.LON), db.stn(C.LAT), days,
            spatial, rasters, db.stn(C.ELEV), db.stn(C.STN_ID),
        )
        db.set_qflags(C.TMIN, ft)
        db.set_qflags(C.TMAX, fx)
        # completion mark for stage-level resume: qa mutates all_obs.h5 in
        # place (no separate artifact), so presence of the file alone can't
        # prove the stage ran; a re-generated all_obs.h5 clears the mark
        db._f.attrs["qa_complete"] = np.uint8(1)
    return out


# ----------------------------------------------------------- stage: homog


def _homog_core(obs_by_var, flags_by_var, days, lon, lat, history, device):
    """Joint homogenisation of the QA'd series: values whose flag is not
    QA_OK drop out (a variable without flags keeps all). Returns
    ({var: HomogResult}, {var: number of breaks})."""
    from topotpu_torch.homog import homogenize_elements

    masked = {
        var: obs if flags_by_var.get(var) is None
        else np.where(flags_by_var[var] == C.QA_OK, obs, np.nan)
        for var, obs in obs_by_var.items()
    }
    # tmin/tmax breaks corroborate each other (multi-element confirmation),
    # detection + adjustment per element
    results = homogenize_elements(
        masked, days.year, days.month, lon, lat,
        station_history=history, device=device,
    )
    n_breaks = {var: sum(len(b) for b in res.breakpoints)
                for var, res in results.items()}
    return results, n_breaks


def step_homog(cfg: TopoConfig, station_history_path: str | None = None, *,
               device) -> dict:
    """``station_history_path``: optional documented-change metadata file
    ('STN_ID YYYY-MM' lines — homog.parse_station_history), the role of
    PHA v52i's station-history input: detection/confirmation relax near
    documented dates (Menne-Williams metadata windows)."""
    from topotpu_torch.homog import parse_station_history

    p = _paths(cfg)
    days = _days(cfg)
    with StationDB(p["all_obs"]) as db:
        lon, lat = db.stn(C.LON), db.stn(C.LAT)
        attrs = {k: db.stn(k) for k in db._f["stn"].keys()}
        history = None
        if station_history_path:
            history = parse_station_history(
                pathlib.Path(station_history_path).read_text(),
                db.stn(C.STN_ID),
            )
        obs_by_var, flags_by_var = {}, {}
        for var in (C.TMIN, C.TMAX):
            obs_by_var[var] = db.obs(var)
            try:
                flags_by_var[var] = db.qflags(var)
            except KeyError:
                flags_by_var[var] = None
        results, n_breaks = _homog_core(obs_by_var, flags_by_var, days, lon,
                                        lat, history, device)
        # artifact written atomically (tmp+rename) AFTER the long compute:
        # a kill mid-stage must not leave a half-written homog.h5 that
        # step_infill's exists() check then prefers over all_obs.h5
        tmp = p["homog"].with_suffix(".h5.tmp")
        with StationDB.create(tmp, attrs, days.date64) as out:
            for var, res in results.items():
                out.set_obs(var, res.adjusted_daily)
        os.replace(tmp, p["homog"])
    return n_breaks


# ---------------------------------------------------------- stage: infill


def _infill_core(obs, days, ppca, lon, lat, device):
    """PPCA serial completion of one variable and its post-infill flags:
    (InfillResult, bad stations, report)."""
    from topotpu_torch.infill import infill_network
    from topotpu_torch.infill.post_infill import changepoint_flags

    res = infill_network(obs, days.month_idx, ppca, stn_lon=lon, stn_lat=lat,
                         device=device)
    cp_bad = changepoint_flags(res.filled, res.obs_mask, days.year, days.month)
    bad = res.bad | cp_bad
    return res, bad, {
        "bad": int(bad.sum()),
        "bad_changepoint": int(cp_bad.sum()),
        "imputed_frac": float((~res.obs_mask).mean()),
    }


def step_infill(cfg: TopoConfig, *, device) -> dict:
    p = _paths(cfg)
    days = _days(cfg)
    src_path = p["homog"] if p["homog"].exists() else p["all_obs"]
    stats = {}
    with StationDB(src_path) as db:
        lon, lat = db.stn(C.LON), db.stn(C.LAT)
        for var in (C.TMIN, C.TMAX):
            res, bad, stats[var] = _infill_core(db.obs(var), days, cfg.ppca,
                                                lon, lat, device)
            write_serial_db(
                p[f"serial_{var}"], db, var, res.filled, res.norms, bad
            )
    return stats


# ----------------------------------------------------- stage: krig params


def _krig_params_core(stn: dict, cfg: TopoConfig, device):
    """Per-station monthly variograms from a serial DB's attributes, failed
    fits filled: ((S, 12, 3) float32 nugget/psill/range, report)."""
    from topotpu_torch.interp.params import (
        build_krig_params, fill_failed_fits, krig_params_to_numpy)

    bad = stn[C.BAD].astype(bool)
    valid = np.repeat(~bad[:, None], 12, axis=1)
    res = krig_params_to_numpy(build_krig_params(
        stn[C.LON], stn[C.LAT], stn[C.ELEV], stn[C.TDI], stn[C.LST],
        stn[C.NORM], valid, cfg.variogram, cfg.interp, device,
    ))
    vario = fill_failed_fits(res.vario, res.ok)
    return vario, {"ok_frac": float(res.ok.mean())}


def step_krig_params(cfg: TopoConfig, *, device) -> dict:
    p = _paths(cfg)
    out = {}
    for var in (C.TMIN, C.TMAX):
        with StationDB(p[f"serial_{var}"], "a") as db:
            stn = {k: db.stn(k) for k in
                   (C.LON, C.LAT, C.ELEV, C.TDI, C.LST, C.NORM, C.BAD)}
            vario, out[var] = _krig_params_core(stn, cfg, device)
            db.set_stn(C.VARIO_NUG, vario[..., 0])
            db.set_stn(C.VARIO_PSILL, vario[..., 1])
            db.set_stn(C.VARIO_RNG, vario[..., 2])
    return out


# ---------------------------------------------------------- stage: interp


def _read_serial(path, names=_SERIAL_ATTRS):
    """({attribute: array}, the DB's one filled series) of a serial DB."""
    with StationDB(path) as db:
        stn = {k: db.stn(k) for k in names}
        filled = None
        for var in (C.TMIN, C.TMAX):
            try:
                filled = db.obs(var)
                break
            except KeyError:
                continue
    return stn, filled


def _station_set_core(stn: dict, filled, days):
    """The engine's StationSet from a serial DB's attributes and series."""
    from topotpu_torch.dist.engine import StationSet

    bad = stn[C.BAD].astype(bool)
    vario = np.stack([stn[C.VARIO_NUG], stn[C.VARIO_PSILL], stn[C.VARIO_RNG]],
                     axis=-1)
    norms = stn[C.NORM]
    anoms = filled - norms[:, days.month_idx]
    return StationSet(
        lon=stn[C.LON], lat=stn[C.LAT], elev=stn[C.ELEV], tdi=stn[C.TDI],
        lst=stn[C.LST], norm=norms, vario=vario,
        valid=np.repeat(~bad[:, None], 12, axis=1),
        anoms=anoms.astype(np.float32),
    )


def _station_set(path, days):
    return _station_set_core(*_read_serial(path), days)


def _nnghs_table_core(reg, ids, ks: dict, rasters, cfg: TopoConfig) -> dict:
    """tile_id -> {var: (k_norm, k_anom)} from a region grid, its region ids
    and each variable's per-region (k_norm, k_anom) arrays."""
    from topotpu_torch.core.grid import Tiling

    if reg.shape != rasters.grid.shape:
        raise ValueError(
            f"nnghs artifact region grid {reg.shape} != run grid "
            f"{rasters.grid.shape} — rerun optim-nnghs on this world"
        )
    id_pos = {int(r): i for i, r in enumerate(ids)}
    lo = int(cfg.interp.min_neighbors)
    hi = int(cfg.interp.max_tile_stations)
    tiling = Tiling(rasters.grid, cfg.tile_rows, cfg.tile_cols)
    table: dict = {}
    for ts in tiling.land_tiles(rasters.landmask):
        sl = (
            slice(ts.row0, ts.row0 + ts.nrows),
            slice(ts.col0, ts.col0 + ts.ncols),
        )
        r_tile = reg[sl][rasters.landmask[sl]]
        if r_tile.size == 0:
            continue
        vals, counts = np.unique(r_tile, return_counts=True)
        i = id_pos.get(int(vals[counts.argmax()]))
        if i is None:
            continue
        ent = {
            var: (int(np.clip(kn[i], lo, hi)), int(np.clip(ka[i], lo, hi)))
            for var, (kn, ka) in ks.items()
        }
        if ent:
            table[ts.tile_id] = ent
    return table


def _nnghs_tile_table(nnghs_path, rasters, cfg: TopoConfig) -> dict:
    """tile_id -> {var: (k_norm, k_anom)} from the optim-nnghs artifact:
    each land tile runs at its DOMINANT region's optimized sizes (mode over
    the tile's land cells — the per-tile analogue of the reference applying
    its per-climate-division nnghs tables, SURVEY §2.16 -> §2.10). Distinct
    k combinations are bounded by the number of regions."""
    import h5py

    with h5py.File(nnghs_path) as f:
        reg = f["regions"][...]
        ids = f["region_ids"][...]
        ks = {}
        for var in (C.TMIN, C.TMAX):
            if f"k_norm_{var}" in f:
                ks[var] = (
                    f[f"k_norm_{var}"][...], f[f"k_anom_{var}"][...]
                )
    return _nnghs_table_core(reg, ids, ks, rasters, cfg)


def _interp_core(eng, sets: dict, chunk_years: int, ktab, nnghs_src) -> dict:
    """Both variables through ``eng`` (a TileEngine), and the stage report."""
    # Both variables per tile in ONE device pass when the station sets share
    # geometry/validity (the standard pipeline); run_pair falls back to two
    # sequential passes otherwise. Returns per-variable tile counts.
    if chunk_years:
        res = eng.run_production_pair(
            C.TMIN, C.TMAX, sets[C.TMIN], sets[C.TMAX], chunk_years
        )
    else:
        res = eng.run_pair(C.TMIN, C.TMAX, sets[C.TMIN], sets[C.TMAX])
    if ktab is not None:
        combos = sorted(
            {tuple(sorted((v, k) for v, k in ent.items()))
             for ent in ktab.values()}
        )
        res = {
            **res,
            "nnghs": {
                "source": nnghs_src,
                "tiles_with_optimized_k": len(ktab),
                "distinct_k_combos": [
                    {v: list(k) for v, k in combo} for combo in combos
                ],
            },
        }
    return res


def step_interp(cfg: TopoConfig, chunk_years: int = 0, ctx=None,
                nnghs_path: str | None = None, use_nnghs: bool = True, *,
                device=None) -> dict:
    """chunk_years > 0 switches to the config-#5 chunked production run
    (mandatory for multi-decade spans: the device daily buffer scales with
    the chunk length, not the full 1948-2016 span). ``ctx`` is this
    process's MultihostContext (``dist.multihost.init_multihost``): in a job
    over several processes each interpolates its strided tile set into its
    own manifest and, in direct mode, its own mosaic shard. ``device``: one
    device to step on; None steps over this process's mesh
    (``dist.multihost.local_mesh``, ``config.mesh.n_devices`` of its
    devices).

    ``nnghs_path``/``use_nnghs``: the optim-nnghs artifact (see
    step_optim_nnghs). When present (explicit path, or data_dir/nnghs.h5
    automatically), every tile runs at its dominant region's optimized
    per-variable neighborhood sizes and the manifest records them;
    ``use_nnghs=False`` forces the config k."""
    from topotpu_torch.dist.engine import TileEngine

    p = _paths(cfg)
    days = _days(cfg)
    rasters = RasterStack.load(p["rasters"])
    ktab = None
    nnghs_src = None
    if use_nnghs:
        npth = (
            pathlib.Path(nnghs_path) if nnghs_path else p["root"] / "nnghs.h5"
        )
        if npth.exists():
            ktab = _nnghs_tile_table(npth, rasters, cfg)
            nnghs_src = str(npth)
        elif nnghs_path:
            raise FileNotFoundError(f"--nnghs artifact not found: {npth}")
    # direct-to-mosaic (cfg.mosaic_direct, packed runs): the engine writes
    # finished tiles straight into these final mosaic files (one shard a
    # process in a job over several) and the mosaic stage reduces to a
    # finalization check (a virtual master over the shards)
    eng = TileEngine(
        cfg, rasters, days, p["tiles"], device=device, ctx=ctx,
        mosaic_paths={v: p[f"mosaic_{v}"] for v in (C.TMIN, C.TMAX)},
        k_table=ktab,
    )
    sets = {v: _station_set(p[f"serial_{v}"], days) for v in (C.TMIN, C.TMAX)}
    return _interp_core(eng, sets, chunk_years, ktab, nnghs_src)


# ----------------------------------------------------------- stage: point


def _point_sites(rasters, lonlat):
    """Covariates of the sites at their enclosing cells: (lon, lat, elev,
    tdi, lst (N, 12), off_land). A site outside the grid raises."""
    lon = np.asarray([x for x, _ in lonlat], np.float64)
    lat = np.asarray([y for _, y in lonlat], np.float64)
    g = rasters.grid
    R, Cc = g.shape
    # rowcol() CLIPS to the grid, so bounds must be checked on the raw
    # (unclipped) indices — otherwise a site thousands of km away silently
    # interpolates at a border cell instead of erroring
    raw_r = np.round((g.lat0 - lat) / g.cellsize).astype(int)
    raw_c = np.round((lon - g.lon0) / g.cellsize).astype(int)
    outside = (raw_r < 0) | (raw_r >= R) | (raw_c < 0) | (raw_c >= Cc)
    if outside.any():
        bad_i = int(np.flatnonzero(outside)[0])
        raise ValueError(
            f"point ({lon[bad_i]}, {lat[bad_i]}) outside the run's grid"
        )
    rows, cols = g.rowcol(lon, lat)
    return (lon, lat, rasters.elev[rows, cols], rasters.tdi[rows, cols],
            rasters.lst[:, rows, cols].T, ~rasters.landmask[rows, cols])


def _point_core(sites, stations, days, params, device):
    """One variable at the sites: (normal (12, N), se (12, N), ok (12, N),
    daily (N, ndays)), NaN where not ok."""
    from topotpu_torch.interp.point import interp_points, ungroup_days

    lon, lat, elev, tdi, lst, off_land = sites
    res, layout = interp_points(lon, lat, elev, tdi, lst, stations, days,
                                device, params)
    normal = res.normal.cpu().numpy()
    se = res.se.cpu().numpy()
    ok = res.ok.cpu().numpy() & ~off_land[None, :]
    daily = ungroup_days(res.daily.cpu().numpy().transpose(1, 0, 2), layout)
    return (np.where(ok, normal, np.nan), np.where(ok, se, np.nan), ok,
            np.where(ok.all(0)[:, None], daily, np.nan))


def step_point(cfg: TopoConfig, lonlat, out_dir: str | None = None, *,
               device) -> dict:
    """Ad-hoc point interpolation — the reference's ``PtInterpTair`` usage
    (SURVEY §2.14: interpolate daily tmin/tmax + uncertainty to arbitrary
    lon/lat sites, e.g. a station location or a study plot) without running
    the gridded production.

    ``lonlat``: sequence of (lon, lat). Covariates are sampled from the
    run's raster stack at the enclosing cell (the reference sampled its
    rasters the same way). Writes, per variable, ``point_<var>_daily.csv``
    (date x site calendar series) and ``point_<var>_normals.csv``
    (12 normals + 12 standard errors per site) into ``out_dir`` (default
    data_dir); returns the normals in the stage report."""
    import csv

    p = _paths(cfg)
    days = _days(cfg)
    sites = _point_sites(RasterStack.load(p["rasters"]), lonlat)
    lon, lat = sites[:2]
    N = len(lon)
    out_root = pathlib.Path(out_dir) if out_dir else p["root"]
    out_root.mkdir(parents=True, exist_ok=True)
    report: dict = {}
    for var in (C.TMIN, C.TMAX):
        path = p[f"serial_{var}"]
        if not path.exists():
            report[var] = {"status": "missing serial DB"}
            continue
        normal, se, ok, daily = _point_core(
            sites, _station_set(path, days), days, cfg.interp, device
        )
        with open(out_root / f"point_{var}_normals.csv", "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["lon", "lat"]
                       + [f"norm_{m:02d}" for m in range(1, 13)]
                       + [f"se_{m:02d}" for m in range(1, 13)])
            for i in range(N):
                w.writerow([lon[i], lat[i]] + [round(float(x), 3) for x in
                           np.concatenate([normal[:, i], se[:, i]])])
        with open(out_root / f"point_{var}_daily.csv", "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["date"] + [f"site{i}" for i in range(N)])
            for t in range(days.ndays):
                w.writerow([str(days.date64[t])]
                           + [round(float(v), 2) for v in daily[:, t]])
        report[var] = {
            "sites": N,
            "ok_sites": int(ok.all(0).sum()),
            "annual_normal": [round(float(np.nanmean(normal[:, i])), 2)
                              for i in range(N)],
        }
    return report


# ------------------------------------------------------- stage: aggregate


def _month_bounds(dates):
    """(years, month starts, month ends, unique years) of a contiguous
    ascending calendar."""
    years = dates.astype("datetime64[Y]").astype(int) + 1970
    months = dates.astype("datetime64[M]").astype(int) % 12
    ym = years * 12 + months
    starts = np.flatnonzero(np.diff(ym, prepend=ym[0] - 1))
    ends = np.append(starts[1:], len(dates))
    return years, starts, ends, np.unique(years)


def _aggregate_core(d, dates):
    """Monthly and annual means of a daily mosaic ``d`` (an HDF5 dataset or
    an array: int16 on a pack lattice, or float32), one calendar month read
    at a time. Yields ("monthly", i, plane) and ("annual", i, plane) in the
    daily dataset's encoding; a mean is finite only where every member day
    is."""
    from topotpu_torch.io.ncdf import FILL_F32, FILL_I16

    _, R, Cc = d.shape
    years, starts, ends, _ = _month_bounds(dates)
    packed = d.dtype == np.int16

    def encode(mean, fin):
        if packed:
            enc = np.rint(mean).astype(np.int16)
            enc[~fin] = FILL_I16
        else:
            enc = mean.astype(np.float32)
            enc[~fin] = FILL_F32
        return enc

    y_sum = np.zeros((R, Cc), np.float64)
    y_fin = np.ones((R, Cc), bool)
    y_days = 0
    y_row = 0
    cur_year = years[starts[0]]
    for mi, (i0, i1) in enumerate(zip(starts, ends)):
        if years[i0] != cur_year:
            yield "annual", y_row, encode(y_sum / y_days, y_fin)
            y_row += 1
            y_sum[:] = 0.0
            y_fin[:] = True
            y_days = 0
            cur_year = years[i0]
        raw = d[i0:i1]
        # reductions use a wide ACCUMULATOR dtype, never a month-sized
        # widened copy — the raw block (~1.2 GB at the 4096^2 scale) must
        # stay the peak allocation
        if packed:
            fin = (raw != FILL_I16).all(axis=0)
            s = raw.sum(axis=0, dtype=np.int64)
        else:
            fin = np.isfinite(raw).all(axis=0) & (raw != FILL_F32).all(axis=0)
            np.putmask(raw, ~np.isfinite(raw) | (raw == FILL_F32), 0.0)
            s = raw.sum(axis=0, dtype=np.float64)
        yield "monthly", mi, encode(s / (i1 - i0), fin)
        y_sum += s
        y_fin &= fin
        y_days += i1 - i0
    if y_days:
        yield "annual", y_row, encode(y_sum / y_days, y_fin)


def step_aggregate(cfg: TopoConfig) -> dict:
    """Monthly- and annual-mean mosaics from the daily product — the
    aggregates the reference's distributed dataset shipped alongside the
    dailies. Streams ONE calendar month at a time (validate-grade memory
    bounds at the 4096^2 scale), so int16-packed mosaics aggregate in raw
    integer space: a mean of raw values decodes through the same affine
    map, no float decode of the 10+ GB daily axis. A month/year mean is
    finite only where EVERY member day is finite (matching validate's
    coverage strictness). Writes ``agg_<var>.h5`` per variable with
    ``monthly`` (n_months, R, C) and ``annual`` (n_years, R, C) datasets
    on the daily dataset's pack grid, atomically (tmp+rename). CF lat/lon
    dimension scales are copied from the source mosaic, and ``n_days`` /
    ``n_days_year`` record each mean's member-day count (a partial
    leading/trailing month under an unaligned config span is otherwise
    indistinguishable from a full-month mean)."""
    import h5py

    from topotpu_torch.io.ncdf import FILL_F32, FILL_I16, _attach_dims

    p = _paths(cfg)
    out: dict = {}
    for var in (C.TMIN, C.TMAX):
        src = p[f"mosaic_{var}"]
        if not src.exists():
            out[var] = {"status": "missing"}
            continue
        with h5py.File(src) as f:
            # Direct-mode mosaics are written in place (the ONE exception to
            # tmp+rename); readers must not treat the file as whole until
            # 'complete' is stamped. Aggregating a partial mosaic would
            # silently emit hole-filled means and report success — refuse
            # instead (as step_mosaic does).
            if f.attrs.get("layout") == "direct" and not f.attrs.get(
                "complete", False
            ):
                out[var] = {"status": "incomplete"}
                continue
            d = f[var]
            ndays, R, Cc = d.shape
            epoch = np.datetime64("1948-01-01", "D")
            if "time" in f:
                dates = epoch + f["time"][...].astype("timedelta64[D]")
            else:
                # tile-assembled mosaics carry no time scale (only the
                # direct-mode MosaicWriter writes coords): the run config's
                # calendar IS the mosaic's day axis — cross-checked by length
                dates = _days(cfg).date64
            if len(dates) != ndays:
                raise ValueError(
                    f"mosaic day axis {ndays} != calendar {len(dates)} — "
                    "config span does not match the mosaic"
                )
            years, starts, ends, uyears = _month_bounds(dates)
            packed = d.dtype == np.int16
            nm, ny = len(starts), len(uyears)

            dst = p["root"] / f"agg_{var}.h5"
            tmp = dst.with_suffix(".tmp")
            with h5py.File(tmp, "w") as g:
                dt = np.int16 if packed else np.float32
                for name, n in (("monthly", nm), ("annual", ny)):
                    v = g.create_dataset(
                        name, (n, R, Cc), dtype=dt,
                        chunks=(1, min(256, R), min(256, Cc)), fletcher32=True,
                    )
                    v.attrs["units"] = "C"
                    if packed:
                        v.attrs["scale_factor"] = d.attrs["scale_factor"]
                        v.attrs["add_offset"] = d.attrs["add_offset"]
                        v.attrs["_FillValue"] = FILL_I16
                    else:
                        v.attrs["_FillValue"] = FILL_F32
                tm = g.create_dataset(
                    "time_month",
                    data=(
                        dates[starts].astype("datetime64[M]")
                        .astype("datetime64[D]") - epoch
                    ).astype(np.int32),
                )
                tm.attrs["units"] = "days since 1948-01-01 00:00:00"
                tm.make_scale("time_month")
                yr = g.create_dataset("year", data=uyears.astype(np.int32))
                yr.make_scale("year")
                # member-day counts: a partial edge month/year (config span
                # not month-aligned) is otherwise indistinguishable from a
                # full one
                g.create_dataset(
                    "n_days", data=(ends - starts).astype(np.int32)
                )
                g.create_dataset(
                    "n_days_year",
                    data=np.array(
                        [int((years == y).sum()) for y in uyears], np.int32
                    ),
                )
                # CF georeferencing: copy the mosaic's lat/lon scales so
                # netCDF4/xarray consumers get a standalone product
                for axis in ("lat", "lon"):
                    if axis in f:
                        sc_d = g.create_dataset(axis, data=f[axis][...])
                        for k, v in f[axis].attrs.items():
                            sc_d.attrs[k] = v
                        sc_d.make_scale(axis)
                if "lat" in g and "lon" in g:
                    _attach_dims(g, g["monthly"], ("time_month", "lat", "lon"))
                    _attach_dims(g, g["annual"], ("year", "lat", "lon"))
                g.attrs["Conventions"] = "CF-1.6"
                g.attrs["source"] = "topotpu"
                g.attrs["source_mosaic"] = src.name
                g.attrs["mean_rule"] = "finite iff every member day finite"
                for name, i, plane in _aggregate_core(d, dates):
                    g[name][i] = plane
            tmp.replace(dst)
            out[var] = {"path": str(dst), "months": nm, "years": ny}
    return out


# -------------------------------------------------------- stage: validate


def _streamed_core(cfg: TopoConfig, tiles_dir, rasters, mosaics) -> dict | None:
    """Validate from the engine's streamed write-verification stats in the
    manifests under ``tiles_dir``, with a disk re-read of a deterministic
    sample of tiles. ``mosaics[var]`` maps ``var`` (the daily int16 axis)
    and ``"normal"`` to arrays or HDF5 datasets of finalized direct-mode
    mosaics. None when the streamed stats don't cover the whole product; a
    disagreement between the stats and the sample raises."""
    import base64

    from topotpu_torch.core.grid import Tiling
    from topotpu_torch.io.ncdf import FILL_I16

    # union all manifests, per scope (unchunked / each chunk)
    def _scope(d):
        merged = {}
        for m in sorted(d.glob("manifest*.json")):
            if m.suffix != ".json":
                continue
            try:
                merged.update(json.loads(m.read_text()).get("tiles", {}))
            except (OSError, ValueError):
                return None
        return merged

    tiles_dir = pathlib.Path(tiles_dir)
    chunk_dirs = sorted(tiles_dir.glob("chunk_*_*"))
    scopes = (
        [_scope(d) for d in chunk_dirs] if chunk_dirs
        else [_scope(tiles_dir)]
    )
    if any(s is None or not s for s in scopes):
        return None

    tiling = Tiling(rasters.grid, cfg.tile_rows, cfg.tile_cols)
    land_tiles = list(tiling.land_tiles(rasters.landmask))
    tot = {v: dict.fromkeys(("cells", "cov", "norm", "se"), 0)
           for v in (C.TMIN, C.TMAX)}
    viol = pairs = 0
    per_tile: dict = {}
    for ts in land_tiles:
        for var in (C.TMIN, C.TMAX):
            key = f"{var}_{ts.tile_id:05d}"
            entries = []
            for s in scopes:
                e = s.get(key)
                if (
                    e is None
                    or not str(e.get("file", "")).startswith("mosaic_")
                    or "verify" not in e
                    or "viol" not in e["verify"]
                ):
                    return None
                entries.append(e)
            cells = int(entries[0]["cells"])
            covs = [int(e["verify"]["covered"]) for e in entries]
            if all(c == cells for c in covs):
                cov = cells
            else:
                # exact full-span coverage = popcount of the AND of the
                # partial chunks' per-cell bitmaps (a fully-covered chunk
                # is all-ones and drops out)
                bits = None
                for e, c in zip(entries, covs):
                    if c == cells:
                        continue
                    b64 = e["verify"].get("cov_bits")
                    if b64 is None:
                        return None  # pre-bitmap manifest: need the scan
                    arr = np.frombuffer(base64.b64decode(b64), np.uint8)
                    bits = arr.copy() if bits is None else (bits & arr)
                cov = int(np.unpackbits(bits).sum())
            norms = [e["verify"] for e in entries if "normal" in e["verify"]]
            if not norms:
                return None
            t = tot[var]
            t["cells"] += cells
            t["cov"] += cov
            t["norm"] += int(norms[0]["normal"])
            t["se"] += int(norms[0]["se"])
            per_tile[key] = {
                "cells": cells, "cov": cov,
                "norm": int(norms[0]["normal"]), "se": int(norms[0]["se"]),
                "viol": sum(int(e["verify"]["viol"]) for e in entries),
            }
            if var == C.TMIN:  # pair stats recorded identically on both
                viol += per_tile[key]["viol"]
                pairs += sum(
                    int(e["verify"].get("pairs", 0)) for e in entries
                )

    # deterministic disk sample: full day-axis re-read of ~sample_frac of
    # the land tiles, compared against the streamed stats
    frac = cfg.validate_sample_frac
    sampled = [
        ts for ts in land_tiles
        if (ts.tile_id * 2654435761 % 2**32) / 2**32 < frac
    ] or land_tiles[:1]
    deep_checked = 0
    for ts in sampled:
        sl = (slice(ts.row0, ts.row0 + ts.nrows),
              slice(ts.col0, ts.col0 + ts.ncols))
        land_t = rasters.landmask[sl]
        raws = {}
        for var in (C.TMIN, C.TMAX):
            f = mosaics[var]
            key = f"{var}_{ts.tile_id:05d}"
            rec = per_tile[key]
            raw = f[var][(slice(None),) + sl]
            raws[var] = raw
            cov_true = int(((raw != FILL_I16).all(0) & land_t).sum())
            # streamed coverage is exact (bitmap-AND across chunks), so the
            # disk comparison is a strict equality
            if cov_true != rec["cov"]:
                raise RuntimeError(
                    f"validate: streamed coverage for {key} "
                    f"({rec['cov']}/{rec['cells']}) disagrees with the "
                    f"product on disk ({cov_true}) — mosaic corrupt or "
                    "stale; run validate --deep"
                )
            nb = f["normal"][(slice(None),) + sl]
            if int((np.isfinite(nb).all(0) & land_t).sum()) != rec["norm"]:
                raise RuntimeError(
                    f"validate: streamed normal coverage for {key} "
                    "disagrees with the product on disk"
                )
        a, b = raws[C.TMIN], raws[C.TMAX]
        both = (a != FILL_I16) & (b != FILL_I16)
        viol_true = int(
            (both & (b.astype(np.int32) < a.astype(np.int32) - 1)).sum()
        )
        rec = per_tile[f"{C.TMIN}_{ts.tile_id:05d}"]
        if viol_true != rec["viol"]:
            raise RuntimeError(
                f"validate: streamed crossvar count for tile "
                f"{ts.tile_id} ({rec['viol']}) disagrees with disk "
                f"({viol_true})"
            )
        deep_checked += 1

    out: dict = {"mode": "streamed",
                 "deep_sampled_tiles": deep_checked,
                 "deep_frac": round(len(sampled) / max(len(land_tiles), 1), 3)}
    for var in (C.TMIN, C.TMAX):
        t = tot[var]
        cells = max(t["cells"], 1)
        cov_n, cov_se, cov_d = (
            t["norm"] / cells, t["se"] / cells, t["cov"] / cells
        )
        ok = cov_n > 0.99 and cov_se > 0.99 and cov_d > 0.99
        out[var] = {
            "status": "ok" if ok else "incomplete",
            "normal_coverage": round(cov_n, 4),
            "se_coverage": round(cov_se, 4),
            "daily_coverage": round(cov_d, 4),
        }
    out["crossvar"] = {
        "violations": viol, "rate": (viol / pairs) if pairs else 0.0,
    }
    return out


def _validate_streamed(cfg: TopoConfig, p, rasters) -> dict | None:
    """Fast validate from the engine's streamed write-verification stats
    (the full post-hoc scan was the single largest stage at north-star
    scale). The writer thread already read every tile back through the
    HDF5 layer and recorded covered/normal/se cell counts and the raw
    cross-variable re-check in the manifest; this aggregates those and
    spot-checks a deterministic sample of tiles against the product ON
    DISK (full day-axis re-read). Returns None when the streamed stats
    don't cover the whole product (per-tile layout, pre-verify manifests,
    missing pair check) — the caller then runs the full scan. A
    disagreement between streamed stats and the disk sample raises: that is
    precisely the corruption validate exists to catch.

    Chunked-run coverage is EXACT: a chunk that covers every land cell of
    a tile contributes no constraint; a partial chunk carries a per-cell
    coverage bitmap (engine verify["cov_bits"]) and the full-span count is
    the popcount of the bitmaps' AND. A partial tile whose manifest
    predates the bitmaps (or lost it) falls back to the full scan rather
    than to a bound."""
    import h5py

    # both masters must be finalized direct-mode mosaics
    for var in (C.TMIN, C.TMAX):
        path = p[f"mosaic_{var}"]
        if not path.exists():
            return None
        try:
            with h5py.File(path, "r") as f:
                if f.attrs.get("layout") != "direct" or not f.attrs.get(
                    "complete", False
                ):
                    return None
        except OSError:
            return None
    with h5py.File(p[f"mosaic_{C.TMIN}"], "r") as fn, h5py.File(
        p[f"mosaic_{C.TMAX}"], "r"
    ) as fx, _raise_bit_rot():
        return _streamed_core(cfg, p["tiles"], rasters, {C.TMIN: fn, C.TMAX: fx})


def step_validate(cfg: TopoConfig, deep: bool = False) -> dict:
    """Output integrity check (the rebuild's failure-detection pass,
    SURVEY §5): every land cell in each mosaic must carry finite normals,
    finite SE, and a full daily series; reports per-variable coverage.
    Default: engine-streamed verify stats + a sampled disk re-scan when
    available (see _validate_streamed); ``deep=True`` or any gap in the
    streamed stats -> full product re-scan."""
    import h5py

    from topotpu_torch.io.ncdf import FILL_I16, decode_array

    p = _paths(cfg)
    rasters = RasterStack.load(p["rasters"])
    if not deep:
        res = _validate_streamed(cfg, p, rasters)
        if res is not None:
            return res
    land = rasters.landmask
    out = {}
    files = {}
    try:
        for var in (C.TMIN, C.TMAX):
            path = p[f"mosaic_{var}"]
            if path.exists():
                files[var] = h5py.File(path)
            else:
                out[var] = {"status": "missing"}
        # a cell counts as daily-covered only when its ENTIRE series is
        # finite. ONE streaming pass over the day axis serves both the
        # per-variable coverage scan and the cross-variable re-check. For
        # int16-packed data coverage is exactly "raw != fill": scan the raw
        # int16 — half the memory traffic, no float decode.
        day_fin = {
            var: np.ones(f[var].shape[1:], bool) for var, f in files.items()
        }
        both = len(files) == 2
        n_viol = n_total = 0
        if both:
            dn, dx = files[C.TMIN][C.TMIN], files[C.TMAX][C.TMAX]
            # int16-packed mosaics may quantize the two variables on
            # different grids; a reconciled midpoint can then differ by up
            # to half a step per side — tolerate exactly that. Direct-mode
            # mosaics share ONE run-global grid, where the check reduces to
            # a raw integer compare: b*s+o < a*s+o - s  <=>  raw_b < raw_a - 1.
            same_grid = (
                dn.dtype == np.int16 and dx.dtype == np.int16
                and dn.attrs.get("scale_factor")
                == dx.attrs.get("scale_factor")
                and dn.attrs.get("add_offset") == dx.attrs.get("add_offset")
            )
            eps = sum(
                0.5 * abs(float(d.attrs.get("scale_factor", 0.0)))
                for d in (dn, dx) if d.dtype == np.int16
            )
        # The scan below indexes every file with one shared t0 range; a
        # shorter (stale/truncated) mosaic would return EMPTY blocks past its
        # end, and fin.all(axis=0) over an empty block is all-True — the
        # missing trailing days would silently count as covered. A day-axis
        # mismatch between the two variables is itself an integrity failure.
        axis_lens = {v: f[v].shape[0] for v, f in files.items()}
        if len(set(axis_lens.values())) > 1:
            raise RuntimeError(
                f"mosaic day-axis mismatch {axis_lens} — one mosaic is "
                "stale or truncated; rerun interp for the shorter variable"
            )
        ndays = max(axis_lens.values(), default=0)
        for t0 in range(0, ndays, 64):
            blks = {}
            for var, f in files.items():
                d = f[var]
                raw = d[t0 : t0 + 64]
                fin = (
                    (raw != FILL_I16) if d.dtype == np.int16
                    else np.isfinite(raw)
                )
                day_fin[var] &= fin.all(axis=0)
                blks[var] = (raw, fin)
            if both:
                (a, fa), (b, fb) = blks[C.TMIN], blks[C.TMAX]
                fin = fa & fb
                if same_grid:
                    viol = fin & (
                        b.astype(np.int32) < a.astype(np.int32) - 1
                    )
                else:
                    av = decode_array(a, dn)
                    bv = decode_array(b, dx)
                    viol = fin & (bv < av - eps)
                n_viol += int(viol.sum())
                n_total += int(fin.sum())
        for var, f in files.items():
            normal = f["normal"][...]
            se = f["se"][...]
            cov_n = float(np.isfinite(normal[:, land]).mean())
            cov_se = float(np.isfinite(se[:, land]).mean())
            cov_d = float(day_fin[var][land].mean())
            ok = cov_n > 0.99 and cov_se > 0.99 and cov_d > 0.99
            out[var] = {
                "status": "ok" if ok else "incomplete",
                "normal_coverage": round(cov_n, 4),
                "se_coverage": round(cov_se, 4),
                "daily_coverage": round(cov_d, 4),
            }
        if both:
            # cross-variable physical consistency: daily tmax must be >=
            # tmin everywhere (interp/mosaic reconcile; independent re-check)
            out["crossvar"] = {
                "violations": n_viol,
                "rate": (n_viol / n_total) if n_total else 0.0,
            }
    except OSError as e:
        raise _bit_rot_error(e) from e
    finally:
        for f in files.values():
            f.close()
    return out


def _validate_f64_core(eng, stations, n_tiles: int, cfg: TopoConfig, device) -> dict:
    """The first ``n_tiles`` land tiles of ``eng`` (a TileEngine) at float32
    on ``device`` against float64 on the host's CPU: one variable's report."""
    from topotpu_torch.interp.f64check import compare_f32_f64

    day_valid = eng.layout.day_valid
    reports = []
    for spec in list(eng.tiling.land_tiles(eng.rasters.landmask))[:n_tiles]:
        task = eng.prepare(spec, stations)
        reports.append(compare_f32_f64(task.inputs, cfg.interp,
                                       day_valid=day_valid, device=device))
    return {
        "tiles": len(reports),
        "normal_rmse": max(r["normal"]["rmse"] for r in reports),
        "normal_max": max(r["normal"]["max"] for r in reports),
        "daily_rmse": max(r["daily"]["rmse"] for r in reports),
        "se_rmse": max(r["se"]["rmse"] for r in reports),
        "ok_flip_rate": max(r["ok_flip_rate"] for r in reports),
        "within_parity_bar": all(
            r["normal"]["rmse"] < 0.05 and r["daily"]["rmse"] < 0.05
            for r in reports
        ),
    }


def step_validate_f64(cfg: TopoConfig, n_tiles: int = 1, *, device) -> dict:
    """f64 end-to-end validation mode (SURVEY §7 "f32 vs f64"): re-run a
    sample of production tiles at float64 on CPU through the identical code
    path and report the f32 error. The reference computed in f64 throughout
    (numpy/R), so this quantifies rebuild-vs-reference solve numerics."""
    from topotpu_torch.dist.engine import TileEngine

    p = _paths(cfg)
    days = _days(cfg)
    rasters = RasterStack.load(p["rasters"])
    eng = TileEngine(cfg, rasters, days, p["tiles"], device=device)
    out = {}
    for var in (C.TMIN, C.TMAX):
        path = p[f"serial_{var}"]
        if not path.exists():
            out[var] = {"status": "missing serial DB"}
            continue
        out[var] = _validate_f64_core(eng, _station_set(path, days), n_tiles,
                                      cfg, device)
    return out


# ----------------------------------------------------- stage: make-regions


def step_make_regions(cfg: TopoConfig, n_regions: int = 12,
                      seed: int = 0) -> dict:
    """Build a climate-division-like region raster from the covariate
    rasters (geo.regions.make_climate_regions) and write it atomically to
    ``data_dir/regions.h5`` — the stand-in for the reference's rasterized
    US climate divisions (SURVEY §2.16) when no division polygons exist.
    ``step_optim_nnghs`` picks the file up automatically."""
    import h5py

    from topotpu_torch.geo.regions import make_climate_regions

    p = _paths(cfg)
    rasters = RasterStack.load(p["rasters"])
    reg = make_climate_regions(rasters, n_regions=n_regions, seed=seed)
    dst = p["root"] / "regions.h5"
    tmp = dst.with_suffix(".tmp")
    with h5py.File(tmp, "w") as f:
        d = f.create_dataset("regions", data=reg, compression="gzip",
                             compression_opts=1)
        d.attrs["n_regions"] = int(reg.max()) + 1
        d.attrs["source"] = "kmeans(lat, lon*cos(lat), elev, lst)"
    tmp.replace(dst)
    labels, counts = np.unique(reg[reg >= 0], return_counts=True)
    return {
        "path": str(dst),
        "n_regions": int(labels.size),
        "cells_per_region": {str(int(k)): int(c)
                             for k, c in zip(labels, counts)},
    }


# ----------------------------------------------------- stage: xval tables


def _station_region_labels(cfg: TopoConfig, lon, lat) -> np.ndarray | None:
    """Region labels at station locations from data_dir/regions.h5 when it
    exists (make-regions artifact / rasterized climate divisions), else
    None (single global region)."""
    import h5py

    p = _paths(cfg)
    rp = p["root"] / "regions.h5"
    if not rp.exists():
        return None
    rasters = RasterStack.load(p["rasters"])
    with h5py.File(rp) as f:
        reg_grid = f["regions"][...]
    if reg_grid.shape != rasters.grid.shape:
        return None
    return _sample_regions(reg_grid, *rasters.grid.rowcol(lon, lat))


def _by_region(per_station: np.ndarray, regions: np.ndarray | None) -> dict:
    """{region: (mean, n_stations)} over finite per-station scores."""
    if regions is None:
        regions = np.zeros(len(per_station), int)
    out = {}
    for r in np.unique(regions):
        v = per_station[regions == r]
        v = v[np.isfinite(v)]
        if v.size:
            out[str(int(r))] = {"mae": round(float(v.mean()), 4),
                                "n_stations": int(v.size)}
    return out


def _vario(stn: dict) -> np.ndarray:
    return np.stack([stn[C.VARIO_NUG], stn[C.VARIO_PSILL], stn[C.VARIO_RNG]],
                    axis=-1)


def _valid(stn: dict) -> np.ndarray:
    return np.repeat(~stn[C.BAD].astype(bool)[:, None], 12, 1)


def step_xval_interp(cfg: TopoConfig, *, device) -> dict:
    """Leave-one-station-out NORMALS x-val, both variables, reported per
    month and per region — the protocol behind the reference paper's
    normals error tables (SURVEY §4/§6: MAE ~0.5-0.8 C per month/region;
    synthetic truth should beat it)."""
    from topotpu_torch.interp.xval import xval_interp_normals

    p = _paths(cfg)
    out: dict = {}
    for var in (C.TMIN, C.TMAX):
        path = p[f"serial_{var}"]
        if not path.exists():
            out[var] = {"status": "missing serial DB"}
            continue
        stn, _ = _read_serial(path)
        lon, lat = stn[C.LON], stn[C.LAT]
        sc = xval_interp_normals(
            lon, lat, stn[C.ELEV], stn[C.TDI], stn[C.LST], stn[C.NORM],
            _vario(stn), _valid(stn), cfg.interp, device,
        )
        regions = _station_region_labels(cfg, lon, lat)
        err = np.abs(sc.per_station_err)
        fin = np.isfinite(err)
        cnt = fin.sum(axis=1)
        stn_mae = np.where(
            cnt > 0,
            np.where(fin, err, 0.0).sum(axis=1) / np.maximum(cnt, 1),
            np.nan,
        )
        out[var] = {
            "mae_mean": round(float(sc.mae.mean()), 4),
            "bias_mean": round(float(sc.bias.mean()), 4),
            "r2_mean": round(float(sc.r2.mean()), 4),
            "mae_by_month": [round(float(x), 4) for x in sc.mae],
            "mae_by_region": _by_region(stn_mae, regions),
            "n_stations_scored": int(np.isfinite(stn_mae).sum()),
        }
    return out


def step_xval_daily(cfg: TopoConfig, *, device) -> dict:
    """Leave-one-station-out x-val of full DAILY values (normals + GWR
    anomalies recombined), both variables, per month and per region — the
    reference paper's headline daily error tables (SURVEY §6: daily MAE
    ~1.2-2.0 C)."""
    from topotpu_torch.interp.xval import xval_interp_daily

    p = _paths(cfg)
    days = _days(cfg)
    out: dict = {}
    for var in (C.TMIN, C.TMAX):
        path = p[f"serial_{var}"]
        if not path.exists():
            out[var] = {"status": "missing serial DB"}
            continue
        stn, filled = _read_serial(path)
        lon, lat = stn[C.LON], stn[C.LAT]
        norms = stn[C.NORM]
        anoms = (filled - norms[:, days.month_idx]).astype(np.float32)
        res = xval_interp_daily(
            lon, lat, stn[C.ELEV], stn[C.TDI], stn[C.LST], norms,
            _vario(stn), _valid(stn), anoms, days.month_idx, cfg.interp,
            device,
        )
        regions = _station_region_labels(cfg, lon, lat)
        psm = res.pop("per_station_mae")
        out[var] = {
            **{k: (round(float(v), 4) if isinstance(v, float) else
                   [round(float(x), 4) for x in v])
               for k, v in res.items()},
            "mae_by_region": _by_region(psm, regions),
            "n_stations_scored": int(np.isfinite(psm).sum()),
        }
    return out


def _sample_regions(reg_grid: np.ndarray, rows: np.ndarray,
                    cols: np.ndarray) -> np.ndarray:
    """Region labels at station cells. A station whose nearest cell is
    unlabeled (-1: ocean in a clustered raster, or an unmapped hole in a
    user raster — coastal stations hit this routinely) snaps to the
    nearest labeled cell in an expanding window, so no spurious "-1"
    region leaks into the optimization tables."""
    regions = reg_grid[rows, cols].astype(int)
    R, Cc = reg_grid.shape
    for i in np.flatnonzero(regions < 0):
        r, c = int(rows[i]), int(cols[i])
        for w in range(1, max(R, Cc)):
            blk = reg_grid[max(0, r - w) : r + w + 1,
                           max(0, c - w) : c + w + 1]
            br, bc = np.nonzero(blk >= 0)
            if br.size:
                rr = br + max(0, r - w)
                cc = bc + max(0, c - w)
                j = np.argmin((rr - r) ** 2 + (cc - c) ** 2)
                regions[i] = int(reg_grid[rr[j], cc[j]])
                break
    return regions


# ----------------------------------------------------- stage: optim-nnghs


def _optim_nnghs_core(stn: dict, filled, regions, days, cfg: TopoConfig,
                      candidates, device) -> dict:
    """Both LOO sweeps of one variable: the normals k per region, then the
    anomaly (GWR daily) k per region at the config normals k. The report."""
    from topotpu_torch.interp.xval import optimize_nnghs, optimize_nnghs_anoms

    vario, valid = _vario(stn), _valid(stn)
    res = optimize_nnghs(
        stn[C.LON], stn[C.LAT], stn[C.ELEV], stn[C.TDI], stn[C.LST],
        stn[C.NORM], vario, valid,
        candidates=candidates,
        region_labels=regions,
        base_params=cfg.interp,
        device=device,
    )
    # anomaly neighborhood size: its own sweep against the daily LOO
    # protocol, normals k fixed — the reference's separate
    # mpi_optim_nstns_anoms job (SURVEY §2.16)
    norms = stn[C.NORM]
    anoms = (filled - norms[:, days.month_idx]).astype(np.float32)
    res_a = optimize_nnghs_anoms(
        stn[C.LON], stn[C.LAT], stn[C.ELEV], stn[C.TDI], stn[C.LST], norms,
        vario, valid, anoms, days.month_idx,
        candidates=tuple(k for k in candidates
                         if k <= cfg.interp.k_neighbors),
        region_labels=regions,
        base_params=cfg.interp,
        device=device,
    )
    return {
        "best_k_by_region": {str(k): v for k, v in res["best"].items()},
        "global_mae_by_k": {
            str(k): float(v.mean()) for k, v in res["mae"].items()
        },
        "best_k_anom_by_region": {
            str(k): v for k, v in res_a["best"].items()
        },
        "global_daily_mae_by_k_anom": {
            str(k): float(v) for k, v in res_a["mae"].items()
        },
    }


def _nnghs_k_arrays(rep: dict, ids, cfg: TopoConfig):
    """(k_norm, k_anom) int32 per region id from one variable's report;
    a region without a choice takes the config k."""
    bn = {int(k): int(v) for k, v in rep["best_k_by_region"].items()}
    ba = {int(k): int(v) for k, v in rep["best_k_anom_by_region"].items()}
    dflt_n = int(cfg.interp.k_neighbors)
    dflt_a = min(int(cfg.interp.k_neighbors_anom), dflt_n)
    return (np.array([bn.get(int(r), dflt_n) for r in ids], np.int32),
            np.array([ba.get(int(r), dflt_a) for r in ids], np.int32))


def step_optim_nnghs(cfg: TopoConfig, candidates=(8, 16, 24, 32, 48),
                     regions_path: str | None = None, *, device) -> dict:
    """Neighborhood-size optimization via LOO x-val (SURVEY §2.16).

    ``regions_path``: an HDF5 file with an integer ``regions`` dataset on
    the run's grid (e.g. rasterized climate divisions); station labels are
    sampled at station locations. Without it, ``data_dir/regions.h5`` is
    used when present (see step_make_regions), else covariate-clustered
    regions are built on the fly — both climate-division-like groupings.

    Both sweeps run PER VARIABLE against that variable's own serial DB
    (normals, variograms and anomalies differ between tmin and tmax even on
    a shared network) — the reference ran its optimization jobs once per
    variable (``mpi_optim_nstns_norms_{tmin,tmax}``, SURVEY §2.16). Output
    is keyed by variable."""
    import h5py

    p = _paths(cfg)
    days = _days(cfg)
    out: dict = {}
    # regions depend only on the covariate rasters, not the variable —
    # resolve/build ONCE. An on-the-fly build is persisted to regions.h5
    # (the make-regions artifact path) so reruns skip the clustering.
    rasters = RasterStack.load(p["rasters"])
    rp = regions_path or (
        p["root"] / "regions.h5"
        if (p["root"] / "regions.h5").exists() else None
    )
    if not rp:
        step_make_regions(cfg)  # builds AND persists regions.h5
        rp = p["root"] / "regions.h5"
    with h5py.File(rp) as f:
        reg_grid = f["regions"][...]
    if reg_grid.shape != rasters.grid.shape:
        raise ValueError(
            f"region raster {reg_grid.shape} != grid {rasters.grid.shape}"
        )
    for var in (C.TMIN, C.TMAX):
        path = p[f"serial_{var}"]
        if not path.exists():
            out[var] = {"status": "missing serial DB"}
            continue
        stn, filled = _read_serial(path)
        regions = _sample_regions(
            reg_grid, *rasters.grid.rowcol(stn[C.LON], stn[C.LAT])
        )
        out[var] = _optim_nnghs_core(stn, filled, regions, days, cfg,
                                     candidates, device)
    # Persist the optimization so production CONSUMES it (the reference's
    # optim jobs exist to produce nnghs tables "used by 2.10", SURVEY
    # §2.16): nnghs.h5 carries the region grid plus, per variable, the
    # chosen normals/anomaly k per region id. step_interp picks it up
    # automatically (data_dir/nnghs.h5 or --nnghs) and runs each tile at
    # its dominant region's sizes; the interp manifest records the k each
    # tile actually used.
    ids = np.unique(reg_grid).astype(np.int32)
    nn_path = p["root"] / "nnghs.h5"
    tmp = nn_path.with_suffix(".h5.tmp")
    with h5py.File(tmp, "w") as f:
        f.create_dataset("regions", data=reg_grid.astype(np.int32))
        f.create_dataset("region_ids", data=ids)
        f.attrs["candidates"] = [int(k) for k in candidates]
        for var, rep in out.items():
            if "best_k_by_region" not in rep:
                continue  # missing serial DB for this variable
            k_norm, k_anom = _nnghs_k_arrays(rep, ids, cfg)
            f.create_dataset(f"k_norm_{var}", data=k_norm)
            f.create_dataset(f"k_anom_{var}", data=k_anom)
    tmp.replace(nn_path)
    out["artifact"] = str(nn_path)
    return out


def reconcile_cross_variable(p_tmin, p_tmax, time_chunk: int = 64) -> dict:
    """Cross-variable consistency (SURVEY §2.14: PtInterpTair validates
    tmax > tmin): the two variables are interpolated independently, so rare
    sub-noise crossings can occur where the diurnal range approaches zero.
    Where daily tmax < tmin, set both to their midpoint — mean-preserving,
    collapsing the (already non-physical) negative diurnal range to zero.
    Streams over the time axis; returns violation statistics."""
    import h5py

    from topotpu_torch.io.ncdf import FILL_I16, decode_array

    def _encoder(v):
        """int16 encoder for a packed dataset (decode = io.ncdf.read_slice);
        identity for f32. Returns (encode, half_quantization_step)."""
        if v.dtype != np.int16:
            return (lambda vals, raw: vals), 0.0
        s = float(v.attrs.get("scale_factor", 1.0))
        o = float(v.attrs.get("add_offset", 0.0))

        def enc(vals, raw):
            # nan_to_num first: NaNs (masked cells) are restored from raw
            # below, but casting NaN to int16 raises a RuntimeWarning.
            # clip: a midpoint can exceed this variable's representable
            # range by up to half the other variable's span; an unclipped
            # cast wraps — and the first overflow step IS FILL_I16.
            q = np.clip(
                np.round((np.nan_to_num(vals) - o) / s), -32767, 32767
            ).astype(np.int16)
            return np.where(raw == FILL_I16, raw, q)

        return enc, 0.5 * abs(s)

    n_viol = 0
    n_total = 0
    worst = 0.0
    with h5py.File(p_tmin, "r+") as fn, h5py.File(p_tmax, "r+") as fx:
        dn, dx = fn[C.TMIN], fx[C.TMAX]
        if dn.shape != dx.shape:
            raise ValueError(f"mosaic shapes differ: {dn.shape} != {dx.shape}")
        enc_n, half_n = _encoder(dn)
        enc_x, half_x = _encoder(dx)
        # quantization tolerance: packed variables sit on different int16
        # grids, so decoded tmax can read up to a step below tmin on a
        # physically-consistent cell — do not count or "fix" those
        # (keeps this rate comparable to step_validate's eps-tolerant one)
        eps = half_n + half_x
        for t0 in range(0, dn.shape[0], time_chunk):
            raw_a = dn[t0 : t0 + time_chunk]
            raw_b = dx[t0 : t0 + time_chunk]
            a = decode_array(raw_a, dn)
            b = decode_array(raw_b, dx)
            both = np.isfinite(a) & np.isfinite(b)
            bad = both & (b < a - eps)
            # denominator = jointly-finite cells, matching step_validate's
            # independent re-check so the two reported rates are comparable
            n_total += int(both.sum())
            if bad.any():
                n_viol += int(bad.sum())
                worst = max(worst, float((a - b)[bad].max()))
                mid = 0.5 * (a + b)
                dn[t0 : t0 + time_chunk] = enc_n(
                    np.where(bad, mid, a), raw_a
                )
                dx[t0 : t0 + time_chunk] = enc_x(
                    np.where(bad, mid, b), raw_b
                )
        fn.attrs["crossvar_violations"] = n_viol
        fx.attrs["crossvar_violations"] = n_viol
    return {
        "violations": n_viol,
        "rate": (n_viol / n_total) if n_total else 0.0,
        "worst_crossing_C": worst,
    }


# ---------------------------------------------------------- stage: mosaic


def _assemble_direct_shards(cfg, p, rasters, tiling, days) -> dict:
    """Direct-to-mosaic finalization of a job over several processes: every
    process wrote its strided tile set straight into its own full-grid shard
    (mosaic_<var>_pNNN.h5); publish ONE master mosaic per variable as an
    HDF5 virtual dataset over the shards (metadata only, no tile copy; the
    analogue of the single-process direct branch of ``step_mosaic``).
    Cross-variable reconcile normally happened on the device per tile; the
    host fallback runs per shard PAIR (both variables' shard k cover the
    same tiles: ownership does not depend on the variable) before assembly."""
    import h5py

    from topotpu_torch.io.ncdf import build_virtual_mosaic

    shard_lists = {}
    for var in (C.TMIN, C.TMAX):
        found = sorted(
            p["root"].glob(f"mosaic_{var}_p[0-9][0-9][0-9].h5")
        )
        if not found:
            raise RuntimeError(
                f"direct-mode shard claims exist but no mosaic_{var}_p*.h5 "
                "shards found — rerun the interp stage"
            )
        with h5py.File(found[0], "r") as f:
            n_proc = int(f.attrs.get("process_count", 1))
        if len(found) != n_proc:
            raise RuntimeError(
                f"direct-mode mosaic incomplete: {len(found)} of {n_proc} "
                f"{var} shards present — rerun the interp stage on the "
                "missing hosts (their manifests resume)"
            )
        shard_lists[var] = found

    # host reconcile fallback, shard pair by shard pair
    crossvar = None
    for pn, px in zip(shard_lists[C.TMIN], shard_lists[C.TMAX]):
        with h5py.File(pn, "r") as a, h5py.File(px, "r") as b:
            done = bool(a.attrs.get("reconciled", False)) and bool(
                b.attrs.get("reconciled", False)
            )
        if done:
            continue
        r = reconcile_cross_variable(pn, px)
        if crossvar is None:
            crossvar = {"violations": 0, "rate": 0.0, "worst_crossing_C": 0.0}
        crossvar["violations"] += r["violations"]
        crossvar["worst_crossing_C"] = max(
            crossvar["worst_crossing_C"], r["worst_crossing_C"]
        )
        for sp in (pn, px):
            with h5py.File(sp, "r+") as f:
                f.attrs["reconciled"] = True

    land = list(tiling.land_tiles(rasters.landmask))
    out: dict = {}
    for var in (C.TMIN, C.TMAX):
        res = build_virtual_mosaic(
            p[f"mosaic_{var}"], var, shard_lists[var],
            rasters.grid, days.date64, land,
        )
        out[var] = res["n_tiles"]
    if crossvar is not None:
        out["crossvar"] = crossvar
    return out


def _latest_layout(tiles_dir):
    """'direct' / 'shard' / 'tiles' / None — where the most recent interp
    run put its data, decided from the engine manifests (the source of
    truth). Mosaic attrs alone can be stale: a completed direct mosaic left
    on disk must not short-circuit assembly of per-tile output written by a
    LATER interp run in a per-tile configuration. 'shard' = multi-process
    direct claims pointing at per-process mosaic shards
    (mosaic_<var>_pNNN.h5)."""
    import re

    tiles_dir = pathlib.Path(tiles_dir)
    mans = [tiles_dir / "manifest.json"] + [
        d / "manifest.json" for d in sorted(tiles_dir.glob("chunk_*_*"))
    ]
    newest = {"direct": -1.0, "tiles": -1.0, "shard": -1.0}
    for m in mans:
        if not m.exists():
            continue
        for info in json.loads(m.read_text()).get("tiles", {}).values():
            fname = str(info.get("file", ""))
            if not fname.startswith("mosaic_"):
                kind = "tiles"
            elif re.search(r"_p\d{3}\.h5$", fname):
                kind = "shard"
            else:
                kind = "direct"
            newest[kind] = max(newest[kind], float(info.get("ts", 0.0)))
    if all(v < 0 for v in newest.values()):
        return None
    return max(newest, key=newest.get)


def step_mosaic(cfg: TopoConfig) -> dict:
    """Assemble per-tile files into full-grid mosaics (the reference's
    final mosaic step, SURVEY §2.15)."""
    import h5py

    from topotpu_torch.core.grid import Tiling
    from topotpu_torch.dist.multihost import merge_manifests
    from topotpu_torch.io.ncdf import FILL_I16, read_var

    p = _paths(cfg)
    days = _days(cfg)
    rasters = RasterStack.load(p["rasters"])
    tiling = Tiling(rasters.grid, cfg.tile_rows, cfg.tile_cols)
    # multi-process runs leave one manifest per process; union them into
    # the canonical manifest.json (coordinator-only stage, shared filesystem)
    merge_manifests(p["tiles"])
    for chunk_dir in sorted(p["tiles"].glob("chunk_*_*")):
        merge_manifests(chunk_dir)

    # Direct-to-mosaic runs (TileEngine wrote tiles straight into the final
    # mosaics on the run-global pack grid): assembly already happened during
    # interp — this stage just checks finalization and applies the host
    # cross-variable reconcile iff the engine couldn't do it on device
    # (unpairable station sets fell back to two single-variable passes).
    direct = {}
    for var in (C.TMIN, C.TMAX):
        path = p[f"mosaic_{var}"]
        if not path.exists():
            continue
        try:
            with h5py.File(path, "r") as f:
                if f.attrs.get("layout") != "direct":
                    continue
                direct[var] = {
                    "complete": bool(f.attrs.get("complete", False)),
                    "reconciled": bool(f.attrs.get("reconciled", False)),
                    "n_tiles": int(f.attrs.get("n_tiles", 0)),
                }
        except OSError:
            # unreadable/corrupt mosaic: not direct-mode state — the
            # tile-merge path below decides what (if anything) replaces it
            continue

    layout = _latest_layout(p["tiles"])
    if cfg.mosaic_direct and layout == "shard":
        return _assemble_direct_shards(cfg, p, rasters, tiling, days)

    if direct and cfg.mosaic_direct and layout != "tiles":
        if set(direct) != {C.TMIN, C.TMAX} or not all(
            d["complete"] for d in direct.values()
        ):
            raise RuntimeError(
                "direct-mode mosaic incomplete — rerun the interp stage "
                "(its manifest resumes from the finished tiles)"
            )
        out = {v: direct[v]["n_tiles"] for v in direct}
        if not all(d["reconciled"] for d in direct.values()):
            out["crossvar"] = reconcile_cross_variable(
                p[f"mosaic_{C.TMIN}"], p[f"mosaic_{C.TMAX}"]
            )
            for var in (C.TMIN, C.TMAX):
                with h5py.File(p[f"mosaic_{var}"], "r+") as f:
                    f.attrs["reconciled"] = True
        return out

    def _tile_pack_bounds(path, name):
        """(lo, hi) decode bounds of a packed tile dataset, from attrs only
        (no data read); None when the dataset is unpacked f32."""
        with h5py.File(path, "r") as f:
            v = f[name]
            if v.dtype != np.int16:
                return None
            s = float(v.attrs.get("scale_factor", 1.0))
            o = float(v.attrs.get("add_offset", 0.0))
            return o - 32767 * abs(s), o + 32767 * abs(s)

    out = {}
    for var in (C.TMIN, C.TMAX):
        dst = p[f"mosaic_{var}"]
        tmp = dst.with_suffix(".tmp")
        R, Cc = rasters.grid.shape
        # chunked layouts (run_production) have per-chunk subdirs whose
        # time axes concatenate; unchunked tiles live in p["tiles"]
        chunk_dirs = sorted(p["tiles"].glob("chunk_*_*"))

        def tile_parts(ts):
            name = f"{var}_tile{ts.tile_id:05d}.h5"
            parts = (
                [d / name for d in chunk_dirs]
                if chunk_dirs else [p["tiles"] / name]
            )
            return parts if all(x.exists() for x in parts) else None

        # When every tile carries int16-packed dailies (production default),
        # the mosaic stays int16 too — a global scale/offset derived from
        # the per-tile pack attrs (no data pass) halves mosaic write +
        # downstream read bytes, and matches the packed distribution format
        # of the reference's published netCDFs. Any unpacked tile falls the
        # whole mosaic back to f32.
        bounds = []
        for ts in tiling.land_tiles(rasters.landmask):
            parts = tile_parts(ts)
            if parts is None:
                continue
            for part in parts:
                bounds.append(_tile_pack_bounds(part, var))
        pack = bool(bounds) and all(b is not None for b in bounds)
        if pack:
            lo = min(b[0] for b in bounds)
            hi = max(b[1] for b in bounds)
            g_scale = max(hi - lo, 1e-6) / 65500.0
            g_off = 0.5 * (hi + lo)

        with h5py.File(tmp, "w") as f:
            # fletcher32: bit rot raises at read (io/ncdf.py rationale)
            normal = f.create_dataset("normal", (12, R, Cc), np.float32,
                                      fillvalue=np.nan, fletcher32=True,
                                      chunks=(12, min(cfg.tile_rows, R),
                                              min(cfg.tile_cols, Cc)))
            se = f.create_dataset("se", (12, R, Cc), np.float32,
                                  fillvalue=np.nan, fletcher32=True,
                                  chunks=(12, min(cfg.tile_rows, R),
                                          min(cfg.tile_cols, Cc)))
            copts = dict(fletcher32=True)
            if cfg.output_compress:
                copts.update(compression="gzip",
                             compression_opts=cfg.output_compress)
            if pack:
                daily = f.create_dataset(
                    var, (days.ndays, R, Cc), np.int16, fillvalue=FILL_I16,
                    chunks=(min(32, days.ndays), cfg.tile_rows, cfg.tile_cols),
                    **copts,
                )
                daily.attrs["scale_factor"] = np.float32(g_scale)
                daily.attrs["add_offset"] = np.float32(g_off)
                daily.attrs["_FillValue"] = FILL_I16

                def put(part, t0, sl):
                    # requantize tile-grid int16 -> global-grid int16
                    # directly (no f32 decode / NaN pass: the stage is
                    # host-CPU-bound, not IO-bound, at production scale)
                    with h5py.File(part, "r") as tf:
                        v = tf[var]
                        q_old = v[...]
                        s_t = float(v.attrs.get("scale_factor", 1.0))
                        o_t = float(v.attrs.get("add_offset", 0.0))
                    q = np.rint(
                        q_old.astype(np.float32) * (s_t / g_scale)
                        + (o_t - g_off) / g_scale
                    ).astype(np.int16)
                    q[q_old == FILL_I16] = FILL_I16
                    daily[t0 : t0 + q.shape[0], sl[0], sl[1]] = q
                    return q.shape[0]
            else:
                daily = f.create_dataset(
                    var, (days.ndays, R, Cc), np.float32, fillvalue=np.nan,
                    chunks=(min(32, days.ndays), cfg.tile_rows, cfg.tile_cols),
                    **copts,
                )

                def put(part, t0, sl):
                    block = read_var(part, var)
                    daily[t0 : t0 + block.shape[0], sl[0], sl[1]] = block
                    return block.shape[0]

            n = 0
            for ts in tiling.land_tiles(rasters.landmask):
                parts = tile_parts(ts)
                if parts is None:
                    continue
                sl = (slice(ts.row0, ts.row0 + ts.nrows),
                      slice(ts.col0, ts.col0 + ts.ncols))
                normal[(slice(None),) + sl] = read_var(parts[0], f"{var}_normal")
                se[(slice(None),) + sl] = read_var(parts[0], f"{var}_se")
                t0 = 0
                for part in parts:
                    t0 += put(part, t0, sl)
                n += 1
            f.attrs["n_tiles"] = n
            f.attrs["cellsize"] = rasters.grid.cellsize
        out[var] = n
    # cross-variable reconciliation runs on the STILL-UNPUBLISHED tmp
    # files, so the atomic tmp+rename invariant holds for the whole stage:
    # a crash mid-reconcile leaves only tmps, never a half-reconciled
    # published mosaic.
    tmps = {v: p[f"mosaic_{v}"].with_suffix(".tmp") for v in (C.TMIN, C.TMAX)}
    if not any(out.get(v) for v in (C.TMIN, C.TMAX)):
        # zero tiles assembled (tiles/ deleted, or mosaic rerun after a
        # cleanup): publishing the empty tmps would OVERWRITE previously
        # published good mosaics with all-fill data
        for t in tmps.values():
            t.unlink(missing_ok=True)
        raise RuntimeError(
            "mosaic: no tile files found to assemble — nothing published "
            "(rerun the interp stage, or the product already exists)"
        )
    if out.get(C.TMIN) and out.get(C.TMAX):
        out["crossvar"] = reconcile_cross_variable(
            tmps[C.TMIN], tmps[C.TMAX]
        )
    for var in (C.TMIN, C.TMAX):
        if out.get(var):
            tmps[var].replace(p[f"mosaic_{var}"])
        else:
            tmps[var].unlink(missing_ok=True)
    return out
