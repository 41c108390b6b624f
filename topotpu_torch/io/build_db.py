"""Station DB construction from raw per-network formats (the port's own
copy of the JAX package's ``io/build_db.py``).

Parity target: ``twx/db/create_db_all_stations.py`` (SURVEY.md §2.2) — the
per-network ``Insert*`` classes (InsertGhcn, InsertSnotel, InsertRaws) that
parse raw observation files and assemble the all-obs netCDF database
(stations x days matrices for tmin/tmax plus provider QA flags).

Formats:
  * GHCN-Daily ``.dly``: fixed-width, one line per station-month-element,
    31 x (value + 3 flag chars), tenths of deg C, -9999 missing
    (NOAA's published format description; parser written from the spec).
  * GHCN station inventory ``ghcnd-stations.txt``: fixed-width metadata.
  * SNOTEL / RAWS: delimited daily exports (configurable column mapping).

Values arriving with a provider QA flag are dropped (the reference honors
GHCN QFLAGs the same way) — our own QA (topotpu_torch.qa) runs after.
"""

from __future__ import annotations

import dataclasses
import pathlib

import numpy as np

from topotpu_torch.core import constants as C
from topotpu_torch.core.dates import DaysMetadata
from topotpu_torch.io.stndb import StationDB


@dataclasses.dataclass
class ParsedStation:
    stn_id: str
    name: str = ""
    state: str = ""
    lon: float = np.nan
    lat: float = np.nan
    elev: float = np.nan
    # maps ymd int -> value (deg C)
    tmin: dict = dataclasses.field(default_factory=dict)
    tmax: dict = dataclasses.field(default_factory=dict)


# ----------------------------------------------------------------- GHCN-D


def parse_ghcnd_stations(text: str) -> dict[str, dict]:
    """ghcnd-stations.txt fixed-width inventory -> {stn_id: attrs}.

    Spec edge cases handled (NCEI readme.txt for ghcnd-stations):
      * elevation ``-999.9`` is the documented missing code -> NaN (a raw
        float() would keep it and poison the elevation covariate);
      * unparseable coordinate fields -> NaN (screened at build);
      * duplicated station ids (relocated stations re-listed): LAST entry
        wins, matching the file's most-recent-metadata convention — the
        deterministic choice is what matters for reproducibility."""
    def _f(s: str, missing=()):
        try:
            v = float(s)
        except ValueError:
            return np.nan
        return np.nan if v in missing else v

    out = {}
    for line in text.splitlines():
        if len(line) < 71:
            continue
        stn_id = line[0:11].strip()
        out[stn_id] = {
            "lat": _f(line[12:20]),
            "lon": _f(line[21:30]),
            "elev": _f(line[31:37], missing=(-999.9,)),
            "state": line[38:40].strip(),
            "name": line[41:71].strip(),
        }
    return out


_DAYS_IN_MONTH = (31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31)


def _valid_ymd(year: int, month: int, day: int) -> bool:
    """Calendar-aware date validity: .dly lines always carry 31 value
    slots, so day 30 of February exists in the layout — corrupt files can
    populate it, and an unguarded parse would emit impossible dates."""
    if not 1 <= month <= 12:
        return False
    dim = _DAYS_IN_MONTH[month - 1]
    if month == 2 and year % 4 == 0 and (year % 100 != 0 or year % 400 == 0):
        dim = 29
    return 1 <= day <= dim


class InsertGhcn:
    """Parse GHCN-Daily .dly files (SURVEY §2.2's InsertGhcn equivalent)."""

    ELEMENTS = {"TMIN": "tmin", "TMAX": "tmax"}

    def __init__(self, inventory: dict[str, dict] | None = None):
        self.inventory = inventory or {}

    def parse_dly(self, text: str, stn_id: str | None = None) -> ParsedStation:
        ps: ParsedStation | None = None
        for line in text.splitlines():
            if len(line) < 269:
                continue
            sid = line[0:11]
            if stn_id and sid != stn_id:
                continue
            if ps is not None and sid != ps.stn_id:
                # a .dly file is one station; silently merging a second
                # station's lines would attribute its observations to the
                # first station's coordinates — a multi-station text must
                # go through iter_ghcnd_tar (per member) or be split
                raise ValueError(
                    f"multiple station ids in one .dly text "
                    f"({ps.stn_id!r} then {sid!r}); pass stn_id= to select "
                    "one, or parse per-station members"
                )
            if ps is None:
                meta = self.inventory.get(sid, {})
                ps = ParsedStation(
                    stn_id=sid,
                    name=meta.get("name", ""),
                    state=meta.get("state", ""),
                    lon=meta.get("lon", np.nan),
                    lat=meta.get("lat", np.nan),
                    elev=meta.get("elev", np.nan),
                )
            elem = line[17:21]
            var = self.ELEMENTS.get(elem)
            if var is None:
                continue  # PRCP/SNOW/... interleave freely in real files
            try:
                year = int(line[11:15])
                month = int(line[15:17])
            except ValueError:
                continue
            target = getattr(ps, var)
            # Per-slot flag semantics (GHCN-D readme): VALUE(5) MFLAG(1)
            # QFLAG(1) SFLAG(1). Only a set QFLAG (failed NCEI QA) drops a
            # value — the reference behavior. MFLAG is measurement INFO
            # (e.g. 'L' = lagged reading) and SFLAG is the data SOURCE;
            # dropping on either would discard valid observations (MFLAG
            # 'T' trace applies to precipitation, never temperature).
            # Duplicated (station, month, element) lines: last wins (plain
            # dict assignment), deterministic under any input order.
            for day in range(31):
                off = 21 + day * 8
                raw = line[off : off + 5]
                qflag = line[off + 6 : off + 7]
                try:
                    v = int(raw)
                except ValueError:
                    continue
                if v == -9999:
                    continue
                if qflag.strip():  # provider QA flag -> drop (reference behavior)
                    continue
                if not _valid_ymd(year, month, day + 1):
                    continue  # e.g. Feb 30 slot populated in a corrupt file
                ymd = year * 10000 + month * 100 + (day + 1)
                target[ymd] = v / 10.0  # tenths C -> C
        return ps if ps is not None else ParsedStation(stn_id=stn_id or "?")


# -------------------------------------------------------------- SNOTEL/RAWS


def iter_ghcnd_tar(
    path: str | pathlib.Path,
    inventory: dict[str, dict] | None = None,
    report: dict | None = None,
):
    """Stream ParsedStations out of a ``ghcnd_all.tar[.gz]`` archive — the
    exact distribution format NCEI ships (SURVEY §2.1: one ~3 GB tarball of
    ~120k per-station ``.dly`` members). Opened in sequential streaming
    mode (``r|*``): a gzip member cannot seek, and materializing the
    archive's file list would hold 120k TarInfos; this reads each member
    once, in order, at constant memory. Non-``.dly`` members are skipped.

    A corrupt/short tarball (interrupted download — the realistic failure
    for a 3 GB FTP fetch) raises RuntimeError naming the archive and the
    member count reached: silently ingesting the readable prefix would
    build a plausible-looking DB missing half the network. Pass ``report``
    (a dict, filled in place) to reconcile against the inventory after a
    clean pass: members read, stations parsed, and which inventory station
    ids never appeared in the archive.
    """
    import tarfile

    ghcn = InsertGhcn(inventory)
    n_members = 0
    seen: set[str] = set()
    try:
        with tarfile.open(path, "r|*") as tf:
            for member in tf:
                if not member.isfile() or not member.name.endswith(".dly"):
                    continue
                f = tf.extractfile(member)
                if f is None:
                    continue
                n_members += 1
                ps = ghcn.parse_dly(f.read().decode("ascii", "replace"))
                seen.add(ps.stn_id)
                yield ps
    except (tarfile.TarError, EOFError, OSError) as e:
        raise RuntimeError(
            f"GHCN archive {path} is truncated or corrupt after "
            f"{n_members} .dly members ({e}) — re-download the archive; "
            "ingesting the readable prefix would silently drop the rest "
            "of the network"
        ) from e
    if report is not None:
        missing = sorted(set(inventory or ()) - seen)
        report.update(
            members=n_members,
            stations=len(seen),
            inventory_size=len(inventory or ()),
            missing_from_archive=missing,
        )


class InsertDelimited:
    """Generic delimited daily-obs parser (SNOTEL/RAWS exports).

    Column mapping: date (YYYY-MM-DD), tmin, tmax; configurable indices and
    units. The reference's InsertSnotel/InsertRaws normalize exactly these
    fields out of their network formats."""

    def __init__(self, date_col=0, tmin_col=1, tmax_col=2, sep=",",
                 unit="C", missing=("", "-99.9", "-9999", "M", "NA", "NaN")):
        self.date_col, self.tmin_col, self.tmax_col = date_col, tmin_col, tmax_col
        self.sep = sep
        self.unit = unit
        self.missing = set(missing)

    def _to_c(self, v: float) -> float:
        return (v - 32.0) * 5.0 / 9.0 if self.unit == "F" else v

    def parse(self, text: str, stn_id: str, **meta) -> ParsedStation:
        ps = ParsedStation(stn_id=stn_id, **meta)
        for line in text.splitlines():
            parts = [p.strip() for p in line.split(self.sep)]
            if len(parts) <= max(self.date_col, self.tmin_col, self.tmax_col):
                continue
            d = parts[self.date_col]
            if len(d) != 10 or d[4] != "-":
                continue  # header or malformed
            try:
                y, mo, dy = int(d[0:4]), int(d[5:7]), int(d[8:10])
            except ValueError:
                continue
            if not _valid_ymd(y, mo, dy):
                continue
            ymd = y * 10000 + mo * 100 + dy
            for col, var in ((self.tmin_col, "tmin"), (self.tmax_col, "tmax")):
                raw = parts[col]
                if raw in self.missing:
                    continue
                try:
                    getattr(ps, var)[ymd] = self._to_c(float(raw))
                except ValueError:
                    continue
        return ps


class InsertSnotel(InsertDelimited):
    """NRCS SNOTEL daily CSV (deg F in raw exports)."""

    def __init__(self):
        super().__init__(date_col=0, tmin_col=1, tmax_col=2, unit="F")


class InsertRaws(InsertDelimited):
    """WRCC RAWS daily listing (deg F)."""

    def __init__(self):
        super().__init__(date_col=0, tmin_col=1, tmax_col=2, unit="F")


# ------------------------------------------------------------------- build


def build_station_db(
    path: str | pathlib.Path,
    parsed: list[ParsedStation],
    days: DaysMetadata,
    min_obs: int = 30,
) -> StationDB:
    """Assemble the all-obs DB from parsed stations, written atomically
    (tmp + rename — the artifact-chain rule: a crash mid-build must never
    leave a half-written all_obs.h5 that a rerun's QA stage then trusts).

    ``parsed`` may be any iterable — including iter_ghcnd_tar's generator:
    each station is screened and converted to dense day rows AS IT
    STREAMS, so an archive-scale ingest (~120k GHCN stations) never holds
    every station's observation dicts in memory at once; only the kept
    stations' (T,) float32 rows accumulate.

    Stations with fewer than ``min_obs`` values in the period are dropped
    (the reference's period-of-record screen)."""
    ymd_to_idx = {int(y): i for i, y in enumerate(days.ymd)}
    T = days.ndays

    metas: list[tuple] = []
    rows_min: list[np.ndarray] = []
    rows_max: list[np.ndarray] = []
    n_seen = 0
    for ps in parsed:
        n_seen += 1
        # a station absent from the inventory keeps NaN lon/lat/elev, which
        # would flow into haversine/top_k as NaN distances downstream —
        # drop it here (the reference's location screen, qa_location's job
        # for the subtler cases)
        if not all(np.isfinite(v) for v in (ps.lon, ps.lat, ps.elev)):
            continue
        # physically impossible coordinates (other networks' missing codes
        # like -999.9 arrive finite): screen here, like the NaN case
        if not (-90.0 <= ps.lat <= 90.0 and -180.0 <= ps.lon <= 180.0):
            continue
        rmin = np.full(T, np.nan, np.float32)
        rmax = np.full(T, np.nan, np.float32)
        n = 0
        for src, dst in ((ps.tmin, rmin), (ps.tmax, rmax)):
            for ymd, v in src.items():
                j = ymd_to_idx.get(ymd)
                if j is not None:
                    dst[j] = v
                    n += 1
        if n >= min_obs:
            metas.append(
                (ps.stn_id, ps.name, ps.state, ps.lon, ps.lat, ps.elev)
            )
            rows_min.append(rmin)
            rows_max.append(rmax)
    S = len(metas)
    if S == 0:
        raise ValueError(
            f"no stations survived screening ({n_seen} parsed: "
            "need finite+physical coordinates and >= "
            f"{min_obs} in-period observations)"
        )

    tmin = np.stack(rows_min)
    tmax = np.stack(rows_max)

    attrs = {
        C.STN_ID: np.array([m[0] for m in metas]),
        C.STN_NAME: np.array([m[1] for m in metas]),
        C.STATE: np.array([m[2] for m in metas]),
        C.LON: np.array([m[3] for m in metas], np.float64),
        C.LAT: np.array([m[4] for m in metas], np.float64),
        C.ELEV: np.array([m[5] for m in metas], np.float64),
    }
    import os

    path = pathlib.Path(path)
    tmp = path.with_suffix(path.suffix + ".tmp")
    with StationDB.create(tmp, attrs, days.date64) as db:
        db.set_obs(C.TMIN, tmin)
        db.set_obs(C.TMAX, tmax)
    os.replace(tmp, path)
    return StationDB(path, "a")
