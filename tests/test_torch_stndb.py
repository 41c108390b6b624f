"""The port's station database and raw-format readers (``topotpu_torch.io``:
``stndb``, ``build_db``, ``ushcn``, ``download``) against the JAX package's.

The station DB file is the state the two packages share, so a DB written by
either opens in the other, and both write the same HDF5 content: groups,
dataset names, dtypes, shapes, chunking, compression and values (compared
exactly, NaNs in place). The parsers run the same code on the same text and
answer identically. Nothing is fetched: ``fetch`` gets a fake opener.
"""

import contextlib
import dataclasses
import io
import tarfile

import h5py
import numpy as np
import pytest

import topotpu.io.build_db as jbuild
import topotpu.io.download as jdl
import topotpu.io.stndb as jdb
import topotpu.io.ushcn as jushcn
import topotpu_torch.io.build_db as tbuild
import topotpu_torch.io.download as tdl
import topotpu_torch.io.stndb as tdb
import topotpu_torch.io.ushcn as tushcn
from topotpu.core import constants as C
from topotpu.core.dates import get_days_metadata
from topotpu_torch.core.dates import get_days_metadata as t_days

PACKAGES = {"jax": (jdb, jbuild), "port": (tdb, tbuild)}


def _h5_content(path):
    """{name: (description, value)} of every group, dataset and attribute;
    a dataset's description is its dtype, shape, chunks and compression."""
    out = {}

    def visit(name, obj):
        if isinstance(obj, h5py.Dataset):
            out[name] = ((obj.dtype.str, obj.shape, obj.chunks, obj.compression,
                          obj.compression_opts), obj[...])
        else:
            out[name] = ("group", None)
        for k, v in obj.attrs.items():
            out[f"{name}@{k}"] = ("attr", v)

    with h5py.File(path, "r") as f:
        f.visititems(visit)
        for k, v in f.attrs.items():
            out[f"@{k}"] = ("attr", v)
    return out


def _assert_same_h5(a, b):
    ca, cb = _h5_content(a), _h5_content(b)
    assert sorted(ca) == sorted(cb)
    for name, (desc, value) in ca.items():
        assert cb[name][0] == desc, name
        np.testing.assert_array_equal(np.asarray(cb[name][1]), np.asarray(value), err_msg=name)


def _station_attrs(rng, S):
    return {
        C.STN_ID: np.array(["GHCND:US1", "GHCND:US2", "SNOTEL:A", "RAWS:B", "X"])[:S],
        C.STN_NAME: np.array(["ONE", "TWO", "THREE", "FOUR", "FIVE"])[:S],
        C.LON: rng.uniform(-110, -100, S),
        C.LAT: rng.uniform(30, 45, S),
        C.ELEV: rng.uniform(0, 3000, S),
        C.LST: rng.normal(10, 5, (S, 12)).astype(np.float32),
    }


def _write_db(pkg, path, seed=0):
    db_mod, _ = PACKAGES[pkg]
    rng = np.random.default_rng(seed)
    days = get_days_metadata("2015-01-01", "2015-12-31")
    S, T = 5, days.ndays
    obs = rng.normal(size=(S, T)).astype(np.float32)
    obs[0, :10] = np.nan
    with db_mod.StationDB.create(path, _station_attrs(rng, S), days.date64) as db:
        db.set_obs(C.TMIN, obs)
        db.set_obs(C.TMAX, obs + 10.0)
        db.set_qflags(C.TMIN, (rng.uniform(size=(S, T)) < 0.05).astype(np.uint8) * 4)
        db.set_stn(C.TDI, rng.normal(size=S).astype(np.float32))
        db.set_stn(C.STATE, np.array(["CO", "WY", "MT", "ID", "UT"]))
        db.set_stn(C.TDI, rng.normal(size=S).astype(np.float32))  # replaced in place
    return days, obs


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_db_written_by_one_package_reads_in_the_other(tmp_path, writer, reader):
    days, obs = _write_db(writer, tmp_path / "w.h5")
    _write_db(reader, tmp_path / "r.h5")
    _assert_same_h5(tmp_path / "w.h5", tmp_path / "r.h5")
    mods = {p: PACKAGES[p][0] for p in PACKAGES}
    with mods[reader].StationDB(tmp_path / "w.h5") as got, \
            mods[writer].StationDB(tmp_path / "w.h5") as want:
        assert got.n_stations == want.n_stations == 5
        np.testing.assert_array_equal(got.dates, want.dates)
        assert (got.dates == days.date64).all()
        for name in want._f["stn"]:
            a, b = got.stn(name), want.stn(name)
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b)
        for var in (C.TMIN, C.TMAX):
            np.testing.assert_array_equal(got.obs(var), want.obs(var))
            np.testing.assert_array_equal(got.obs(var, [1, 3]), want.obs(var, [1, 3]))
        np.testing.assert_array_equal(got.qflags(C.TMIN), want.qflags(C.TMIN))
        np.testing.assert_array_equal(got.obs(C.TMIN), obs)


@pytest.mark.parametrize("with_vario", [True, False])
def test_write_serial_db_files_equal(tmp_path, with_vario):
    _write_db("jax", tmp_path / "src.h5")
    rng = np.random.default_rng(5)
    S = 5
    filled = rng.normal(size=(S, 365)).astype(np.float64)
    norms = rng.normal(size=(S, 12))
    bad = np.array([True, False, False, True, False])
    vario = rng.uniform(0.1, 2, size=(S, 12, 3)) if with_vario else None
    for pkg in PACKAGES:
        db_mod, _ = PACKAGES[pkg]
        with db_mod.StationDB(tmp_path / "src.h5") as src:
            db_mod.write_serial_db(tmp_path / f"serial_{pkg}.h5", src, C.TMIN, filled,
                                   norms, bad, vario)
        assert not (tmp_path / f"serial_{pkg}.h5.tmp").exists()
    _assert_same_h5(tmp_path / "serial_jax.h5", tmp_path / "serial_port.h5")


def _dly_line(sid, year, month, elem, values, qflags=None):
    """One fixed-width .dly line (``tests/test_build_db.py``'s helper);
    values in tenths C, None = missing."""
    line = f"{sid:<11}{year:04d}{month:02d}{elem:<4}"
    for d in range(31):
        v = values[d] if d < len(values) and values[d] is not None else -9999
        q = (qflags or {}).get(d, " ")
        line += f"{v:5d} {q} "
    return line


SID = "USC00012345"
INV = {SID: {"lat": 40.0, "lon": -103.0, "elev": 1000.0, "state": "CO", "name": "A"}}


def _year_text(sid=SID, year=2015, base=5):
    vals = [int(10 * (base + np.sin(d / 10.0))) for d in range(31)]
    lines = []
    for m in range(1, 13):
        lines.append(_dly_line(sid, year, m, "TMIN", vals, qflags={3: "X"}))
        lines.append(_dly_line(sid, year, m, "TMAX", [v + 100 for v in vals]))
        lines.append(_dly_line(sid, year, m, "PRCP", vals))
    return "\n".join(lines)


DLY_TEXTS = {
    "year": (_year_text(), None),
    "flags_and_missing": (
        "\n".join([_dly_line(SID, 2015, 1, "TMIN", [15, -52, None, 100], qflags={3: "X"}),
                   _dly_line(SID, 2015, 1, "TMAX", [105, 88])]), None),
    "impossible_dates": (
        "\n".join(_dly_line(SID, y, m, "TMIN", [10] * 31)
                  for y, m in ((2015, 2), (2016, 2), (2015, 4))), None),
    "duplicates_last_wins": (
        "\n".join([_dly_line(SID, 2015, 1, "TMIN", [11]), _dly_line(SID, 2015, 1, "TMIN", [22])]),
        None),
    "select_station": (_year_text() + "\n" + _year_text("USW00099999", base=8), "USW00099999"),
    "garbage": ("\x00garbage\nTMIN 2015\n" + _dly_line(SID, 2015, 1, "TMIN", [15])[:100], "X"),
}


def _same_station(got, want):
    assert dataclasses.asdict(got).keys() == dataclasses.asdict(want).keys()
    for k, v in dataclasses.asdict(want).items():
        g = getattr(got, k)
        if isinstance(v, float) and np.isnan(v):
            assert np.isnan(g), k
        else:
            assert g == v, k


@pytest.mark.parametrize("case", sorted(DLY_TEXTS))
@pytest.mark.parametrize("inventory", [INV, {}])
def test_parse_dly_matches_jax(case, inventory):
    text, sid = DLY_TEXTS[case]
    _same_station(tbuild.InsertGhcn(inventory).parse_dly(text, sid),
                  jbuild.InsertGhcn(inventory).parse_dly(text, sid))


def test_parse_dly_refuses_two_stations_like_jax():
    text = _year_text() + "\n" + _year_text("USW00099999")
    with pytest.raises(ValueError) as want:
        jbuild.InsertGhcn(INV).parse_dly(text)
    with pytest.raises(ValueError) as got:
        tbuild.InsertGhcn(INV).parse_dly(text)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("text", [
    "USC00012345  40.1000 -103.5000 1500.0 CO TEST STATION NAME              ",
    "USC00012345  40.1000 -103.5000 -999.9 CO OLD SITE                      \n"
    "USC00012345  40.9000 -104.0000 1600.0 CO NEW SITE                      ",
    "USC00012345  4x.1000 -103.5000 1500.0 CO BAD LAT                       \nshort",
])
def test_parse_ghcnd_stations_matches_jax(text):
    got, want = tbuild.parse_ghcnd_stations(text), jbuild.parse_ghcnd_stations(text)
    assert list(got) == list(want)
    for sid in want:
        for k, v in want[sid].items():
            assert (np.isnan(got[sid][k]) and np.isnan(v)) if isinstance(v, float) and \
                np.isnan(v) else got[sid][k] == v


DELIMITED = (
    "Date,TMIN,TMAX\n2015-06-01,32.0,77.0\n2015-06-02,-99.9,50.0\nbadline\n"
    "2015-02-30,32.0,50.0\n2015-06-03,M,77.0\n2015-06-04,NA,NaN\n2015-06-05,41.0,59.0\n"
    "not-a-date,1,2\n2015-06-06;1;2\n"
)


@pytest.mark.parametrize("cls,kw", [("InsertSnotel", {}), ("InsertRaws", {}),
                                    ("InsertDelimited", {}),
                                    ("InsertDelimited", dict(sep=";", unit="F"))])
def test_delimited_parsers_match_jax(cls, kw):
    meta = dict(lat=43.0, lon=-110.0, elev=2500.0)
    got = getattr(tbuild, cls)(**kw).parse(DELIMITED, "SNOTEL:301", **meta)
    want = getattr(jbuild, cls)(**kw).parse(DELIMITED, "SNOTEL:301", **meta)
    _same_station(got, want)


def _tar(path, members, gz=True):
    with tarfile.open(path, "w:gz" if gz else "w") as tf:
        for name, text in members.items():
            data = text.encode()
            ti = tarfile.TarInfo(name)
            ti.size = len(data)
            tf.addfile(ti, io.BytesIO(data))
    return path


def _ghcn_archive(tmp_path, gz=True):
    sids = ["USC00012345", "USW00099999", "USC00054321"]
    inv = {s: {"lat": 39.0 + i, "lon": -104.0 - i, "elev": 1200.0 + i, "state": "CO",
               "name": f"S{i}"} for i, s in enumerate(sids)}
    inv["USW00031313"] = {"lat": 41.0, "lon": -100.0, "elev": 900.0}
    members = {f"ghcnd_all/{s}.dly": _year_text(s, base=3 + i) for i, s in enumerate(sids)}
    members["ghcnd_all/readme.txt"] = "not a dly"
    name = "ghcnd_all.tar.gz" if gz else "ghcnd_all.tar"
    return _tar(tmp_path / name, members, gz), inv


@pytest.mark.parametrize("gz", [True, False])
def test_iter_ghcnd_tar_matches_jax(tmp_path, gz):
    path, inv = _ghcn_archive(tmp_path, gz)
    rep_t, rep_j = {}, {}
    got = list(tbuild.iter_ghcnd_tar(path, inv, report=rep_t))
    want = list(jbuild.iter_ghcnd_tar(path, inv, report=rep_j))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        _same_station(g, w)
    assert rep_t == rep_j and rep_t["missing_from_archive"] == ["USW00031313"]


def test_iter_ghcnd_tar_truncated_raises_like_jax(tmp_path):
    path, inv = _ghcn_archive(tmp_path)
    cut = tmp_path / "cut.tar.gz"
    cut.write_bytes(path.read_bytes()[: int(path.stat().st_size * 0.6)])
    msgs = []
    for mod in (jbuild, tbuild):
        with pytest.raises(RuntimeError, match="truncated or corrupt") as e:
            list(mod.iter_ghcnd_tar(cut, inv))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("min_obs", [30, 700])
def test_build_station_db_matches_jax(tmp_path, min_obs):
    """The .dly fixtures of ``tests/test_build_db.py`` (a full year, a sparse
    station, an orphan without coordinates, impossible coordinates), parsed
    and built by each package: identical ParsedStations and DB files."""
    days = get_days_metadata("2015-01-01", "2015-12-31")
    assert (t_days("2015-01-01", "2015-12-31").ymd == days.ymd).all()
    texts = {
        SID: (_year_text(), INV),
        "USC00000001": (_dly_line("USC00000001", 2015, 1, "TMIN", [11]),
                        {"USC00000001": INV[SID]}),
        "USC00099999": (_year_text("USC00099999", base=7), {}),
        "USC00077777": (_year_text("USC00077777", base=2),
                        {"USC00077777": dict(INV[SID], lat=-999.9)}),
        "USW00022222": (_year_text("USW00022222", base=9),
                        {"USW00022222": dict(INV[SID], lon=-104.5)}),
    }
    parsed = {}
    for pkg, (_, build) in PACKAGES.items():
        parsed[pkg] = [build.InsertGhcn(inv).parse_dly(text) for text, inv in texts.values()]
    for g, w in zip(parsed["port"], parsed["jax"]):
        _same_station(g, w)
    for pkg, (db_mod, build) in PACKAGES.items():
        path = tmp_path / f"all_obs_{pkg}.h5"
        with build.build_station_db(path, iter(parsed[pkg]), days, min_obs=min_obs) as db:
            assert isinstance(db, db_mod.StationDB)
            assert db.n_stations == 2  # the sparse, orphan and off-globe stations go
        assert not path.with_suffix(".h5.tmp").exists()
    _assert_same_h5(tmp_path / "all_obs_jax.h5", tmp_path / "all_obs_port.h5")


def test_build_station_db_refuses_like_jax(tmp_path):
    days = get_days_metadata("2015-01-01", "2015-12-31")
    orphan = jbuild.InsertGhcn({}).parse_dly(_year_text())
    msgs = []
    for pkg, (_, build) in PACKAGES.items():
        with pytest.raises(ValueError, match="no stations survived") as e:
            build.build_station_db(tmp_path / f"o_{pkg}.h5", [orphan], days)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def _ushcn_line(sid, year, vals, dm=()):
    return f"{sid} {year:4d}" + "".join(
        f"{v:6d}{'E' if m in dm else ' '}  " for m, v in enumerate(vals))


USHCN_TEXT = "\n".join([
    _ushcn_line("USH00011084", 2010, [500 + m for m in range(12)], dm=(2, 7)),
    _ushcn_line("USH00011084", 2011, [-9999] * 12),
    _ushcn_line("USH00011084", 2009, [480 - m for m in range(12)]),
    _ushcn_line("USH00022222", 2011, [-300 + m for m in range(12)]),
    "USH00033333 20x0" + " " * 120,
    "short",
])


@pytest.mark.parametrize("kw", [{}, dict(drop_estimated=True), dict(scale=0.1)])
def test_ushcn_parsers_match_jax(tmp_path, kw):
    got, want = tushcn.parse_ushcn_monthly(USHCN_TEXT, **kw), \
        jushcn.parse_ushcn_monthly(USHCN_TEXT, **kw)
    assert list(got) == list(want)
    for sid in want:
        np.testing.assert_array_equal(got[sid]["years"], want[sid]["years"])
        np.testing.assert_array_equal(got[sid]["values"], want[sid]["values"])
    path = _tar(tmp_path / "ushcn.tmax.latest.FLs.52i.tar.gz", {
        "ushcn.v2.5/USH00011084.FLs.52i.tmax": USHCN_TEXT.split("\n", 3)[0],
        "ushcn.v2.5/USH00022222.FLs.52i.tmax": USHCN_TEXT.split("\n")[3],
        "ushcn.v2.5/readme.txt": "hey",
    })
    g, w = dict(tushcn.iter_ushcn_tar(path, **kw)), dict(jushcn.iter_ushcn_tar(path, **kw))
    assert list(g) == list(w)
    for sid in w:
        np.testing.assert_array_equal(g[sid]["values"], w[sid]["values"])


@pytest.mark.parametrize("sid,years", [("USH00011084", [2009, 2010, 2011]),
                                       ("USH00011084", [1999]), ("NOPE", [2010]),
                                       ("USH00022222", [2011, 2012])])
def test_compare_adjustments_matches_jax(sid, years):
    ushcn = jushcn.parse_ushcn_monthly(USHCN_TEXT)
    ours = np.random.default_rng(1).normal(5.0, 1.0, (len(years), 12))
    a = tushcn.compare_adjustments(ours, np.array(years), ushcn, sid)
    b = jushcn.compare_adjustments(ours, np.array(years), ushcn, sid)
    assert (np.isnan(a) and np.isnan(b)) or a == b


def test_fetch_and_urls_match_jax(tmp_path):
    assert tdl.ghcnd_station_url(SID) == jdl.ghcnd_station_url(SID)
    for elem in ("tmax", "tmin", "tavg"):
        assert tdl.ushcn_tar_url(elem=elem) == jdl.ushcn_tar_url(elem=elem)
    for name in ("GHCND_ALL_TAR", "GHCND_STATIONS", "GHCND_INVENTORY", "SNOTEL_AWDB",
                 "RAWS_WRCC", "USHCN_BASE"):
        assert getattr(tdl, name) == getattr(jdl, name)
    url = tdl.ghcnd_station_url(SID)
    msgs = []
    for mod in (jdl, tdl):
        with pytest.raises(mod.DownloadUnavailable) as e:
            mod.fetch(url, tmp_path / "x.dly")
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    assert issubclass(tdl.DownloadUnavailable, RuntimeError)
    assert not (tmp_path / "x.dly").exists()

    payload = bytes(range(256)) * 1000
    opened = []

    @contextlib.contextmanager
    def opener(u):
        opened.append(u)
        yield io.BytesIO(payload)

    for mod in (jdl, tdl):
        out = mod.fetch(url, tmp_path / mod.__name__ / "x.dly", opener=opener, chunk=1000)
        assert out.read_bytes() == payload
        assert not out.with_suffix(".dly.part").exists()
    assert opened == [url, url]
