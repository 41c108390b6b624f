"""The port's own copies of the JAX-free modules answer exactly as the JAX
package's: configuration dataclasses, dates, grids, the synthetic world, the
float64 oracles and the C++ SNHT core. Every comparison here is exact
(``array_equal`` / ``==``): the copies run the same numpy code."""

import dataclasses
import pathlib

import numpy as np
import pytest

import topotpu.core.config as jcfg
import topotpu.core.dates as jdates
import topotpu.core.grid as jgrid
import topotpu.homog.pha as jpha
import topotpu.io.synthetic as jsyn
import topotpu.oracle.numpy_ref as jref
import topotpu.oracle.pipeline as jpipe
import topotpu_torch.core.config as tcfg
import topotpu_torch.core.dates as tdates
import topotpu_torch.core.grid as tgrid
import topotpu_torch.homog.pha as tpha
import topotpu_torch.io.synthetic as tsyn
import topotpu_torch.oracle.numpy_ref as tref
import topotpu_torch.oracle.pipeline as tpipe
from jax_pha_core import load_jax_pha

REPO = pathlib.Path(__file__).resolve().parents[1]
CONFIG_CLASSES = ("InterpParams", "VariogramParams", "PPCAParams", "MeshParams", "TopoConfig")


@pytest.fixture(autouse=True, scope="module")
def _jax_snht_core():
    """The JAX package's C++ core, built and loaded safely under xdist."""
    load_jax_pha()


@pytest.mark.parametrize("name", CONFIG_CLASSES)
def test_config_dataclass_matches_jax_package(name):
    ours, theirs = getattr(tcfg, name), getattr(jcfg, name)
    assert [f.name for f in dataclasses.fields(ours)] == \
        [f.name for f in dataclasses.fields(theirs)]
    assert dataclasses.asdict(ours()) == dataclasses.asdict(theirs())


@pytest.mark.parametrize("path", sorted(p.name for p in (REPO / "configs").glob("*.json")))
def test_config_file_loads_the_same_in_both(path):
    ours = tcfg.TopoConfig.load(REPO / "configs" / path)
    theirs = jcfg.TopoConfig.load(REPO / "configs" / path)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    # a config written by either package loads in the other
    assert dataclasses.asdict(jcfg.TopoConfig.from_json(ours.to_json())) == \
        dataclasses.asdict(theirs)
    assert dataclasses.asdict(tcfg.TopoConfig.from_json(theirs.to_json())) == \
        dataclasses.asdict(ours)


def test_config3_infill_ppca_settings():
    cfg = tcfg.TopoConfig.load(REPO / "configs" / "config3_infill.json")
    assert (cfg.ppca.n_components, cfg.ppca.n_neighbors, cfg.ppca.max_iters) == (12, 24, 200)
    assert cfg.interp == tcfg.InterpParams(k_per_var=None)


def test_interp_params_tuples_roundtrip():
    cfg = tcfg.TopoConfig(interp=tcfg.InterpParams(k_per_var=(16, 32), ka_per_var=(8, 16)))
    back = jcfg.TopoConfig.from_json(cfg.to_json())
    assert back.interp.k_per_var == (16, 32) and back.interp.ka_per_var == (8, 16)
    assert dataclasses.asdict(back) == dataclasses.asdict(cfg)


@pytest.mark.parametrize("span", [("2015-01-01", "2015-12-31"), ("1999-11-20", "2004-03-02")])
def test_get_days_metadata_equal(span):
    ours, theirs = tdates.get_days_metadata(*span), jdates.get_days_metadata(*span)
    assert ours.ndays == theirs.ndays
    for f in dataclasses.fields(theirs):
        a, b = getattr(ours, f.name), getattr(theirs, f.name)
        assert a.dtype == b.dtype, f.name
        np.testing.assert_array_equal(a, b, err_msg=f.name)
    assert tdates.ymd_to_date64(20040229) == jdates.ymd_to_date64(20040229)


def test_grid_spec_equal():
    kw = dict(lon0=-105.9, lat0=40.9, cellsize=1.0 / 120.0, nrows=37, ncols=53)
    ours, theirs = tgrid.GridSpec(**kw), jgrid.GridSpec(**kw)
    rows, cols = np.arange(0, 37, 5), np.arange(0, 49, 7)
    for a, b in zip(ours.cell_lonlat(rows, cols), theirs.cell_lonlat(rows, cols)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(ours.lonlat_grids(), theirs.lonlat_grids()):
        np.testing.assert_array_equal(a, b)
    assert tgrid.CELLSIZE_30ARCSEC == jgrid.CELLSIZE_30ARCSEC
    assert tgrid.CONUS_BOUNDS == jgrid.CONUS_BOUNDS


@pytest.mark.parametrize("seed,kw", [
    (0, dict(nrows=24, ncols=30, n_stations=40, ndays=60)),
    (11, dict(nrows=32, ncols=32, n_stations=50, ndays=45, ocean_frac=0.2,
              cellsize=1.0 / 30.0, vario=(0.1, 2.0, 25.0))),
])
def test_make_world_equal_array_for_array(seed, kw):
    ours = tsyn.make_world(np.random.default_rng(seed), **kw)
    theirs = jsyn.make_world(np.random.default_rng(seed), **kw)
    names = [f.name for f in dataclasses.fields(theirs)]
    assert names == [f.name for f in dataclasses.fields(ours)]
    for name in names:
        a, b = getattr(ours, name), getattr(theirs, name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)
        elif name == "grid":
            assert dataclasses.asdict(a) == dataclasses.asdict(b)
        elif not callable(b):
            assert a == b, name
    lon, lat = ours.grid.cell_lonlat(np.array([1, 5, 9]), np.array([2, 6, 20]))
    np.testing.assert_array_equal(ours.resid_field_fn(lon, lat), theirs.resid_field_fn(lon, lat))
    np.testing.assert_array_equal(ours.anom_field_fn(lon, lat), theirs.anom_field_fn(lon, lat))
    np.testing.assert_array_equal(
        ours.true_normal(lon, lat, np.full(3, 2000.0), np.zeros(3), np.full(3, 9.0), 7),
        theirs.true_normal(lon, lat, np.full(3, 2000.0), np.zeros(3), np.full(3, 9.0), 7))
    assert ours.n_stations == theirs.n_stations


def _oracle_inputs(seed, k=12):
    rng = np.random.default_rng(seed)
    lon, lat = rng.uniform(-106, -104, k), rng.uniform(39, 41, k)
    dp = jref.haversine_km(lon[:, None], lat[:, None], lon[None], lat[None])
    d0 = jref.haversine_km(-105.0, 40.0, lon, lat)
    return rng, lon, lat, dp, d0


@pytest.mark.parametrize("seed", [0, 1])
def test_numpy_ref_functions_equal(seed):
    rng, lon, lat, dp, d0 = _oracle_inputs(seed)
    k = len(lon)
    np.testing.assert_array_equal(
        tref.haversine_km(lon[:, None], lat[:, None], lon[None], lat[None]), dp)
    assert tref.EARTH_RADIUS_KM == jref.EARTH_RADIUS_KM
    X = np.concatenate([np.ones((k, 1)), rng.normal(size=(k, 3))], 1)
    y, w = rng.normal(size=k), rng.uniform(0, 1, k) * (rng.uniform(size=k) > 0.2)
    np.testing.assert_array_equal(tref.wls_lstsq(X, y, w), jref.wls_lstsq(X, y, w))
    np.testing.assert_array_equal(tref.exp_cov(dp, 0.1, 1.0, 40.0), jref.exp_cov(dp, 0.1, 1.0, 40.0))
    got = tref.ok_krige_augmented(dp, d0, y, 0.05, 1.0, 40.0, jitter_frac=1e-5)
    want = jref.ok_krige_augmented(dp, d0, y, 0.05, 1.0, 40.0, jitter_frac=1e-5)
    assert got[:2] == want[:2]
    np.testing.assert_array_equal(got[2], want[2])
    cutoff = 0.5 * dp.max()
    emp_o = tref.empirical_variogram_loops(dp, y, 6, cutoff)
    emp_j = jref.empirical_variogram_loops(dp, y, 6, cutoff)
    for a, b in zip(emp_o, emp_j):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tref.fit_exp_scipy(*emp_o), jref.fit_exp_scipy(*emp_j))
    assert tref.gwr_point(X[:, 1:], np.zeros(3), w, y) == jref.gwr_point(X[:, 1:], np.zeros(3), w, y)


@pytest.mark.parametrize("seed", [0, 1])
def test_pipeline_oracle_functions_equal(seed):
    rng, lon, lat, dp, d0 = _oracle_inputs(seed, k=40)
    k = len(lon)
    np.testing.assert_array_equal(tpipe.bisquare_weights(d0), jpipe.bisquare_weights(d0))
    cov, cov_pt = rng.normal(size=(k, 3)), rng.normal(size=3)
    w = jpipe.bisquare_weights(d0)
    got, want = tpipe.centered_wls_gain(cov, cov_pt, w), jpipe.centered_wls_gain(cov, cov_pt, w)
    np.testing.assert_array_equal(got[0], want[0])
    norm = rng.normal(size=k)
    vario = np.tile([0.05, 1.0, 40.0], (k, 1))
    args = (-105.0, 40.0, cov_pt, rng.normal(size=3), lon, lat, cov, rng.normal(size=(k, 3)),
            norm, vario, 16)
    got, want = tpipe.interp_cell_month(*args), jpipe.interp_cell_month(*args)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_interp_tile_oracle_equal_on_a_world():
    world = tsyn.make_world(np.random.default_rng(3), nrows=16, ncols=16, n_stations=30, ndays=40)
    days = tdates.get_days_metadata("2015-01-01", "2015-02-09")
    vario = np.tile(np.asarray(world.true_vario, np.float64), (30, 12, 1))
    cells = [(2, 3), (10, 12)]
    got = tpipe.interp_tile_oracle(world, cells, 8, vario, days.month_idx)
    want = jpipe.interp_tile_oracle(world, cells, 8, vario, days.month_idx)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_detect_breaks_and_monthly_means_equal_on_a_planted_series():
    days = tdates.get_days_metadata("2001-01-01", "2012-12-31")
    rng = np.random.default_rng(4)
    daily = rng.normal(size=(5, days.ndays)).astype(np.float32)
    daily[1, 2000:] += 3.0           # one planted step
    daily[2, 1500:3000] -= 2.5       # two
    daily[3, 100:900] = np.nan       # a gap: sparse months come out NaN
    for min_days in (1, 20):
        got = tpha.monthly_means(daily, days.year, days.month, min_days=min_days)
        want = jpha.monthly_means(daily, days.year, days.month, min_days=min_days)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    monthly = got[0]
    anom = monthly - np.nanmean(monthly, axis=1, keepdims=True)
    for minseg in (12, 24):
        b_o, s_o = tpha.detect_breaks(anom, minseg=minseg)
        b_j, s_j = jpha.detect_breaks(anom, minseg=minseg)
        np.testing.assert_array_equal(b_o, b_j)
        # stats beyond the found breaks are unwritten memory in both
        np.testing.assert_array_equal(s_o[b_o >= 0], s_j[b_j >= 0])
    assert (b_o[1] >= 0).sum() >= 1 and (b_o[2] >= 0).sum() >= 2 and (b_o[0] >= 0).sum() == 0


def test_status_check_prints_the_same_lines(capsys):
    import io

    import topotpu.utils.status as jstatus
    import topotpu_torch.utils.status as tstatus

    lines = []
    for mod in (jstatus, tstatus):
        out = io.StringIO()
        st = mod.StatusCheck(total=6, unit="tiles", every=2, items_per=100, out=out)
        st.t0 -= 10.0  # a fixed elapsed time makes the rates comparable
        for _ in range(6):
            st.tick()
        lines.append([ln.rsplit(",", 2)[0] for ln in out.getvalue().splitlines()])
        assert st.count == 6 and st.elapsed >= 10.0
        mod.StatusCheck(total=1, enabled=False).tick()
    assert lines[0] == lines[1] and len(lines[0]) == 3
    assert capsys.readouterr().err == ""


def _world_rasters(seed):
    world = tsyn.make_world(np.random.default_rng(seed), nrows=20, ncols=26, n_stations=10,
                            ndays=5, ocean_frac=0.2)
    import topotpu.io.rasters as jras
    import topotpu_torch.io.rasters as tras

    return world, jras.RasterStack.from_world(world), tras.RasterStack.from_world(world)


def test_raster_stack_equal_and_files_load_in_both(tmp_path):
    import topotpu.io.rasters as jras
    import topotpu_torch.io.rasters as tras

    _, theirs, ours = _world_rasters(5)
    for a, b in zip(ours.tile_view(4, 7, 9, 11), theirs.tile_view(4, 7, 9, 11)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    ours.save(tmp_path / "ours.h5")
    theirs.save(tmp_path / "theirs.h5")
    for path in ("ours.h5", "theirs.h5"):
        x, y = tras.RasterStack.load(tmp_path / path), jras.RasterStack.load(tmp_path / path)
        assert dataclasses.asdict(x.grid) == dataclasses.asdict(y.grid)
        for name in ("elev", "tdi", "lst", "landmask"):
            np.testing.assert_array_equal(getattr(x, name), getattr(y, name))
            np.testing.assert_array_equal(getattr(x, name), getattr(ours, name))


def _h5_tree(path):
    import h5py

    out = {}
    with h5py.File(path) as f:
        out["/"] = {k: np.asarray(v).tolist() for k, v in f.attrs.items()}
        for name, ds in f.items():
            attrs = {k: np.asarray(v).tolist() for k, v in ds.attrs.items()
                     if k not in ("DIMENSION_LIST", "REFERENCE_LIST")}
            out[name] = (ds[...], attrs, ds.dtype.str, ds.fletcher32, ds.chunks)
    return out


def _trees_equal(a, b):
    assert sorted(a) == sorted(b)
    for name in a:
        if name == "/":
            assert a[name] == b[name]
            continue
        np.testing.assert_array_equal(a[name][0], b[name][0], err_msg=name)
        assert a[name][1:] == b[name][1:], name


@pytest.mark.parametrize("pack", [True, False])
def test_tile_writer_writes_the_same_file(tmp_path, pack):
    import topotpu.io.ncdf as jnc
    import topotpu_torch.io.ncdf as tnc

    world, _, _ = _world_rasters(6)
    days = tdates.get_days_metadata("2015-02-26", "2015-03-03")
    sub = world.grid.subgrid(3, 4, 8, 9)
    rng = np.random.default_rng(0)
    daily = rng.normal(5, 3, (days.ndays, 8, 9)).astype(np.float32)
    daily[:, 2, 3] = np.nan
    monthly = rng.normal(0, 1, (12, 8, 9)).astype(np.float32)
    monthly[4, 1, 1] = np.nan
    q = rng.integers(-30000, 30000, (days.ndays, 8, 9)).astype(np.int16)
    for mod, name in ((jnc, "theirs.h5"), (tnc, "ours.h5")):
        with mod.TileWriter(tmp_path / name, sub, days.date64, pack=pack, compress=1) as w:
            w.write_daily("tmin", daily, long_name="daily tmin")
            w.write_monthly("tmin_normal", monthly)
            w.write_daily_prepacked("q", q, 0.01, 2.0)
            w.write_monthly_prepacked("qm", np.resize(q, (12, 8, 9)), 0.02, -1.0)
    _trees_equal(_h5_tree(tmp_path / "ours.h5"), _h5_tree(tmp_path / "theirs.h5"))
    for var in ("tmin", "tmin_normal", "q", "qm"):
        np.testing.assert_array_equal(tnc.read_var(tmp_path / "theirs.h5", var),
                                      jnc.read_var(tmp_path / "theirs.h5", var))
    assert tnc.FILL_I16 == jnc.FILL_I16 and tnc.FILL_F32 == jnc.FILL_F32
    for valid in (None, np.isfinite(daily) & (daily > 0)):
        for a, b in zip(tnc._pack_int16(daily, valid), jnc._pack_int16(daily, valid)):
            np.testing.assert_array_equal(a, b)


def test_mosaic_writer_writes_resumes_and_reads_the_same(tmp_path):
    import h5py

    import topotpu.io.ncdf as jnc
    import topotpu_torch.io.ncdf as tnc

    world, _, _ = _world_rasters(7)
    days = tdates.get_days_metadata("2015-12-30", "2016-01-04")
    rng = np.random.default_rng(1)
    block = rng.integers(-20000, 20000, (3, 8, 10)).astype(np.int16)
    normal = rng.normal(0, 1, (12, 8, 10)).astype(np.float32)
    normal[:, 0, 0] = np.nan
    for mod, name in ((jnc, "theirs.h5"), (tnc, "ours.h5")):
        w = mod.MosaicWriter(tmp_path / name, "tmax", world.grid, days.date64, 2.4e-3, -10.0,
                             8, 10)
        assert w.fresh
        w.write_tile(8, 10, block, normal, normal * 0.1, t0=2)
        w.write_tile(0, 0, block[:2], None, None, t0=4)
        back = w.read_tile_raw(8, 10, 8, 10, t0=2, nt=3)
        np.testing.assert_array_equal(back, block)
        nb, sb = w.read_monthly_back(8, 10, 8, 10)
        np.testing.assert_array_equal(nb, normal)
        w.finalize(4, reconciled=True)
        w.close()
        again = mod.MosaicWriter(tmp_path / name, "tmax", world.grid, days.date64, 2.4e-3,
                                 -10.0, 8, 10)
        assert not again.fresh  # same shape and lattice: resumed, attrs cleared
        again.close()
        with h5py.File(tmp_path / name) as f:
            assert "complete" not in f.attrs and "reconciled" not in f.attrs
        moved = mod.MosaicWriter(tmp_path / name, "tmax", world.grid, days.date64, 2.5e-3,
                                 -10.0, 8, 10)
        assert moved.fresh  # another lattice: rebuilt
        moved.write_tile(8, 10, block, normal, normal * 0.1, t0=2)
        moved.finalize(1, reconciled=False, process_index=0, process_count=1)
        moved.close()
    _trees_equal(_h5_tree(tmp_path / "ours.h5"), _h5_tree(tmp_path / "theirs.h5"))
    with h5py.File(tmp_path / "theirs.h5") as f:
        for sl in (Ellipsis, (slice(1, 4), slice(8, 12))):
            np.testing.assert_array_equal(tnc.read_slice(f["tmax"], sl),
                                          jnc.read_slice(f["tmax"], sl))
        raw = f["tmax"][2:5]
        np.testing.assert_array_equal(tnc.decode_array(raw, f["tmax"]),
                                      jnc.decode_array(raw, f["tmax"]))
    for var in ("tmax", "normal", "se"):
        np.testing.assert_array_equal(tnc.read_var(tmp_path / "ours.h5", var),
                                      jnc.read_var(tmp_path / "theirs.h5", var))
    (tmp_path / "junk.h5").write_bytes(b"\x00" * 64)  # a corrupt file starts fresh
    w = tnc.MosaicWriter(tmp_path / "junk.h5", "tmax", world.grid, days.date64, 2.4e-3, -10.0,
                         8, 10)
    assert w.fresh
    w.close()


def test_multihost_context_equal():
    import topotpu.dist.multihost as jmh
    import topotpu_torch.dist.multihost as tmh

    for idx, count in ((0, 1), (1, 3), (2, 3)):
        ours, theirs = tmh.MultihostContext(idx, count), jmh.MultihostContext(idx, count)
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
        assert ours.manifest_name() == theirs.manifest_name()
        assert ours.is_coordinator == theirs.is_coordinator
        assert [ours.owns_tile(t) for t in range(7)] == [theirs.owns_tile(t) for t in range(7)]
