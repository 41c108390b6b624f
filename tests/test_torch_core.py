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

REPO = pathlib.Path(__file__).resolve().parents[1]
CONFIG_CLASSES = ("InterpParams", "VariogramParams", "PPCAParams", "MeshParams", "TopoConfig")


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
