"""The port's station QA (``topotpu_torch.qa``) against the JAX package's on
the same seeded numpy inputs: ``tests/test_qa.py``'s network and cases, and
one network with every fault class planted. Both packages run the same numpy
and scipy code, so flags are compared bit for bit (``array_equal`` on the
uint8 codes) and the location checks exactly."""

import numpy as np
import pytest

import topotpu.qa.qa_location as jloc
import topotpu.qa.qa_temp as jqa
import topotpu_torch.qa.qa_location as tloc
import topotpu_torch.qa.qa_temp as tqa
from topotpu.core import constants as C
from topotpu.core.dates import get_days_metadata
from topotpu.io.rasters import RasterStack as JRasterStack
from topotpu.io.synthetic import make_world
from topotpu_torch.io.rasters import RasterStack as TRasterStack
from topotpu_torch.io.synthetic import make_world as t_make_world


def _network(seed, side, n_stations, start, end):
    """tmin and tmax built as ``tests/test_qa.py`` builds them."""
    days = get_days_metadata(start, end)
    rng = np.random.default_rng(seed)
    world = make_world(rng, nrows=side, ncols=side, n_stations=n_stations, ndays=days.ndays)
    S = world.n_stations
    tmin = (world.stn_norm[np.arange(S)[:, None], days.month_idx[None, :]]
            + world.stn_anoms).astype(np.float32)
    tmax = tmin + 10.0 + 1.5 * rng.standard_normal(tmin.shape).astype(np.float32)
    return world, days, tmin, tmax


@pytest.fixture(scope="module")
def network():
    return _network(13, 40, 30, "2012-01-01", "2015-12-31")


def _plant_test_qa(days, tmin, tmax):
    """The defects ``tests/test_qa.py::test_planted_defects_caught`` plants."""
    tmin[0, 100] = 99.0
    tmax[1, 200] = -120.0
    tmin[2, 300:330] = 5.0
    tmin[3, 400] = tmax[3, 400] + 5.0
    tmax[4, 500] += 30.0
    y13 = days.year == 2013
    slot = (days.month - 1) * 31 + (days.day - 1)
    src_of_slot = {slot[i]: i for i in np.flatnonzero(days.year == 2012)}
    for i in np.flatnonzero(y13):
        tmin[5, i] = tmin[5, src_of_slot[slot[i]]]


def _plant_every_fault(days, tmin, tmax):
    """One station (or station pair) per fault class of ``qa_temp``; returns
    {name: (variable, station, day index array)} of what was planted."""
    month = (days.year == 2013) & (days.month == 5)
    m_idx = np.flatnonzero(month)
    jun = np.flatnonzero((days.year == 2014) & (days.month == 6))
    jul12 = np.flatnonzero((days.year == 2012) & (days.month == 7))
    jul14 = np.flatnonzero((days.year == 2014) & (days.month == 7))
    planted = {}
    tmin[0, 100] = 99.0
    planted["world_record"] = ("tmin", 0, np.array([100]))
    tmin[2, 300:330] = 5.0
    planted["streak"] = ("tmin", 2, np.arange(300, 330))
    tmin[3, 400] = tmax[3, 400] + 5.0
    planted["internal"] = ("tmin", 3, np.array([400]))
    tmax[4, 500] += 30.0
    planted["spike"] = ("tmax", 4, np.array([500]))
    slot = (days.month - 1) * 31 + (days.day - 1)
    src = {slot[i]: i for i in np.flatnonzero(days.year == 2012)}
    y13 = np.flatnonzero(days.year == 2013)
    tmax[5, y13] = tmax[5, [src[slot[i]] for i in y13]]
    planted["dup_year"] = ("tmax", 5, y13)
    tmin[6, jul14] = tmin[6, jul12]
    planted["dup_month"] = ("tmin", 6, jul14)
    tmax[7, m_idx] = tmin[7, m_idx]
    planted["tmax_dup_tmin"] = ("tmax", 7, m_idx)
    tmax[8, jun] = tmin[8, jun] - 20.0
    planted["mega"] = ("tmax", 8, jun)
    tmin[9, 700] -= 30.0
    planted["dip"] = ("tmin", 9, np.array([700]))
    # three days far off the month's distribution (no spike: the middle day
    # has equal neighbours); the gap check takes them before the clim check
    tmax[10, 800:803] += 40.0
    planted["excursion"] = ("tmax", 10, np.arange(800, 803))
    return planted


@pytest.fixture(scope="module")
def every_fault():
    world, days, tmin, tmax = _network(21, 48, 60, "2010-01-01", "2015-12-31")
    tmin, tmax = tmin.copy(), tmax.copy()
    planted = _plant_every_fault(days, tmin, tmax)
    return world, days, tmin, tmax, planted


SINGLE = ["check_world_records", "check_streaks", "check_spike_dip"]
WITH_DAYS = ["check_duplicate_years", "check_duplicate_months", "check_gap",
             "check_clim_outlier"]
PAIRED = ["check_internal_consistency"]
PAIRED_DAYS = ["check_tmax_dup_tmin", "check_mega_consistency"]


def _run_check(mod, name, days, tmin, tmax, prior):
    """Run one check from flags ``prior`` (the sticky-worst order matters)."""
    ft, fx = prior[0].copy(), prior[1].copy()
    fn = getattr(mod, name)
    if name in SINGLE:
        fn(tmin, ft)
        fn(tmax, fx)
    elif name in WITH_DAYS:
        fn(tmin, ft, days)
        fn(tmax, fx, days)
    elif name in PAIRED:
        fn(tmax, tmin, fx, ft)
    else:
        fn(tmax, tmin, fx, ft, days)
    return ft, fx


@pytest.mark.parametrize("name", SINGLE + WITH_DAYS + PAIRED + PAIRED_DAYS)
@pytest.mark.parametrize("case", ["test_qa", "every_fault"])
def test_each_check_matches_jax(network, every_fault, case, name):
    if case == "test_qa":
        _, days, tmin, tmax = network
        tmin, tmax = tmin.copy(), tmax.copy()
        _plant_test_qa(days, tmin, tmax)
    else:
        _, days, tmin, tmax, _ = every_fault
    clean = np.full(tmin.shape, C.QA_OK, np.uint8)
    # from clean flags, and from flags where a few values are taken already
    taken = clean.copy()
    taken[:, ::97] = C.QA_IMPOSS_VALUE
    for prior in ((clean, clean), (taken, taken[::-1].copy())):
        want = _run_check(jqa, name, days, tmin, tmax, prior)
        got = _run_check(tqa, name, days, tmin, tmax, prior)
        for g, w in zip(got, want):
            assert g.dtype == np.uint8
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("case", ["clean", "test_qa", "every_fault"])
def test_run_qa_non_spatial_matches_jax(network, every_fault, case):
    if case == "every_fault":
        _, days, tmin, tmax, _ = every_fault
    else:
        _, days, tmin, tmax = network
        tmin, tmax = tmin.copy(), tmax.copy()
        if case == "test_qa":
            _plant_test_qa(days, tmin, tmax)
    want = jqa.run_qa_non_spatial(tmin, tmax, days)
    got = tqa.run_qa_non_spatial(tmin, tmax, days)
    for g, w in zip(got, want):
        assert g.dtype == np.uint8
        np.testing.assert_array_equal(g, w)
    if case == "every_fault":  # every planted fault carries a flag
        flags = dict(tmin=got[0], tmax=got[1])
        for fault, (var, s, t) in every_fault[4].items():
            assert (flags[var][s, t] != C.QA_OK).any(), fault


@pytest.mark.parametrize("case", ["test_qa", "every_fault"])
@pytest.mark.parametrize("max_dist_km", [75.0, 300.0])
def test_run_qa_spatial_matches_jax(network, every_fault, case, max_dist_km):
    if case == "test_qa":
        world, days, tmin, _ = network
        tmin = tmin.copy()
        tmin[7, 600] += 15.0
        flags = np.full(tmin.shape, C.QA_OK, np.uint8)
    else:
        world, days, tmin, tmax, _ = every_fault
        tmin = tmin.copy()
        tmin[20, 900] += 15.0
        flags = jqa.run_qa_non_spatial(tmin, tmax, days)[0]
    want = jqa.run_qa_spatial(tmin, flags.copy(), world.stn_lon, world.stn_lat, days,
                              max_dist_km=max_dist_km)
    got = tqa.run_qa_spatial(tmin, flags.copy(), world.stn_lon, world.stn_lat, days,
                             max_dist_km=max_dist_km)
    np.testing.assert_array_equal(got, want)
    if case == "test_qa" and max_dist_km == 300.0:
        assert got[7, 600] == C.QA_SPATIAL_REGRESS


def test_biweight_and_duplicate_pairs_match_jax():
    rng = np.random.default_rng(3)
    x = rng.normal(5.0, 4.0, (40, 217))
    x[rng.random(x.shape) < 0.2] = np.nan
    x[0] = np.nan
    x[1, 10:] = np.nan
    for g, w in zip(tqa._biweight_rows(x), jqa._biweight_rows(x)):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(tqa._biweight(x, axis=1), jqa._biweight(x, axis=1)):
        np.testing.assert_array_equal(g, w)
    A = rng.normal(0, 8, (3, 6, 372)).astype(np.float32)
    A[:, :, rng.random(372) < 0.2] = np.nan
    A[0, 4] = A[0, 1]
    A[0, 4, 50:120] = np.nan
    A[1, 5] = A[1, 2]
    A[1, 5, 200] += np.float32(1e-4)
    np.testing.assert_array_equal(tqa._hash_i20(A), jqa._hash_i20(A))
    assert tqa._duplicate_pairs(A, 100) == jqa._duplicate_pairs(A, 100)


@pytest.fixture(scope="module")
def rasters():
    """The same world's rasters in each package's own ``RasterStack``."""
    jworld = make_world(np.random.default_rng(13), nrows=40, ncols=40, n_stations=30,
                        ndays=1461)
    tworld = t_make_world(np.random.default_rng(13), nrows=40, ncols=40, n_stations=30,
                          ndays=1461)
    return jworld, JRasterStack.from_world(jworld), TRasterStack.from_world(tworld)


def test_location_checks_match_jax(rasters):
    world, jr, tr = rasters
    lon = world.stn_lon.astype(float)
    lat = world.stn_lat.astype(float)
    elev = world.stn_elev.copy()
    elev[3] += 1500.0
    lon[4], lat[4] = lat[4], lon[4]
    lon[9] = -lon[9]
    lon[11] += 50.0  # off the grid
    np.testing.assert_array_equal(tloc.dem_elevation_at(tr, lon, lat),
                                  jloc.dem_elevation_at(jr, lon, lat))
    for max_diff in (200.0, 50.0):
        bad_t, dem_t = tloc.check_elevation(tr, lon, lat, elev, max_diff)
        bad_j, dem_j = jloc.check_elevation(jr, lon, lat, elev, max_diff)
        np.testing.assert_array_equal(bad_t, bad_j)
        np.testing.assert_array_equal(dem_t, dem_j)
        np.testing.assert_array_equal(tloc.fix_elevation(elev, bad_t, dem_t),
                                      jloc.fix_elevation(elev, bad_j, dem_j))
        got = tloc.check_coordinates(tr, lon, lat, elev, max_diff)
        want = jloc.check_coordinates(jr, lon, lat, elev, max_diff)
        assert list(got) == list(want)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key])
    assert got["probe"][4] == "lonlat_swapped" and got["probe"][9] == "lon_sign"
    # an injected lookup (the geonames slot) takes the DEM's place in both
    look = lambda lo, la: np.full(len(lo), 1234.0)  # noqa: E731
    for g, w in zip(tloc.check_elevation(tr, lon, lat, elev, lookup=look),
                    jloc.check_elevation(jr, lon, lat, elev, lookup=look)):
        np.testing.assert_array_equal(g, w)
