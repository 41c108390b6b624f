"""The port's pairwise homogenisation (``topotpu_torch.homog.pha``) against
the JAX package's on the same seeded numpy inputs.

Both packages run the same numpy network logic over the same C++ core, and
these networks are small enough that ``select_predictors`` takes its numpy
branch in both (the port is handed ``torch.device("cpu")``), so every result
is compared exactly: breakpoints (month and step estimate) with ``==``,
adjustments, adjusted dailies and monthly means with ``array_equal``.
"""

import numpy as np
import pytest
import torch

import topotpu.homog.pha as jpha
import topotpu_torch.homog.pha as tpha
from topotpu.core.dates import get_days_metadata
from topotpu.io.synthetic import make_world
from jax_pha_core import load_jax_pha

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _jax_snht_core():
    """The JAX package's C++ core, built and loaded safely under xdist."""
    load_jax_pha()


@pytest.fixture(scope="module")
def daily_network():
    """``tests/test_homog.py``'s network: 25 stations, 2004-2015."""
    rng = np.random.default_rng(31)
    world = make_world(rng, nrows=40, ncols=40, n_stations=25, ndays=4383)
    days = get_days_metadata("2004-01-01", "2015-12-31")
    S = world.n_stations
    daily = (
        world.stn_norm[np.arange(S)[:, None], days.month_idx[None, :]]
        + world.stn_anoms
    ).astype(np.float32)
    return world, days, daily


def _split(days, ymd):
    return int(np.flatnonzero(days.ymd == ymd)[0])


def _planted_step(days, daily):
    daily[3, : _split(days, 20100101)] += 1.5
    return {}


def _trend(days, daily):
    daily[5] += np.linspace(0.0, 2.5, daily.shape[1]).astype(np.float32)
    return {}


def _step_on_trend(days, daily):
    daily[7] += np.linspace(0.0, 1.5, daily.shape[1]).astype(np.float32)
    daily[7, : _split(days, 20100101)] += 1.8
    return {}


def _documented_edge_step(days, daily):
    daily += np.random.default_rng(55).normal(0, 2.0, daily.shape).astype(np.float32)
    daily[6, _split(days, 20150101):] += 0.8
    return dict(station_history={6: [2015 * 12 + 0]})


def _no_signal_history(days, daily):
    return dict(station_history={2: [2008 * 12 + 5]})


def _blind_break_and_history(days, daily):
    daily += np.random.default_rng(55).normal(0, 2.0, daily.shape).astype(np.float32)
    daily[3, : _split(days, 20100101)] += 1.0
    d = 72 + 15
    return dict(station_history={3: [int((2004 + d // 12) * 12 + d % 12)]})


def _assert_same_result(got, want):
    assert got.breakpoints == want.breakpoints
    np.testing.assert_array_equal(got.adjustments, want.adjustments)
    np.testing.assert_array_equal(got.adjusted_daily, want.adjusted_daily)
    np.testing.assert_array_equal(got.monthly, want.monthly)
    assert got.adjustments.dtype == want.adjustments.dtype
    assert got.adjusted_daily.dtype == want.adjusted_daily.dtype


@pytest.mark.parametrize("plant", [_planted_step, _trend, _step_on_trend,
                                   _documented_edge_step, _no_signal_history,
                                   _blind_break_and_history])
def test_homogenize_network_matches_jax(daily_network, plant):
    world, days, daily = daily_network
    daily = daily.copy()
    kw = plant(days, daily)
    args = (daily, days.year, days.month, world.stn_lon, world.stn_lat)
    want = jpha.homogenize_network(*args, **kw)
    got = tpha.homogenize_network(*args, device=CPU, **kw)
    _assert_same_result(got, want)
    if plant is _planted_step:  # the planted break is found, as the JAX test asks
        assert abs(got.breakpoints[3][0][0] - 72) <= 6


def test_homogenize_elements_joint_and_specific_matches_jax(daily_network):
    world, days, daily = daily_network
    tmin = daily.copy()
    rng = np.random.default_rng(77)
    tmax = (daily + 8.0 + rng.normal(0, 0.3, daily.shape)).astype(np.float32)
    tmin[4, : _split(days, 20100101)] += 1.2
    tmax[4, : _split(days, 20100101)] += 2.0
    tmax[9, : _split(days, 20070101)] -= 1.5
    args = ({"tmin": tmin, "tmax": tmax}, days.year, days.month,
            world.stn_lon, world.stn_lat)
    want = jpha.homogenize_elements(*args)
    got = tpha.homogenize_elements(*args, device=CPU)
    assert list(got) == list(want)
    for e in want:
        _assert_same_result(got[e], want[e])
    assert any(abs(b - 72) <= 6 for b, _ in got["tmax"].breakpoints[4])


def test_homogenize_tiny_network_matches_jax():
    """S <= n_pairs: n_pairs clamps to S - 1 in both."""
    rng = np.random.default_rng(42)
    days = get_days_metadata("2012-01-01", "2015-12-31")
    daily = rng.normal(10, 3, size=(6, days.ndays)).astype(np.float32)
    lon, lat = rng.uniform(-105, -104, 6), rng.uniform(39, 40, 6)
    want = jpha.homogenize_network(daily, days.year, days.month, lon, lat)
    got = tpha.homogenize_network(daily, days.year, days.month, lon, lat, device=CPU)
    _assert_same_result(got, want)


def test_homogenize_requires_a_device(daily_network):
    world, days, daily = daily_network
    with pytest.raises(TypeError, match="device"):
        tpha.homogenize_network(daily, days.year, days.month, world.stn_lon, world.stn_lat)


def _series(kind, rng):
    T = 240
    x = rng.normal(0, 0.3, T).astype(np.float32)
    if kind == "step":
        x[150:] += 1.2
    elif kind == "trend":
        x += np.linspace(0, 2.0, T).astype(np.float32)
    elif kind == "sloped_step":
        x += np.linspace(0, 1.5, T).astype(np.float32)
        x[120:] += 1.0
    elif kind == "nan":
        x[100:] += 1.0
        x[::6] = np.nan
    elif kind == "all_nan":
        x[:] = np.nan
    return x


@pytest.mark.parametrize("kind", ["step", "trend", "sloped_step", "nan", "clean", "all_nan"])
@pytest.mark.parametrize("brk,lo,hi", [(150, 0, 240), (120, 24, 200), (60, 0, 120)])
def test_break_model_matches_jax(kind, brk, lo, hi):
    x = _series(kind, np.random.default_rng(3))
    assert tpha.break_model(x, brk, lo, hi) == jpha.break_model(x, brk, lo, hi)


@pytest.mark.parametrize("breaks,tol", [
    ([0, 6, 12, 20], 6),
    ([10, 11, 12, 13, 30], 6),
    ([-1, -1, 40, -1, 43, 90, 91, 92], 6),
    ([-1, -1, -1], 6),
    ([5, 5, 5, 70, 71, 140], 2),
])
def test_vote_clusters_matches_jax(breaks, tol):
    b = np.array(breaks, np.int32)
    assert tpha.vote_clusters(b, tol) == jpha.vote_clusters(b, tol)


@pytest.mark.parametrize("clusters,kw", [
    ({"tmin": [(50, 4)], "tmax": []}, {}),
    ({"tmin": [(50, 3)], "tmax": [(53, 3)]}, {}),
    ({"tmin": [(50, 3)], "tmax": [(120, 3)]}, {}),
    ({"tmin": [(50, 2)], "tmax": [(50, 8)]}, {}),
    ({"tmin": [(50, 5), (60, 5), (90, 5)], "tmax": []}, {}),
    ({"tmin": [(50, 1)], "tmax": []}, dict(documented=(48,))),
    ({"tmin": [], "tmax": []}, dict(documented=(100,))),
    ({"tmin": [(50, 2)], "tmax": []}, dict(documented=(100,))),
    ({"tmin": [(120, 8)], "tmax": []}, dict(documented=(132,))),
    ({"tmin": [(120, 8)], "tmax": []}, dict(documented=(132,), n_months=144)),
    ({"tmin": [(72, 8)], "tmax": []}, dict(documented=(87,), n_months=144)),
    ({"tmin": [(72, 8)], "tmax": [(80, 4)]}, dict(documented=(87, 20), n_months=144)),
])
def test_merge_attributions_matches_jax(clusters, kw):
    args = dict(need=4, date_tol=6, minseg=24, **kw)
    assert tpha.merge_attributions(clusters, **args) == jpha.merge_attributions(clusters, **args)


@pytest.mark.parametrize("attributed,documented", [
    ([72], frozenset()), ([36, 72], frozenset()), ([100], frozenset({100})), ([], frozenset()),
])
def test_confirm_and_steps_matches_jax(daily_network, attributed, documented):
    world, days, daily = daily_network
    daily = daily.copy()
    daily[3, : _split(days, 20100101)] += 1.5
    daily[3, : _split(days, 20070101)] -= 0.8
    _, _, diffs = jpha._pair_diffs(daily, days.year, days.month, 8,
                                   world.stn_lon, world.stn_lat)
    _, _, tdiffs = tpha._pair_diffs(daily, days.year, days.month, 8,
                                    world.stn_lon, world.stn_lat, device=CPU)
    np.testing.assert_array_equal(tdiffs, diffs)
    M = diffs.shape[2]
    want = jpha._confirm_and_steps(diffs[3], attributed, M, 3, 3.0, documented)
    got = tpha._confirm_and_steps(diffs[3], attributed, M, 3, 3.0, documented)
    assert got == want


HISTORY = """
# station history fixture
SYNTH00001 2010-01  site move to new enclosure
SYNTH00001 2012-06
SYNTH00002 1999-12  instrument swap
UNKNOWN999 2005-03  outside this network -> ignored
"""


@pytest.mark.parametrize("text,error", [
    (HISTORY, None),
    ("", None),
    ("SYNTH00000 201001", "bad date"),
    ("SYNTH00000 2010-13", "bad date"),
    ("SYNTH00000", "need"),
])
def test_parse_station_history_matches_jax(text, error):
    ids = np.array([b"SYNTH00000", b"SYNTH00001", b"SYNTH00002"])
    if error is None:
        assert tpha.parse_station_history(text, ids) == jpha.parse_station_history(text, ids)
        return
    with pytest.raises(ValueError, match=error) as want:
        jpha.parse_station_history(text, ids)
    with pytest.raises(ValueError, match=error) as got:
        tpha.parse_station_history(text, ids)
    assert str(got.value) == str(want.value)
