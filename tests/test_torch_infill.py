"""The port's infill pipeline (``topotpu_torch.infill``), post-infill flags
and ``xval_infill`` against the JAX package on the same seeded inputs, on the
CPU.

Tolerances. ``select_predictors``' numpy branch is the same code: equal.
Its device branch is float32 grams in both packages, whose rounding differs,
so the predictor sets are compared away from ties: a station in one set and
not the other must score within ``TIE_MARGIN`` of the boundary (the n-th
best float64 score). The network infill (40 stations, 1,095 days,
``tests/test_ppca_infill.py``'s) chooses the same predictors and ``bad``
flags. Most targets run to the 200-iteration cap, where the two float32
trajectories have not met: filled series agree within 1e-3 C on 99.9 % of
entries and 5e-3 C on all (measured 5e-4 C and 1.8e-3 C), monthly normals
within 2e-4 C (measured 4e-5 C), iteration counts within one. Monthly means
of one series: the port's within 1e-5 C of float64 (measured 2.7e-6 C), the
JAX package's numpy float32 within 3e-5 C of the port's (measured 1.1e-5 C).
The x-val scores agree within 1e-4 C.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from topotpu.core.config import PPCAParams
from topotpu.core.dates import get_days_metadata
from topotpu.infill import infill_network as j_infill_network
from topotpu.infill import pipeline as jpipe
from topotpu.infill.post_infill import changepoint_flags as j_changepoint_flags
from topotpu.interp.xval import xval_infill as j_xval_infill
from topotpu.io.synthetic import make_world
from topotpu_torch.infill import infill_network, pipeline as tpipe
from topotpu_torch.infill.post_infill import changepoint_flags
from topotpu_torch.interp.xval import xval_infill
from topotpu_torch.io.synthetic import station_network_from_world

torch.set_num_threads(1)

TIE_MARGIN = 1e-4  # score units (|corr| + 1); float32 grams part by ~1e-6
PARAMS = PPCAParams(n_components=8, n_neighbors=12)


@pytest.fixture(scope="module")
def net():
    """``tests/test_ppca_infill.py``'s 40-station, 1,095-day network with 20 %
    of entries missing, plus one long outage at each of five stations."""
    world = make_world(np.random.default_rng(42), nrows=30, ncols=30, n_stations=40,
                       ndays=1095)
    days = get_days_metadata("2013-01-01", "2015-12-31")
    truth, obs = station_network_from_world(world, days.month_idx, 0.2, seed=1)
    for s in range(5):
        obs[s, 100 * s : 100 * s + 400] = np.nan
    return world, days, truth, obs


def _standardised(obs, mask):
    """``select_predictors``' standardised series, float32."""
    mu = np.nanmean(np.where(mask, obs, np.nan), axis=1)
    sd = np.nanstd(np.where(mask, obs, np.nan), axis=1) + 1e-6
    return np.where(mask, (obs - mu[:, None]) / sd[:, None], 0.0).astype(np.float32)


def _scores64(xs, mask, lon, lat):
    """The selection score in float64 on the host: |corr| + 1 over >= 30
    jointly observed days, else the proximity tiebreak; self -1."""
    from topotpu.oracle.numpy_ref import haversine_km

    x, m = xs.astype(np.float64), mask.astype(np.float64)
    n = m @ m.T
    sx, sxy, sxx = x @ m.T, x @ x.T, (x * x) @ m.T
    sn = np.maximum(n, 1.0)
    cov = sxy / sn - (sx / sn) * (sx.T / sn)
    vx = np.maximum(sxx / sn - (sx / sn) ** 2, 1e-12)
    score = np.abs(np.where(n < 30, 0.0, cov / np.sqrt(vx * vx.T)))
    prox = 1e-4 / (1.0 + haversine_km(lon[:, None], lat[:, None], lon[None], lat[None]))
    score = np.where(score > 0, score + 1.0, prox)
    np.fill_diagonal(score, -1.0)
    return score


def _assert_sets_agree_away_from_ties(got, want, score):
    n = got.shape[1]
    for s in range(len(got)):
        diff = set(got[s]) ^ set(want[s])
        if diff:
            edge = np.sort(score[s])[::-1][n - 1]
            worst = max(abs(score[s, j] - edge) for j in diff)
            assert worst < TIE_MARGIN, (s, sorted(diff), worst)


@pytest.mark.parametrize("coords", [True, False])
def test_select_predictors_numpy_branch_equal(net, coords):
    world, _, _, obs = net
    mask = np.isfinite(obs)
    ll = (world.stn_lon, world.stn_lat) if coords else (None, None)
    calls = tpipe._device_select_predictors.calls
    got = tpipe.select_predictors(obs, mask, 12, *ll, device="cpu")
    want = jpipe.select_predictors(obs, mask, 12, *ll)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32 and tpipe._device_select_predictors.calls == calls


@pytest.mark.parametrize("use_dist", [True, False])
def test_device_select_predictors_matches_jax(net, use_dist):
    """The device branch of both packages on the same inputs, with five
    stations whose long outage leaves some pairs under 30 joint days."""
    world, _, _, obs = net
    obs = obs.copy()
    obs[35:, :1000] = np.nan  # < 30 days overlap with the outage stations
    mask = np.isfinite(obs)
    xs = _standardised(obs, mask)
    lon, lat = world.stn_lon.astype(np.float32), world.stn_lat.astype(np.float32)
    calls = tpipe._device_select_predictors.calls
    got = tpipe._device_select_predictors(xs, mask, lon, lat, use_dist, 12, "cpu")
    assert tpipe._device_select_predictors.calls == calls + 1
    want = np.asarray(jpipe._device_select_predictors(
        jnp.asarray(xs), jnp.asarray(mask), jnp.asarray(lon), jnp.asarray(lat), use_dist, 12))
    assert got.shape == want.shape == (40, 12) and got.dtype == np.int32
    assert not (got == np.arange(40)[:, None]).any()
    score = _scores64(xs, mask, world.stn_lon, world.stn_lat)
    if not use_dist:
        score = np.where(score < 1.0, np.where(score < 0, -1.0, 0.0), score)
    _assert_sets_agree_away_from_ties(got, want, score)
    # and both against the float64 ranking
    best64 = np.argsort(-score, axis=1, kind="stable")[:, :12]
    _assert_sets_agree_away_from_ties(got, best64, score)


@pytest.mark.parametrize("branch", ["numpy", "device"])
def test_select_predictors_prefers_correlated(rng, branch):
    """``tests/test_ppca_infill.py``'s case, on both branches of the port."""
    T = 400
    base = rng.normal(size=T)
    obs = np.stack([
        base + 0.1 * rng.normal(size=T),   # 0: target
        base + 0.1 * rng.normal(size=T),   # 1: near-copy (should rank first)
        0.5 * base + rng.normal(size=T),   # 2: weakly correlated
        rng.normal(size=T),                # 3: uncorrelated
    ])
    mask = np.ones_like(obs, bool)
    if branch == "numpy":
        preds = tpipe.select_predictors(obs, mask, 2, device="cpu")
    else:
        z = np.zeros(4, np.float32)
        preds = tpipe._device_select_predictors(_standardised(obs, mask), mask, z, z, False,
                                                2, "cpu")
    assert preds[0, 0] == 1
    assert 3 not in preds[0]


@pytest.fixture(scope="module")
def infilled(net):
    world, days, _, obs = net
    kw = dict(stn_lon=world.stn_lon, stn_lat=world.stn_lat)
    return (infill_network(obs, days.month_idx, PARAMS, device="cpu", **kw),
            j_infill_network(obs, days.month_idx, PARAMS, **kw))


def test_infill_network_matches_jax(net, infilled):
    _, _, truth, obs = net
    got, want = infilled
    np.testing.assert_array_equal(got.predictors, want.predictors)
    np.testing.assert_array_equal(got.bad, want.bad)
    assert got.bad[:5].sum() == 0 and got.filled.dtype == np.float32
    np.testing.assert_array_equal(got.obs_mask, want.obs_mask)
    d = np.abs(got.filled - want.filled)
    assert np.quantile(d, 0.999) <= 1e-3 and d.max() <= 5e-3, (np.quantile(d, 0.999), d.max())
    np.testing.assert_allclose(got.norms, want.norms, rtol=0, atol=2e-4)
    assert np.abs(got.n_iters.astype(int) - want.n_iters).max() <= 1
    miss = np.isnan(obs)
    np.testing.assert_array_equal(got.filled[~miss], truth[~miss])


def test_infill_network_beats_climatology(net, infilled):
    """``tests/test_ppca_infill.py``'s bars on the port: imputation MAE under
    0.6 x the observed station-month climatology's, normals within 0.15 C."""
    _, days, truth, obs = net
    got, _ = infilled
    miss = np.isnan(obs)
    clim = np.zeros_like(truth)
    for m in range(12):
        sel = days.month_idx == m
        clim[:, sel] = np.nanmean(obs[:, sel], axis=1)[:, None]
    mae = np.abs(got.filled - truth)[miss].mean()
    assert mae < 0.6 * np.abs(clim - truth)[miss].mean()
    true_norm = np.stack([truth[:, days.month_idx == m].mean(axis=1) for m in range(12)], 1)
    assert np.abs(got.norms - true_norm).mean() < 0.15
    assert np.isfinite(got.filled).all()


def test_infill_network_batch_composition_invariant(net):
    """Per-target results do not depend on the batch, up to float32 rounding
    (``tests/test_ppca_infill.py``'s case on the port). The port does not
    promise bit-for-bit equality across batch compositions: the batched
    matrix products and reductions of the EM pick their blocking by the batch
    count, and 40 iterations carry the last-bit differences along. Batches of
    20 against batches of 7 gave imputed values 1.96e-4 C apart at the most
    (13.7 % of values differ, all of them imputed; normals 5.7e-6 C apart,
    iteration counts equal) on an AMD EPYC host with one torch thread and
    with eight, and bit for bit on the CPU the test was first written on; on
    an H100 one batch of 64 against two of 32 came 1.96e-3 C apart at 10,957
    days. Held here: imputed values within 3e-3 C, normals within 1e-3 C,
    iteration counts within one, observed entries returned exactly."""
    _, days, _, obs = net
    obs = obs[:20]
    params = PPCAParams(n_components=4, n_neighbors=8, max_iters=40)
    one = infill_network(obs, days.month_idx, params, batch_size=20, device="cpu")
    odd = infill_network(obs, days.month_idx, params, batch_size=7, device="cpu")
    seen = np.isfinite(obs)
    np.testing.assert_array_equal(one.filled[seen], obs[seen])
    np.testing.assert_array_equal(odd.filled[seen], obs[seen])
    np.testing.assert_allclose(one.filled, odd.filled, rtol=0, atol=3e-3)
    np.testing.assert_allclose(one.norms, odd.norms, rtol=0, atol=1e-3)
    assert np.abs(one.n_iters.astype(int) - odd.n_iters.astype(int)).max() <= 1
    np.testing.assert_array_equal(one.predictors, odd.predictors)
    np.testing.assert_array_equal(one.bad, odd.bad)


def test_monthly_normals_matches_jax(net, infilled):
    _, days, _, _ = net
    got, _ = infilled
    mine = tpipe.monthly_normals(got.filled, days.month_idx, "cpu")
    want64 = jpipe.monthly_normals(got.filled.astype(np.float64), days.month_idx)
    np.testing.assert_allclose(mine, want64, rtol=0, atol=1e-5)
    np.testing.assert_allclose(mine, jpipe.monthly_normals(got.filled, days.month_idx),
                               rtol=0, atol=3e-5)


@pytest.mark.parametrize("case", ["planted", "infilled"])
def test_changepoint_flags_match_jax(net, infilled, case):
    if case == "planted":
        # tests/test_post_infill.py's: an imputed level shift is flagged, an
        # observed one is not
        days = get_days_metadata("2006-01-01", "2015-12-31")
        rng = np.random.default_rng(42)
        filled = rng.normal(0, 0.8, size=(3, days.ndays)).astype(np.float32)
        obs = np.ones((3, days.ndays), bool)
        split = int(np.flatnonzero(days.ymd == 20130101)[0])
        obs[0, split:] = False
        filled[0, split:] += 2.5
        filled[1, split:] += 2.5
    else:
        _, days, _, _ = net
        res, _ = infilled
        filled, obs = res.filled.copy(), res.obs_mask
        filled[7, ~obs[7]] += 3.0  # an imputation artifact at one station
    got = changepoint_flags(filled, obs, days.year, days.month)
    want = j_changepoint_flags(filled, obs, days.year, days.month)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == bool
    if case == "planted":
        assert list(got) == [True, False, False]


def test_xval_infill_matches_jax(net):
    world, days, truth, _ = net
    kw = dict(holdout_frac=0.2, seed=3, stn_lon=world.stn_lon, stn_lat=world.stn_lat)
    got = xval_infill(truth, days.month_idx, PARAMS, device="cpu", **kw)
    want = j_xval_infill(truth, days.month_idx, PARAMS, **kw)
    assert got["n_holdout"] == want["n_holdout"] > 0.18 * truth.size
    np.testing.assert_array_equal(got["result"].obs_mask, want["result"].obs_mask)
    for f in ("mae", "bias", "rmse"):
        np.testing.assert_allclose(got[f], want[f], rtol=0, atol=1e-4, err_msg=f)
    # tests/test_xval.py's bars
    assert got["mae"] < 1.5 and abs(got["bias"]) < 0.2
