"""The port's cross-validation stages and neighbourhood-size optimisation
against ``topotpu.interp.xval`` (its jnp path, which is what it runs on the
CPU).

The world is ``tests/test_xval.py``'s (seed 17, 60 x 60 cells, 150
stations, 365 days) at 2 arcmin cells instead of 30 arcsec, i.e. about 14 km
between stations instead of 3.6 km, with the variogram range scaled with it.
On the denser world the float32 trend design of a station's tiny
neighbourhood is so nearly collinear (lst follows elevation) that a float32
LOO normal lands up to 0.1 C from a float64 run of the same algorithm, in
both packages alike (measured on the CPU; ``ROADMAP.md`` Queue 3), which
leaves nothing to compare the two packages by.

Tolerances. Conditioning grows as k falls (a 4-column trend design on 8
neighbours), and the float32 cosine selection score breaks near-ties at the
k-th neighbour differently in the two packages. So per station-month LOO
errors agree with the JAX package by k as ``ERR_TOL`` states (99th
percentile, max), and the float64 pipeline oracle
(``topotpu.oracle.pipeline.interp_cell_month``, run with the station left
out of the pool) is the arbiter on a sample of stations: the port's LOO
normals are no further from it than the JAX package's, in mean and 99th
percentile, within 50 % + 1e-4 C. Monthly MAE, bias and R^2 within
2e-3; daily MAE, bias and RMSE within 2e-3 C, per-station daily MAE within
5e-3 C on 99 % of stations and 2e-2 C on all. The nnghs sweeps must pick
the same k.
"""

import dataclasses
import types
import warnings

import numpy as np
import pytest
import torch

from topotpu.core.config import InterpParams
from topotpu.interp import xval as jxval
from topotpu.io.synthetic import make_world
from topotpu.oracle.pipeline import interp_cell_month
from topotpu_torch.geo.neighbors import select_neighbors
from topotpu_torch.interp import xval as txval
from topotpu_torch.interp.point import group_days_by_month, month_layout, ungroup_days
from topotpu_torch.io.synthetic import station_arrays_from_world

torch.set_num_threads(1)

# |port - JAX| of the LOO errors by k: (99th percentile, max), C. Readings on
# this world (99th percentile / max), on two CPUs:
#   k     first machine        an AMD EPYC host (1 and 8 torch threads alike)
#   8     1.6e-2 / 2.8e-2      1.25e-2 / 6.07e-2
#   16    5.5e-3 / 1.3e-2      4.6e-3  / 1.24e-2
#   24    not read             4.6e-3  / 1.79e-2
#   32    6e-4   / 2.1e-3      6.9e-4  / 3.8e-3
# The worst station-month is float32 noise, not arithmetic: each package's
# float32 LOO normal sits up to 0.1 C from a float64 run of the same algorithm
# at small k (``ROADMAP.md`` Queue 3), and the BLAS and rounding of the CPU at
# hand decide where in that band it lands. So the 99th percentile keeps the
# bound it had (k = 24, which no test reads at the 99th percentile, has room
# over its one reading), each cap has at least 2x headroom over both readings
# and stays inside the sum of the two packages' float32 bands, and the float64
# pipeline oracle below decides: the port is no further from it than the JAX
# package.
ERR_TOL = {8: (3e-2, 1.5e-1), 16: (1e-2, 5e-2), 24: (1e-2, 5e-2), 32: (2e-3, 1.5e-2)}
ORACLE_STATIONS = 40  # stations held against the float64 pipeline oracle, all 12 months


@pytest.fixture(scope="module")
def st():
    world = make_world(np.random.default_rng(17), nrows=60, ncols=60, n_stations=150,
                       ndays=365, cellsize=1.0 / 30.0, vario=(0.05, 1.0, 160.0))
    return station_arrays_from_world(world)


def _loo_oracle_err(st, picks, k):
    """(len(picks), 12) float64 LOO errors of the pipeline oracle: each
    station's normal kriged from the valid others, minus its stored normal."""
    S = len(st.lon)
    out = np.full((len(picks), 12), np.nan)
    for i, s in enumerate(picks):
        for m in range(12):
            keep = (np.arange(S) != s) & st.valid[:, m]
            cov = np.stack([st.elev, st.tdi, st.lst[:, m]], 1).astype(np.float64)
            want = interp_cell_month(
                st.lon[s], st.lat[s], cov[s], np.zeros(3), st.lon[keep], st.lat[keep],
                cov[keep], np.zeros((keep.sum(), 3)), st.norm[keep, m].astype(np.float64),
                st.vario[keep, m].astype(np.float64), k)["normal"]
            out[i, m] = want - float(st.norm[s, m])
    return out


def _close_bulk(got, want, bulk, cap, what):
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin, err_msg=what)
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))[fin]
    assert np.quantile(err, 0.99) <= bulk, (what, np.quantile(err, 0.99))
    assert err.max() <= cap, (what, err.max())


def _assert_scores_close(got, want, k):
    _close_bulk(got.per_station_err, want.per_station_err, *ERR_TOL[k], "per_station_err")
    for f in ("mae", "bias", "r2"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f), atol=2e-3, err_msg=f)


@pytest.mark.parametrize("k", [8, 16, 32])
def test_xval_interp_normals_matches_jax(st, k):
    params = InterpParams(k_neighbors=k)
    got = txval.xval_interp_normals(*st.krig(), params, "cpu")
    want = jxval.xval_interp_normals(*st.krig(), params)
    _assert_scores_close(got, want, k)
    picks = np.random.default_rng(k).choice(len(st.lon), ORACLE_STATIONS, replace=False)
    ref = _loo_oracle_err(st, picks, k)
    d_port = np.abs(got.per_station_err[picks] - ref)
    d_jax = np.abs(want.per_station_err[picks] - ref)
    assert np.isfinite(d_port).all() and np.isfinite(d_jax).all()
    for stat in (np.mean, lambda a: np.quantile(a, 0.99)):
        assert stat(d_port) <= 1.5 * stat(d_jax) + 1e-4, (stat(d_port), stat(d_jax))
    # tests/test_xval.py's paper-scale bars
    assert got.mae.mean() < 0.6 and abs(got.bias.mean()) < 0.1 and got.r2.mean() > 0.9


def _assert_daily_close(got, want):
    for f in ("mae", "bias", "rmse"):
        np.testing.assert_allclose(got[f], want[f], atol=2e-3, err_msg=f)
    np.testing.assert_allclose(got["mae_by_month"], want["mae_by_month"], atol=2e-3)
    _close_bulk(got["per_station_mae"], want["per_station_mae"], 5e-3, 2e-2, "per_station_mae")


@pytest.mark.parametrize("ka", [16, 8])
def test_xval_interp_daily_matches_jax(st, ka):
    params = InterpParams(k_neighbors=16, k_neighbors_anom=ka)
    got = txval.xval_interp_daily(*st.krig(), st.anoms, st.month_idx, params, "cpu")
    want = jxval.xval_interp_daily(*st.krig(), st.anoms, st.month_idx, params)
    _assert_daily_close(got, want)
    assert got["mae"] < 2.0 and abs(got["bias"]) < 0.15 and got["rmse"] >= got["mae"]


def test_optimize_nnghs_matches_jax(st):
    kw = dict(candidates=(8, 16, 32),
              region_labels=(st.lat > st.lat.mean()).astype(int))
    got = txval.optimize_nnghs(*st.krig(), **kw, device="cpu")
    want = jxval.optimize_nnghs(*st.krig(), **kw)
    assert got["best"] == want["best"] and set(got["best"]) == {0, 1}
    for k in (8, 16, 32):
        np.testing.assert_allclose(got["mae"][k], want["mae"][k], atol=2e-3)
        _close_bulk(got["per_station_err"][k], want["per_station_err"][k], *ERR_TOL[k],
                    f"per_station_err k={k}")


def test_optimize_nnghs_anoms_matches_jax(st):
    kw = dict(candidates=(8, 16), region_labels=(st.lat > st.lat.mean()).astype(int),
              base_params=InterpParams(k_neighbors=16))
    got = txval.optimize_nnghs_anoms(*st.krig(), st.anoms, st.month_idx, **kw, device="cpu")
    want = jxval.optimize_nnghs_anoms(*st.krig(), st.anoms, st.month_idx, **kw)
    assert got["best"] == want["best"]
    for ka in (8, 16):
        np.testing.assert_allclose(got["mae"][ka], want["mae"][ka], atol=2e-3)
        _close_bulk(got["per_station_mae"][ka], want["per_station_mae"][ka], 5e-3, 2e-2,
                    f"per_station_mae ka={ka}")
    assert got["mae"][8] != got["mae"][16]


def test_optimize_nnghs_survives_poisoned_station():
    """A station whose stored normal is NaN stays in the pool: both packages
    score only finite entries, keep every candidate's MAE finite and pick
    the same k by argmin (``tests/test_xval.py``'s case, at 2 arcmin cells)."""
    world = make_world(np.random.default_rng(3), nrows=32, ncols=32, n_stations=40, ndays=31,
                       cellsize=1.0 / 30.0, vario=(0.05, 1.0, 160.0))
    s = station_arrays_from_world(world)
    norm = s.norm.copy()
    norm[7] = np.nan
    args = s._replace(norm=norm).krig()
    kw = dict(candidates=(8, 16, 24), region_labels=np.zeros(40, int),
              base_params=InterpParams(k_neighbors=16), parsimony=False)
    got = txval.optimize_nnghs(*args, **kw, device="cpu")
    want = jxval.optimize_nnghs(*args, **kw)
    assert all(np.isfinite(v).all() for v in got["mae"].values())
    assert got["best"] == want["best"]
    for k in (8, 16, 24):  # 39 scored stations: one moves a month's MAE by 1/39
        np.testing.assert_allclose(got["mae"][k], want["mae"][k], atol=5e-3)


def test_pick_k_and_mean_se_match_jax():
    flat = {8: (0.402, 0.01), 16: (0.401, 0.01), 32: (0.4002, 0.01), 48: (0.400, 0.01)}
    steep = {8: (0.80, 0.01), 16: (0.55, 0.01), 32: (0.40, 0.01)}
    for scores in (flat, steep, {}):
        for parsimony in (True, False):
            assert (txval._pick_k(scores, 16, parsimony)
                    == jxval._pick_k(scores, 16, parsimony))
    vals = np.array([0.3, np.nan, 0.5, 0.45, np.inf])
    assert txval._mean_se(vals) == jxval._mean_se(vals)
    assert txval._mean_se(np.array([np.nan])) is None


def test_loo_twin_enters_the_neighbourhood(st):
    """A station duplicated at identical coordinates (a twin) is a separate
    pool member: leaving one out by index keeps the other, which enters the
    held-out station's neighbourhood first, at distance 0. Both packages do
    this (the reference's remove-by-station rule), with the same normals
    and scores."""
    S = len(st.lon)
    dup = lambda a: np.concatenate([a, a[:1]], axis=0)  # noqa: E731
    twin = st._replace(**{f: dup(getattr(st, f)) for f in
                          ("lon", "lat", "elev", "tdi", "lst", "norm", "vario", "valid",
                           "anoms")})
    T = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    nbr = select_neighbors(T(twin.lon), T(twin.lat), T(twin.lon), T(twin.lat),
                           torch.ones(S + 1, dtype=torch.bool), k=16,
                           exclude_idx=torch.arange(S + 1))
    assert nbr.idx[0, 0] == S and nbr.idx[S, 0] == 0
    assert nbr.dist[0, 0] == 0.0 and nbr.dist[S, 0] == 0.0
    assert not (nbr.idx == torch.arange(S + 1)[:, None]).any()

    params = InterpParams(k_neighbors=16)
    got = txval.xval_interp_normals(*twin.krig(), params, "cpu")
    want = jxval.xval_interp_normals(*twin.krig(), params)
    _assert_scores_close(got, want, 16)
    # the twins predict each other: the same error at both (up to float32
    # rounding amplified by the trend design), and far below the network's
    # typical LOO error
    np.testing.assert_allclose(got.per_station_err[0], got.per_station_err[S], atol=1e-3)
    assert np.abs(got.per_station_err[0]).mean() < 0.5 * np.nanmean(np.abs(got.per_station_err))

    got_d = txval.xval_interp_daily(*twin.krig(), twin.anoms, twin.month_idx, params, "cpu")
    want_d = jxval.xval_interp_daily(*twin.krig(), twin.anoms, twin.month_idx, params)
    _assert_daily_close(got_d, want_d)


# ------------------------------------------- the daily scoring on the device


def _numpy_daily_scores(pred_g, layout, stn_norm, stn_anoms, month_idx, stn_valid, oks):
    """The daily LOO scores as numpy computed them before the scoring moved to
    the device: the (S, 12, dpm) predictions ungrouped, the truth rebuilt in
    calendar order, the per-month column means over the scored stations."""
    pred = ungroup_days(pred_g, layout)  # (S, T)
    truth = stn_norm[:, month_idx] + stn_anoms
    vmask = stn_valid.all(axis=1) & oks.all(axis=1)
    err = (pred - truth)[vmask]
    abs_all = np.abs(pred - truth)
    psm = abs_all.mean(axis=1)
    mae_by_month = [
        float(abs_all[vmask][:, month_idx == m].mean()) if err.size else float("nan")
        for m in range(12)
    ]
    return {
        "mae": float(np.abs(err).mean()) if err.size else float("nan"),
        "bias": float(err.mean()) if err.size else float("nan"),
        "rmse": float(np.sqrt((err**2).mean())) if err.size else float("nan"),
        "mae_by_month": mae_by_month,
        "per_station_mae": np.where(vmask, psm, np.nan),
    }


@pytest.mark.parametrize("case", ["clean", "invalid_month", "failed_solve", "nan_normal",
                                  "pad_garbage", "none_scorable"])
def test_score_daily_matches_the_numpy_scoring(case):
    """``_score_daily`` (torch, month-grouped, one fetch) against the former
    numpy formula on the same random predictions, within 1e-5 C, NaN where
    numpy gives NaN, with the same return types."""
    rng = np.random.default_rng(5)
    S = 40
    # 14 months from a leap-year January: two Januaries fill the 62 slots of
    # a month, so every other month has pad slots
    month_idx = (np.arange("2000-01-01", "2001-03-01", dtype="datetime64[D]")
                 .astype("datetime64[M]").astype(int) % 12)
    layout = month_layout(types.SimpleNamespace(month_idx=month_idx, ndays=len(month_idx)))
    norm = rng.normal(10.0, 8.0, (S, 12)).astype(np.float32)
    anoms = rng.normal(0.0, 3.0, (S, len(month_idx))).astype(np.float32)
    valid = np.ones((S, 12), bool)
    ok = np.ones((12, S), bool)
    truth_g = group_days_by_month(norm[:, month_idx] + anoms, layout)  # (S, 12, dpm)
    pred_g = (truth_g + rng.normal(0.2, 1.0, truth_g.shape)).astype(np.float32)
    anoms_g = np.moveaxis(group_days_by_month(anoms, layout), 1, 0).copy()  # (12, S, dpm)
    if case == "invalid_month":
        valid[3, 5] = False
    elif case == "failed_solve":
        ok[2, 7] = False
        pred_g[7, 2] = np.nan  # a failed solve's prediction reaches no sum
    elif case == "nan_normal":
        norm[4, 1] = np.nan  # a scored station's truth: NaN propagates, as in numpy
    elif case == "pad_garbage":
        pads = ~layout.day_valid
        pred_g[:, pads] = np.nan
        pred_g[::2, pads] = 1e30
        anoms_g = np.where(pads[:, None], np.float32(np.nan), anoms_g)
    elif case == "none_scorable":
        ok[:, ::2] = False
        valid[1::2, 0] = False
    want_vmask = valid.all(1) & ok.all(0)
    assert want_vmask.any() == (case != "none_scorable")
    if case == "nan_normal":
        assert want_vmask[4]

    T = torch.from_numpy
    got = txval._score_daily(list(T(np.moveaxis(pred_g, 1, 0).copy())), T(norm), T(anoms_g),
                             T(valid), T(ok), T(layout.day_valid))
    with warnings.catch_warnings():  # numpy's mean of nothing, where nothing is scored
        warnings.simplefilter("ignore", RuntimeWarning)
        want = _numpy_daily_scores(pred_g, layout, norm, anoms, month_idx, valid, ok.T)

    assert set(got) == {"mae", "bias", "rmse", "mae_by_month", "per_station_mae"}
    for f in ("mae", "bias", "rmse"):
        assert type(got[f]) is float, f
        np.testing.assert_allclose(got[f], want[f], rtol=0, atol=1e-5, err_msg=f)
    assert isinstance(got["mae_by_month"], list) and len(got["mae_by_month"]) == 12
    assert all(type(v) is float for v in got["mae_by_month"])
    np.testing.assert_allclose(got["mae_by_month"], want["mae_by_month"], rtol=0, atol=1e-5)
    psm = got["per_station_mae"]
    assert isinstance(psm, np.ndarray) and psm.shape == (S,)
    assert np.issubdtype(psm.dtype, np.floating)
    np.testing.assert_allclose(psm, want["per_station_mae"], rtol=0, atol=1e-5)
    if case == "nan_normal":
        assert np.isnan(got["mae"]) and np.isnan(got["mae_by_month"][1]) and np.isnan(psm[4])
        assert np.isfinite(got["mae_by_month"][0]) and np.isfinite(np.delete(psm, 4)).all()
    if case == "none_scorable":
        assert np.isnan([got["mae"], got["bias"], got["rmse"], *got["mae_by_month"]]).all()
        assert np.isnan(psm).all()


def test_xval_interp_daily_fetches_once(st, monkeypatch):
    """The daily x-val brings its results to the host in one transfer of the
    (S,) per-station MAEs and 15 scalars."""
    sizes = []
    cpu = torch.Tensor.cpu

    def counted(self, *a, **kw):
        sizes.append(self.numel())
        return cpu(self, *a, **kw)

    monkeypatch.setattr(torch.Tensor, "cpu", counted)
    got = txval.xval_interp_daily(*st.krig(), st.anoms, st.month_idx,
                                  InterpParams(k_neighbors=16, k_neighbors_anom=8), "cpu")
    assert sizes == [len(st.lon) + 15]
    assert np.isfinite(got["mae"]) and got["per_station_mae"].shape == (len(st.lon),)


# --------------------------------------- the anomaly sweep's inputs, made once


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_nnghs_anoms_sweep_equals_one_daily_xval_a_candidate(st, device):
    """The sweep makes its inputs once and runs each ka on them: its MAEs,
    per-station MAEs and choices are, bit for bit, those of one
    ``xval_interp_daily`` call a candidate, each making its own inputs."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    base = InterpParams(k_neighbors=16)
    regions = (st.lat > st.lat.mean()).astype(int)
    cands = (8, 12, 16)
    got = txval.optimize_nnghs_anoms(*st.krig(), st.anoms, st.month_idx, candidates=cands,
                                     region_labels=regions, base_params=base, device=device)
    want = {ka: txval.xval_interp_daily(*st.krig(), st.anoms, st.month_idx,
                                        dataclasses.replace(base, k_neighbors_anom=ka), device)
            for ka in cands}
    assert sorted(got["mae"]) == sorted(got["per_station_mae"]) == list(cands)
    for ka in cands:
        assert np.isfinite(want[ka]["mae"]) and got["mae"][ka] == want[ka]["mae"], ka
        np.testing.assert_array_equal(got["per_station_mae"][ka], want[ka]["per_station_mae"])
    best = {}
    for r in (0, 1):
        scores = {ka: txval._mean_se(w["per_station_mae"][regions == r]) for ka, w in want.items()}
        assert None not in scores.values()
        best[r] = txval._pick_k(scores, 16, True)
    assert got["best"] == best


@pytest.mark.parametrize("route", ["sweep", "single"])
def test_daily_xval_groups_and_selects_once_a_call(st, monkeypatch, route):
    """A three-candidate sweep groups the anomalies once and selects the 12
    months' neighbourhoods once, in one ``select_loo_neighbors`` call, as one
    ``xval_interp_daily`` call does; each candidate still brings back one
    transfer of S + 15 values."""
    calls = {"group_days_by_month": 0, "select_loo_neighbors": 0}
    sizes = []

    def counting(name):
        fn = getattr(txval, name)

        def counted(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return counted

    cpu = torch.Tensor.cpu

    def fetched(self, *a, **kw):
        sizes.append(self.numel())
        return cpu(self, *a, **kw)

    for name in calls:
        monkeypatch.setattr(txval, name, counting(name))
    monkeypatch.setattr(torch.Tensor, "cpu", fetched)
    base = InterpParams(k_neighbors=16, k_neighbors_anom=8)
    if route == "sweep":
        txval.optimize_nnghs_anoms(*st.krig(), st.anoms, st.month_idx, candidates=(8, 12, 16),
                                   base_params=base, device="cpu")
    else:
        txval.xval_interp_daily(*st.krig(), st.anoms, st.month_idx, base, "cpu")
    assert calls == {"group_days_by_month": 1, "select_loo_neighbors": 1}
    assert sizes == [len(st.lon) + 15] * (3 if route == "sweep" else 1)
