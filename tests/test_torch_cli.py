"""The port's pipeline CLI (``python -m topotpu_torch.cli``) against the JAX
package's (``topotpu.cli``), on the CPU (``TOPOTPU_PLATFORM=cpu``).

Both packages run ``all`` on ``tests/test_cli.py``'s config (2015, 24 x 24
tiles, ``--grid 24 --stations 40``), each into its own data_dir; the other
stages run on copies of those data_dirs, and each package runs on the other's
artifacts. The JAX side is called as ``tests/test_cli.py`` calls it.

Tolerances. The synthetic world, the QA flags and homogenisation are the
same numpy and C++ code in both packages: equal bit for bit (both networks
take the numpy branch of ``select_predictors``). The infill keeps every
observation bit for bit; its filled values part as
``tests/test_torch_infill.py`` lets ``infill_network`` part (1e-3 C on 99.9 %
of entries, 5e-3 C on all). The variograms are held as
``tests/test_torch_krig_params.py`` holds them, on the stations whose
neighbourhoods agree in both packages: fitted curves within 1 % of the sill
on at least 97 % of station-months, median sill and range within 1 %. The
decoded mosaics have the same finite cells and agree within 5e-2 C plus half
a lattice step on at least 99.9 % of them. Stage reports computed by float32
code on the same artifacts (x-val, validate-f64, point) are compared within
the bounds stated at each test, each a few times the difference measured on
an Intel Xeon host. About 100 s on one core.
"""

import contextlib
import dataclasses
import io
import json
import pathlib
import shutil

import h5py
import numpy as np
import pytest
import torch

from topotpu.cli import main as jmain
from topotpu.cli import steps as jsteps
from topotpu.core.config import TopoConfig as JConfig
from topotpu.geo.neighbors import select_neighbors as j_select
from topotpu_torch.cli import main as tmain
from topotpu_torch.cli import steps as tsteps
from topotpu_torch.core.config import TopoConfig
from topotpu_torch.dist import multihost
from topotpu_torch.geo.neighbors import select_neighbors
from topotpu_torch.io.ncdf import FILL_I16, read_var
from jax_pha_core import load_jax_pha

torch.set_num_threads(1)

CPU = torch.device("cpu")
STEP = 160.0 / 65500.0   # the run-global lattice of dailies and normals
VARS = ("tmin", "tmax")
ARGS = ["--grid", "24", "--stations", "40"]
HEAVY = ["synth-data", "qa", "homog", "infill", "krig-params"]


@pytest.fixture(autouse=True, scope="module")
def _cpu_and_jax_core():
    load_jax_pha()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TOPOTPU_PLATFORM", "cpu")
        yield


def _config(root, name, tile=24, **kw):
    cfg = TopoConfig(data_dir=str(root / name), start_date="2015-01-01",
                     end_date="2015-12-31", tile_rows=tile, tile_cols=tile, **kw)
    path = root / f"{name}.json"
    cfg.save(path)
    return path


def _run(main, argv):
    """(return code, the stage report lines) of one CLI call."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, [json.loads(x) for x in buf.getvalue().splitlines()]


def _by_stage(lines):
    return {x["stage"]: x["result"] for x in lines}


def _copy(src_cfg, root, name):
    """A copy of ``src_cfg``'s data_dir under ``name``, and its config."""
    cfg = TopoConfig.load(src_cfg)
    shutil.copytree(cfg.data_dir, root / name)
    path = root / f"{name}.json"
    dataclasses.replace(cfg, data_dir=str(root / name)).save(path)
    return path


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``all`` in each package: {"jax" | "port": (config path, report lines)}."""
    root = tmp_path_factory.mktemp("cli")
    out = {}
    for pkg, main in (("jax", jmain.main), ("port", tmain.main)):
        cfg = _config(root, pkg)
        rc, lines = _run(main, ["all", "--config", str(cfg)] + ARGS)
        assert rc == 0
        out[pkg] = (cfg, lines)
    out["root"] = root
    return out


def _data(runs, pkg):
    return TopoConfig.load(runs[pkg][0]).data_dir


def _h5(path, *names):
    with h5py.File(path) as f:
        return [f[n][...] for n in names]


# ------------------------------------------------------------------- all


def test_all_stage_list_and_reports_match_jax(runs):
    j, t = (_by_stage(runs[p][1]) for p in ("jax", "port"))
    assert [x["stage"] for x in runs["port"][1]] == [x["stage"] for x in runs["jax"][1]] \
        == ["synth-data", "qa", "homog", "infill", "krig-params", "interp", "mosaic",
            "validate"]
    for stage in ("synth-data", "qa", "homog", "interp", "mosaic"):
        assert t[stage] == j[stage], stage
    for var in VARS:
        assert t["infill"][var] == j["infill"][var]
        assert t["validate"][var] == j["validate"][var] and t["validate"][var]["status"] == "ok"
    assert t["validate"]["crossvar"] == j["validate"]["crossvar"]
    assert all(x["wall_s"] >= 0 for x in runs["port"][1])


def test_all_station_artifacts_match_jax(runs):
    jd, td = _data(runs, "jax"), _data(runs, "port")
    meta = [json.loads(pathlib.Path(d, "synth_meta.json").read_text()) for d in (td, jd)]
    assert meta[0] == meta[1]
    with h5py.File(f"{jd}/rasters.h5") as a, h5py.File(f"{td}/rasters.h5") as b:
        assert dict(a.attrs) == dict(b.attrs) and set(a) == set(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k][...], b[k][...], err_msg=k)
    for name in ("all_obs.h5", "homog.h5"):
        with h5py.File(f"{jd}/{name}") as a, h5py.File(f"{td}/{name}") as b:
            assert set(a["obs"]) == set(b["obs"]) and set(a["stn"]) == set(b["stn"])
            assert dict(a.attrs) == dict(b.attrs)
            for g in ("obs", "stn"):
                for k in a[g]:
                    assert a[g][k].dtype == b[g][k].dtype, (name, g, k)
                    np.testing.assert_array_equal(a[g][k][...], b[g][k][...],
                                                  err_msg=f"{name} {g}/{k}")
    for var in VARS:
        with h5py.File(f"{jd}/serial_{var}.h5") as a, h5py.File(f"{td}/serial_{var}.h5") as b:
            assert set(a["stn"]) == set(b["stn"]) and set(a["obs"]) == set(b["obs"]) == {var}
            for k in a["stn"]:
                assert a["stn"][k].dtype == b["stn"][k].dtype, k
            want, got = a["obs"][var][...], b["obs"][var][...]
            obs = _h5(f"{jd}/homog.h5", f"obs/{var}")[0]
            kept = np.isfinite(obs)
            np.testing.assert_array_equal(got[kept], want[kept])
            d = np.abs(got - want)
            assert np.quantile(d, 0.999) <= 1e-3 and d.max() <= 5e-3, (var, d.max())
            np.testing.assert_array_equal(b["stn"]["bad"][...], a["stn"]["bad"][...])
            np.testing.assert_allclose(b["stn"]["norm"][...], a["stn"]["norm"][...],
                                       rtol=0, atol=2e-4)
            for k in ("lon", "lat", "elev", "tdi", "lst", "stn_id"):
                np.testing.assert_array_equal(b["stn"][k][...], a["stn"][k][...])


def _same_neighbourhoods(lon, lat, k):
    """Stations whose k-neighbourhood (itself left out) is the same set in
    both packages."""
    import jax.numpy as jnp

    S = len(lon)
    T = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    J = lambda a: jnp.asarray(a, jnp.float32)  # noqa: E731
    valid = np.ones(S, bool)
    got = select_neighbors(T(lon), T(lat), T(lon), T(lat), torch.from_numpy(valid),
                           k=k, exclude_idx=torch.arange(S)).idx.numpy()
    want = np.asarray(j_select(J(lon), J(lat), J(lon), J(lat), jnp.asarray(valid), k=k,
                               exclude_idx=jnp.arange(S)).idx)
    return np.array([set(a) == set(b) for a, b in zip(got, want)])


def test_all_variograms_match_jax(runs):
    jd, td = _data(runs, "jax"), _data(runs, "port")
    k = min(TopoConfig().variogram.k_fit_neighbors, 39)
    for var in VARS:
        names = ("stn/vario_nug", "stn/vario_psill", "stn/vario_rng", "stn/lon", "stn/lat")
        *wv, lon, lat = _h5(f"{jd}/serial_{var}.h5", *names)
        gv = _h5(f"{td}/serial_{var}.h5", *names)[:3]
        wv = np.stack(wv, -1).astype(np.float64)
        gv = np.stack(gv, -1).astype(np.float64)
        same = _same_neighbourhoods(lon, lat, k)
        assert same.mean() >= 0.95
        sill = wv[..., 0] + wv[..., 1]
        h = np.linspace(0.0, 3.0 * np.median(wv[..., 2]), 31)
        curve = lambda v: v[..., 0, None] + v[..., 1, None] * (1 - np.exp(-h / v[..., 2, None]))  # noqa: E731
        rel = (np.abs(curve(gv) - curve(wv)).max(-1) / sill)[same]
        assert np.mean(rel <= 1e-2) >= 0.97, (var, np.mean(rel <= 1e-2))
        np.testing.assert_allclose(np.median((gv[..., 0] + gv[..., 1])[same]),
                                   np.median(sill[same]), rtol=1e-2)
        np.testing.assert_allclose(np.median(gv[..., 2][same]), np.median(wv[..., 2][same]),
                                   rtol=1e-2)


def _mosaic(d, var):
    return read_var(f"{d}/mosaic_{var}.h5", var)


def _assert_mosaics_close(got_dir, want_dir):
    for var in VARS:
        got, want = _mosaic(got_dir, var), _mosaic(want_dir, var)
        fin = np.isfinite(want)
        np.testing.assert_array_equal(np.isfinite(got), fin)
        d = np.abs(got - want)[fin]
        assert np.mean(d <= 5e-2 + STEP / 2) >= 0.999, (var, np.mean(d <= 5e-2 + STEP / 2))
        gn, wn = _h5(f"{got_dir}/mosaic_{var}.h5", "normal")[0], \
            _h5(f"{want_dir}/mosaic_{var}.h5", "normal")[0]
        np.testing.assert_array_equal(np.isfinite(gn), np.isfinite(wn))


def test_all_mosaics_match_jax(runs):
    jd, td = _data(runs, "jax"), _data(runs, "port")
    _assert_mosaics_close(td, jd)
    lo, hi = _mosaic(td, "tmin"), _mosaic(td, "tmax")
    fin = np.isfinite(lo)
    np.testing.assert_array_equal(fin, np.isfinite(hi))
    assert (hi[fin] >= lo[fin]).all()  # reconcile on the shared lattice
    for var in VARS:
        with h5py.File(f"{td}/mosaic_{var}.h5") as f, h5py.File(f"{jd}/mosaic_{var}.h5") as g:
            assert f[var].dtype == np.int16 and f.attrs["layout"] == "direct"
            assert bool(f.attrs["complete"]) and bool(f.attrs["reconciled"])
            for k in ("scale_factor", "add_offset"):
                assert f[var].attrs[k] == g[var].attrs[k]
            assert set(f) == set(g)
    assert not list((runs["root"] / "port" / "tiles").glob("*_tile*.h5"))


# ------------------------------------------------------------- the stages


def _both(runs, tmp, stage_args, name):
    """One stage in each package on a copy of its own ``all`` data_dir:
    {pkg: (data_dir, the stage's last report)}."""
    out = {}
    for pkg, main in (("jax", jmain.main), ("port", tmain.main)):
        cfg = _copy(runs[pkg][0], tmp, f"{name}_{pkg}")
        rc, lines = _run(main, [stage_args[0], "--config", str(cfg)] + stage_args[1:])
        assert rc == 0 and lines[-1]["stage"] == stage_args[0]
        out[pkg] = (TopoConfig.load(cfg).data_dir, lines[-1]["result"], cfg)
    return out


def test_aggregate_matches_jax_and_the_daily_mosaic(runs, tmp_path):
    res = _both(runs, tmp_path, ["aggregate"], "agg")
    for var in VARS:
        assert res["port"][1][var]["months"] == res["jax"][1][var]["months"] == 12
        assert res["port"][1][var]["years"] == res["jax"][1][var]["years"] == 1
    d = res["port"][0]
    with h5py.File(f"{d}/agg_tmin.h5") as f, h5py.File(f"{res['jax'][0]}/agg_tmin.h5") as g:
        assert f["monthly"].dtype == np.int16 and set(f) == set(g)
        for k in ("time_month", "year", "n_days", "n_days_year", "lat", "lon"):
            np.testing.assert_array_equal(f[k][...], g[k][...], err_msg=k)
        assert dict(f.attrs) == {**dict(g.attrs)}
        g_scale = float(f["monthly"].attrs["scale_factor"])
        t_m = f["time_month"][...]
    mon = read_var(f"{d}/agg_tmin.h5", "monthly")
    ann = read_var(f"{d}/agg_tmin.h5", "annual")
    assert mon.shape[0] == len(t_m) and ann.shape[0] == 1
    daily = _mosaic(d, "tmin")
    with h5py.File(f"{d}/mosaic_tmin.h5") as f:
        dates = np.datetime64("1948-01-01", "D") + f["time"][...].astype("timedelta64[D]")
    m0 = dates.astype("datetime64[M]") == dates[0].astype("datetime64[M]")
    for got, blk in ((mon[0], daily[m0]), (ann[0], daily)):
        ref = np.where(np.isfinite(blk).all(0), blk.mean(0), np.nan)
        np.testing.assert_array_equal(np.isfinite(ref), np.isfinite(got))
        assert np.abs(got - ref)[np.isfinite(ref)].max() <= g_scale + 1e-6


def test_aggregate_of_the_same_mosaic_is_bit_for_bit(runs, tmp_path):
    cfg = _copy(runs["jax"][0], tmp_path, "same")
    jsteps.step_aggregate(JConfig.load(cfg))
    want = {v: _h5(f"{tmp_path}/same/agg_{v}.h5", "monthly", "annual") for v in VARS}
    tsteps.step_aggregate(TopoConfig.load(cfg))
    for v in VARS:
        for a, b in zip(_h5(f"{tmp_path}/same/agg_{v}.h5", "monthly", "annual"), want[v]):
            np.testing.assert_array_equal(a, b)


# x-val scores of the two packages on the same serial DBs. The LOO normals of
# this dense world (3.6 km spacing) part by up to ~1e-2 C between two float32
# implementations at k = 32 (ROADMAP.md, "float32 conditioning in dense LOO
# neighbourhoods"); the scores are means over 40 stations (measured: at most
# 2e-4 C apart, 1e-3 C by month, as rounded to 4 decimals).
XVAL_TOL = 5e-3


def _on_jax_dbs(runs, tmp, argv, name):
    """One stage in each package on copies of the JAX ``all`` data_dir."""
    out = {}
    for pkg, main in (("jax", jmain.main), ("port", tmain.main)):
        cfg = _copy(runs["jax"][0], tmp, f"{name}_{pkg}")
        rc, lines = _run(main, [argv[0], "--config", str(cfg)] + argv[1:])
        assert rc == 0 and lines[-1]["stage"] == argv[0]
        out[pkg] = lines[-1]["result"]
    return out


def test_xval_interp_matches_jax(runs, tmp_path):
    res = _on_jax_dbs(runs, tmp_path, ["xval-interp"], "xvi")
    for var in VARS:
        t, j = res["port"][var], res["jax"][var]
        assert t["mae_mean"] < 1.5 and len(t["mae_by_month"]) == 12
        assert t["n_stations_scored"] == j["n_stations_scored"] > 0
        assert set(t["mae_by_region"]) == set(j["mae_by_region"]) == {"0"}
        for k in ("mae_mean", "bias_mean", "r2_mean"):
            assert abs(t[k] - j[k]) <= XVAL_TOL, (var, k, t[k], j[k])
        np.testing.assert_allclose(t["mae_by_month"], j["mae_by_month"], atol=XVAL_TOL)


def test_xval_daily_matches_jax(runs, tmp_path):
    res = _on_jax_dbs(runs, tmp_path, ["xval-daily"], "xvd")
    for var in VARS:
        t, j = res["port"][var], res["jax"][var]
        assert t["mae"] < 2.5 and t["rmse"] >= t["mae"] and len(t["mae_by_month"]) == 12
        assert t["mae_by_region"] and t["n_stations_scored"] == j["n_stations_scored"]
        for k in ("mae", "bias", "rmse"):
            assert abs(t[k] - j[k]) <= XVAL_TOL, (var, k, t[k], j[k])
        np.testing.assert_allclose(t["mae_by_month"], j["mae_by_month"], atol=XVAL_TOL)


def test_make_regions_and_optim_nnghs_match_jax(runs, tmp_path):
    res = {}
    for pkg, main in (("jax", jmain.main), ("port", tmain.main)):
        cfg = _copy(runs["jax"][0], tmp_path, f"nn_{pkg}")
        rc, lines = _run(main, ["make-regions", "--config", str(cfg), "--n-regions", "4"])
        assert rc == 0 and lines[-1]["result"]["n_regions"] >= 2
        rc, more = _run(main, ["optim-nnghs", "--config", str(cfg)])
        assert rc == 0
        res[pkg] = (lines[-1]["result"], more[-1]["result"], TopoConfig.load(cfg).data_dir)
    (jr, jn, jd), (tr, tn, td) = res["jax"], res["port"]
    assert {k: v for k, v in tr.items() if k != "path"} == \
        {k: v for k, v in jr.items() if k != "path"}
    np.testing.assert_array_equal(*(_h5(f"{d}/regions.h5", "regions")[0] for d in (td, jd)))
    for var in VARS:
        t, j = tn[var], jn[var]
        for key in ("best_k_by_region", "best_k_anom_by_region"):
            assert set(t[key]) == set(j[key]) == {"0", "1", "2", "3"}
        # the sweep's scores: k = 8 is the ill-conditioned end (measured 6.8e-3
        # C apart; 7.7e-4 C at k >= 16, 7.9e-3 C for the anomaly sweep at k = 8)
        for k, v in t["global_mae_by_k"].items():
            assert abs(v - j["global_mae_by_k"][k]) <= (2e-2 if k == "8" else XVAL_TOL), (var, k)
        for k, v in t["global_daily_mae_by_k_anom"].items():
            assert abs(v - j["global_daily_mae_by_k_anom"][k]) <= 2e-2, (var, k)
    with h5py.File(f"{td}/nnghs.h5") as f, h5py.File(f"{jd}/nnghs.h5") as g:
        assert set(f) == set(g) and list(f.attrs["candidates"]) == list(g.attrs["candidates"])
        np.testing.assert_array_equal(f["region_ids"][...], g["region_ids"][...])
        for k in f:
            assert f[k].dtype == g[k].dtype, k


def test_optim_nnghs_on_a_region_raster_then_interp_uses_it(runs, tmp_path):
    """Quadrant labels on the run grid give per-region k; interp then runs
    each tile at its region's k and reports the artifact."""
    cfg = _copy(runs["port"][0], tmp_path, "quad")
    reg = np.zeros((24, 24), np.int32)
    reg[:12, 12:] = 1
    reg[12:, :12] = 2
    reg[12:, 12:] = 3
    with h5py.File(tmp_path / "regions.h5", "w") as f:
        f.create_dataset("regions", data=reg)
    rc, lines = _run(tmain.main, ["optim-nnghs", "--config", str(cfg), "--regions",
                                  str(tmp_path / "regions.h5")])
    assert rc == 0
    got = set(lines[-1]["result"]["tmin"]["best_k_by_region"])
    assert got <= {"0", "1", "2", "3"} and len(got) >= 2
    assert set(lines[-1]["result"]["tmax"]["best_k_by_region"]) == got
    shutil.rmtree(tmp_path / "quad" / "tiles")
    rc, lines = _run(tmain.main, ["interp", "--config", str(cfg)])
    assert rc == 0
    rep = lines[-1]["result"]
    assert rep["tmin"] == rep["tmax"] == 1
    assert rep["nnghs"]["source"].endswith("nnghs.h5")
    assert rep["nnghs"]["tiles_with_optimized_k"] == 1
    man = json.loads((tmp_path / "quad" / "tiles" / "manifest.json").read_text())
    assert all("k" in e for e in man["tiles"].values())


def test_validate_f64_matches_jax(runs, tmp_path):
    res = _on_jax_dbs(runs, tmp_path, ["validate-f64"], "f64")
    for var in VARS:
        t, j = res["port"][var], res["jax"][var]
        assert t["within_parity_bar"] is True and j["within_parity_bar"] is True
        assert t["tiles"] == j["tiles"] == 1 and t["ok_flip_rate"] == j["ok_flip_rate"]
        # both float32 sides sit ~1e-3 C (rmse) from the same float64 run,
        # 6.4e-6 C apart (measured)
        for k in ("normal_rmse", "daily_rmse"):
            assert abs(t[k] - j[k]) <= 1e-4, (var, k, t[k], j[k])


def test_point_matches_the_grid_and_jax(runs, tmp_path):
    cs = 1.0 / 120.0
    sites = [(-106.0 + cs / 2 + 7 * cs, 41.0 - cs / 2 - 5 * cs),
             (-106.0 + cs / 2 + 15 * cs, 41.0 - cs / 2 - 11 * cs)]
    arg = "--points=" + ";".join(f"{x},{y}" for x, y in sites)
    res = _both(runs, tmp_path, ["point", arg], "pt")
    d = res["port"][0]
    for var in VARS:
        assert res["port"][1][var]["ok_sites"] == res["jax"][1][var]["ok_sites"] == 2
        np.testing.assert_allclose(res["port"][1][var]["annual_normal"],
                                   res["jax"][1][var]["annual_normal"], atol=2e-2)
    import csv

    with open(f"{d}/point_tmin_normals.csv") as f:
        rows = list(csv.reader(f))
    assert len(rows) == 3 and rows[0][2] == "norm_01"
    grid_norm = _h5(f"{d}/mosaic_tmin.h5", "normal")[0]
    for i, (r, c) in enumerate([(5, 7), (11, 15)]):
        got = np.array([float(v) for v in rows[1 + i][2:14]])
        np.testing.assert_allclose(got, grid_norm[:, r, c], atol=5e-3)
    with open(f"{d}/point_tmax_daily.csv") as f, \
            open(f"{res['jax'][0]}/point_tmax_daily.csv") as g:
        a, b = list(csv.reader(f)), list(csv.reader(g))
    assert a[0] == b[0] and len(a) == len(b) == 366
    np.testing.assert_allclose(np.array(a[1:])[:, 1:].astype(float),
                               np.array(b[1:])[:, 1:].astype(float), atol=6e-2)


def test_a_stage_with_trace_writes_the_trace_and_its_spans(runs, tmp_path):
    cfg = _copy(runs["port"][0], tmp_path, "traced")
    rc, lines = _run(tmain.main, ["krig-params", "--config", str(cfg),
                                  "--trace", str(tmp_path / "trace")])
    assert rc == 0 and lines[-1]["stage"] == "krig-params"
    spans = json.loads((tmp_path / "trace" / "spans.json").read_text())["spans"]
    names = [s["name"] for s in spans]
    assert names.count("params.krig_params") == 2 and names.count("variogram.fit") == 24
    events = json.loads((tmp_path / "trace" / "trace.json").read_text())["traceEvents"]
    ranges = [e["name"] for e in events if e.get("cat") == "user_annotation"]
    assert ranges.count("params.krig_params") == 2 and ranges.count("variogram.fit") == 24


def test_trace_in_a_job_of_several_processes_writes_a_file_a_rank(runs, tmp_path):
    """``interp --trace DIR`` started once a process of a two-process job:
    each process writes its own trace and span file, named by its
    ``--process-id``, with its rendezvous span keyed by its index; neither
    overwrites the other's."""
    import os
    import socket
    import subprocess
    import sys

    cfg = _copy(runs["port"][0], tmp_path, "ranks")
    data = pathlib.Path(TopoConfig.load(cfg).data_dir)
    shutil.rmtree(data / "tiles")
    for f in data.glob("mosaic_*"):
        f.unlink()
    trace = tmp_path / "trace"
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    sock.listen()
    coordinator = f"127.0.0.1:{sock.getsockname()[1]}"
    env = dict(os.environ, TOPOTPU_PLATFORM="cpu", OMP_NUM_THREADS="1")
    procs = []
    try:
        for i in range(2):
            fd = {multihost.COORDINATOR_FD_ENV: str(sock.fileno())} if i == 0 else {}
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "topotpu_torch.cli", "interp", "--config", str(cfg),
                 "--trace", str(trace), "--coordinator", coordinator, "--num-processes", "2",
                 "--process-id", str(i)],
                cwd=pathlib.Path(__file__).resolve().parents[1], env=dict(env, **fd),
                pass_fds=(sock.fileno(),) if i == 0 else (), stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
        outs = [proc.communicate(timeout=120)[0] for proc in procs]
    finally:
        sock.close()
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    for i, (proc, out) in enumerate(zip(procs, outs)):
        assert proc.returncode == 0, f"process {i} exited {proc.returncode}:\n{out[-3000:]}"
    assert sorted(f.name for f in trace.iterdir()) == [
        "spans_p000.json", "spans_p001.json", "trace_p000.json", "trace_p001.json"]
    for i in range(2):
        spans = json.loads((trace / f"spans_p{i:03d}.json").read_text())["spans"]
        assert [sp["key"] for sp in spans if sp["name"] == "multihost.init"] == [i]
        events = json.loads((trace / f"trace_p{i:03d}.json").read_text())["traceEvents"]
        assert "multihost.init" in {e["name"] for e in events if e.get("cat") == "user_annotation"}


def test_a_rank_takes_its_card_before_its_trace_opens(monkeypatch, tmp_path):
    """A process of a job over several processes makes its share of the
    host's GPUs current (``multihost.local_devices``, given its
    ``--process-id`` and ``--num-processes``) before ``--trace`` starts the
    profiler, which opens a context on the current device; a one-process
    run and a host-only stage take no card."""
    import contextlib

    from topotpu_torch.utils import profiling

    calls = []

    @contextlib.contextmanager
    def trace(log_dir, tag=""):
        calls.append(("trace", tag))
        yield []

    monkeypatch.setattr(multihost, "local_devices", lambda i, n: calls.append(("card", i, n)))
    monkeypatch.setattr(profiling, "device_trace", trace)
    monkeypatch.setattr(tmain, "_stages", lambda ap, args: calls.append(("stages",)) or 0)
    job = ["--coordinator", "127.0.0.1:1", "--num-processes", "4", "--process-id", "1"]
    assert tmain.main(["interp", *job, "--trace", str(tmp_path)]) == 0
    assert calls == [("card", 1, 4), ("trace", "_p001"), ("stages",)]
    calls.clear()
    assert tmain.main(["interp", *job]) == 0
    assert calls == [("card", 1, 4), ("stages",)]
    calls.clear()
    assert tmain.main(["interp", "--trace", str(tmp_path)]) == 0
    assert calls == [("trace", ""), ("stages",)]
    calls.clear()
    assert tmain.main(["mosaic", *job]) == 0
    assert calls == [("stages",)]


def test_point_rejects_out_of_grid_sites(tmp_path):
    cfg = TopoConfig(data_dir=str(tmp_path / "data"), start_date="2015-01-01",
                     end_date="2015-01-31", tile_rows=24, tile_cols=24)
    tsteps.step_synth_data(cfg, nrows=24, ncols=24, n_stations=30)
    with pytest.raises(ValueError, match="outside the run's grid"):
        tsteps.step_point(cfg, [(0.0, 0.0)], device=CPU)


def test_mosaic_refuses_to_publish_empty(tmp_path):
    cfg = TopoConfig(data_dir=str(tmp_path / "data"), start_date="2015-01-01",
                     end_date="2015-01-31", tile_rows=24, tile_cols=24)
    tsteps.step_synth_data(cfg, nrows=24, ncols=24, n_stations=30)
    (tmp_path / "data" / "tiles").mkdir()
    for v in VARS:
        (tmp_path / "data" / f"mosaic_{v}.h5").write_bytes(b"precious")
    with pytest.raises(RuntimeError, match="no tile files"):
        tsteps.step_mosaic(cfg)
    for v in VARS:
        assert (tmp_path / "data" / f"mosaic_{v}.h5").read_bytes() == b"precious"
        assert not (tmp_path / "data" / f"mosaic_{v}.tmp").exists()


def test_mosaic_of_process_shards_raises_until_ported(tmp_path):
    """Manifests that claim tiles in process shards send the mosaic stage to
    the shard assembly; with no shard on disk it raises the JAX package's
    message, and publishes nothing."""
    cfg = TopoConfig(data_dir=str(tmp_path / "data"), start_date="2015-01-01",
                     end_date="2015-01-31", tile_rows=24, tile_cols=24)
    tsteps.step_synth_data(cfg, nrows=24, ncols=24, n_stations=30)
    tiles = tmp_path / "data" / "tiles"
    tiles.mkdir()
    man = {"tiles": {"tmin_00000": {"file": "mosaic_tmin_p000.h5", "ts": 1.0}}}
    (tiles / "manifest_p000.json").write_text(json.dumps(man))
    assert tsteps._latest_layout(tiles) is None  # not merged yet
    with pytest.raises(RuntimeError, match=r"no mosaic_tmin_p\*\.h5 shards found"):
        tsteps.step_mosaic(cfg)
    assert tsteps._latest_layout(tiles) == "shard"
    assert not any((tmp_path / "data" / f"mosaic_{v}.h5").exists() for v in VARS)


def test_validate_day_axis_mismatch_fails_loudly(tmp_path):
    from topotpu_torch.core.dates import get_days_metadata
    from topotpu_torch.io.rasters import RasterStack
    from topotpu_torch.io.synthetic import make_world

    days = get_days_metadata("2015-01-01", "2015-02-28")
    world = make_world(np.random.default_rng(7), nrows=8, ncols=8, n_stations=10,
                       ndays=days.ndays)
    RasterStack.from_world(world).save(tmp_path / "rasters.h5")
    for var, nd in (("tmin", days.ndays), ("tmax", days.ndays - 10)):
        with h5py.File(tmp_path / f"mosaic_{var}.h5", "w") as f:
            f.create_dataset(var, data=np.zeros((nd, 8, 8), np.float32))
            for name in ("normal", "se"):
                f.create_dataset(name, data=np.zeros((12, 8, 8), np.float32))
    cfg = dataclasses.replace(TopoConfig(), data_dir=str(tmp_path),
                              start_date="2015-01-01", end_date="2015-02-28")
    with pytest.raises(RuntimeError, match="day-axis mismatch"):
        tsteps.step_validate(cfg)


def test_validate_deep_and_streamed_find_a_hole(runs, tmp_path):
    """A hole punched at an arbitrary day flips the deep validate to
    incomplete and makes the streamed one refuse, in both packages."""
    cfg = _copy(runs["port"][0], tmp_path, "hole")
    with h5py.File(tmp_path / "hole" / "mosaic_tmin.h5", "r+") as f:
        d = f["tmin"]
        sl = d[17]
        sl[sl != FILL_I16] = FILL_I16
        d[17] = sl
    for steps, Cfg in ((tsteps, TopoConfig), (jsteps, JConfig)):
        val = steps.step_validate(Cfg.load(cfg), deep=True)
        assert val["tmin"]["status"] == "incomplete" and val["tmin"]["daily_coverage"] < 0.01
        assert val["tmax"]["status"] == "ok"
        with pytest.raises(RuntimeError, match="disagrees with the product"):
            steps.step_validate(Cfg.load(cfg))


def test_cli_xval_infill_per_variable(runs, tmp_path):
    """Both variables straight off the all-obs DB (no homog artifact)."""
    res = {}
    for pkg, main in (("jax", jmain.main), ("port", tmain.main)):
        cfg = _config(tmp_path, f"xi_{pkg}")
        assert _run(main, ["synth-data", "--config", str(cfg)] + ARGS)[0] == 0
        rc, lines = _run(main, ["xval-infill", "--config", str(cfg)])
        assert rc == 0 and lines[-1]["stage"] == "xval-infill"
        res[pkg] = lines[-1]["result"]
    for var in VARS:
        t, j = res["port"][var], res["jax"][var]
        assert t["n_holdout"] == j["n_holdout"] > 0
        assert t["mae"] < 3.0 and abs(t["bias"]) < 0.5
        for k in ("mae", "bias", "rmse"):  # tests/test_torch_infill.py's x-val bound
            assert abs(t[k] - j[k]) <= 1e-4, (var, k)


def _write_packed(path, name, data, lo, hi):
    scale = (hi - lo) / 65500.0
    off = 0.5 * (hi + lo)
    q = np.round((data - off) / scale).astype(np.int16)
    with h5py.File(path, "w") as f:
        v = f.create_dataset(name, data=q)
        v.attrs["scale_factor"] = np.float32(scale)
        v.attrs["add_offset"] = np.float32(off)
        v.attrs["_FillValue"] = FILL_I16
    return scale


def _reconcile_both(tmp_path, write, time_chunk):
    """Both packages' reconcile on the same two files: (port result, its
    arrays), after checking that the JAX package's equal them."""
    out = {}
    for pkg, fn in (("jax", jsteps.reconcile_cross_variable),
                    ("port", tsteps.reconcile_cross_variable)):
        pn, px = tmp_path / f"{pkg}_mosaic_tmin.h5", tmp_path / f"{pkg}_mosaic_tmax.h5"
        write(pn, px)
        res = fn(pn, px, time_chunk=time_chunk)
        out[pkg] = (res, read_var(pn, "tmin"), read_var(px, "tmax"))
    assert out["port"][0] == out["jax"][0]
    for a, b in zip(out["port"][1:], out["jax"][1:]):
        np.testing.assert_array_equal(a, b)
    return out["port"]


def test_reconcile_cross_variable_packed(tmp_path):
    rng = np.random.default_rng(7)
    tmin = np.clip(rng.normal(0, 1, (32, 4, 4)), -5, 5).astype(np.float32)
    tmax = tmin + 2.0
    tmin[3, 1, 1], tmax[3, 1, 1] = 16.0, 4.0  # midpoint 10 > tmax's range top
    scales = {}

    def write(pn, px):
        scales["n"] = _write_packed(pn, "tmin", tmin, -20.0, 20.0)
        scales["x"] = _write_packed(px, "tmax", tmax, -8.0, 8.0)

    res, a, b = _reconcile_both(tmp_path, write, 8)
    assert res["violations"] == 1
    assert np.isfinite(b[3, 1, 1]) and abs(b[3, 1, 1] - 8.0) < 0.01
    assert abs(a[3, 1, 1] - 10.0) < 0.01
    assert np.isfinite(a).all() and np.isfinite(b).all()
    keep = np.ones(a.shape, bool)
    keep[3, 1, 1] = False
    np.testing.assert_allclose(a[keep], tmin[keep], atol=2 * scales["n"])
    np.testing.assert_allclose(b[keep], tmax[keep], atol=2 * scales["x"])


def test_reconcile_cross_variable(tmp_path):
    rng = np.random.default_rng(5)
    tmin = rng.normal(0, 5, (100, 8, 8)).astype(np.float32)
    tmax = tmin + 8.0
    tmin[3, 2, 2], tmax[3, 2, 2] = 10.0, 7.0    # crossing of 3.0 C
    tmax[40, 5, 1] = tmin[40, 5, 1] - 0.25      # sub-noise crossing
    tmin[7, 0, 0] = np.nan                       # masked cells stay masked
    tmax[9, 1, 1] = np.nan

    def write(pn, px):
        for path, name, data in ((pn, "tmin", tmin), (px, "tmax", tmax)):
            with h5py.File(path, "w") as f:
                f.create_dataset(name, data=data)

    res, a, b = _reconcile_both(tmp_path, write, 16)
    assert res["violations"] == 2 and abs(res["worst_crossing_C"] - 3.0) < 1e-6
    assert abs(a[3, 2, 2] - 8.5) < 1e-6 and abs(b[3, 2, 2] - 8.5) < 1e-6
    fin = np.isfinite(a) & np.isfinite(b)
    assert (b[fin] >= a[fin]).all()
    assert np.isnan(a[7, 0, 0]) and np.isnan(b[9, 1, 1])
    assert abs(b[50, 3, 3] - (a[50, 3, 3] + 8.0)) < 1e-6


# ------------------------------------------------------------------ resume


def _skipped(r):
    return isinstance(r, str) and r.startswith("skipped")


def test_all_stage_resume(runs, tmp_path):
    """A second identical ``all`` skips every completed stage; a missing
    mid-chain artifact re-runs that stage and everything after it; --redo
    re-runs all; another world in the same data_dir raises."""
    cfg = _copy(runs["port"][0], tmp_path, "resume")
    args = ["all", "--config", str(cfg)] + ARGS
    data = tmp_path / "resume"
    artifacts = [data / "homog.h5", data / "serial_tmin.h5", data / "serial_tmax.h5",
                 data / "all_obs.h5"]
    mtimes = {a: a.stat().st_mtime_ns for a in artifacts}

    rc, lines = _run(tmain.main, args)
    second = _by_stage(lines)
    assert rc == 0 and all(_skipped(second[s]) for s in HEAVY)
    assert {a: a.stat().st_mtime_ns for a in artifacts} == mtimes
    assert second["validate"]["tmin"]["status"] == "ok"

    (data / "homog.h5").unlink()
    rc, lines = _run(tmain.main, args)
    third = _by_stage(lines)
    assert rc == 0 and _skipped(third["synth-data"]) and _skipped(third["qa"])
    assert not any(_skipped(third[s]) for s in ("homog", "infill", "krig-params"))
    assert third["validate"]["tmin"]["status"] == "ok"

    rc, lines = _run(tmain.main, args + ["--redo"])
    assert rc == 0 and not any(_skipped(_by_stage(lines)[s]) for s in HEAVY)

    with pytest.raises(ValueError, match="different synthetic world"):
        tmain.main(["all", "--config", str(cfg), "--grid", "24", "--stations", "48"])


# ------------------------------------------------------ across the packages


def test_port_finishes_a_jax_data_dir(runs, tmp_path):
    """The port's ``all`` on the JAX package's data_dir skips every finished
    stage; its interp on the JAX serial DBs gives the JAX product."""
    cfg = _copy(runs["jax"][0], tmp_path, "j2t")
    rc, lines = _run(tmain.main, ["all", "--config", str(cfg)] + ARGS)
    res = _by_stage(lines)
    assert rc == 0 and all(_skipped(res[s]) for s in HEAVY)
    assert res["validate"]["tmin"]["status"] == res["validate"]["tmax"]["status"] == "ok"
    for p in [tmp_path / "j2t" / "tiles"] + list((tmp_path / "j2t").glob("mosaic_*.h5")):
        shutil.rmtree(p) if p.is_dir() else p.unlink()
    for stage in ("interp", "mosaic", "validate"):
        rc, lines = _run(tmain.main, [stage, "--config", str(cfg)])
        assert rc == 0
    assert lines[-1]["result"]["tmin"]["status"] == "ok"
    _assert_mosaics_close(tmp_path / "j2t", _data(runs, "jax"))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_product_stages_accept_the_other_packages_product(runs, tmp_path, writer):
    reader = "port" if writer == "jax" else "jax"
    main = tmain.main if reader == "port" else jmain.main
    cfg = _copy(runs[writer][0], tmp_path, "x")
    want = {s: _by_stage(runs[writer][1])[s] for s in ("mosaic", "validate")}
    for stage in ("mosaic", "validate"):
        rc, lines = _run(main, [stage, "--config", str(cfg)])
        assert rc == 0 and lines[-1]["result"] == want[stage]
    rc, lines = _run(main, ["aggregate", "--config", str(cfg)])
    assert rc == 0 and lines[-1]["result"]["tmax"]["months"] == 12


def test_bit_rot_message_is_the_jax_packages(runs, tmp_path):
    """A corrupted chunk of the daily mosaic: both packages' validate raise
    the same message."""
    cfg = _copy(runs["port"][0], tmp_path, "rot")
    path = tmp_path / "rot" / "mosaic_tmin.h5"
    with h5py.File(path) as f:
        info = f["tmin"].id.get_chunk_info(3)
    with open(path, "r+b") as fh:
        fh.seek(info.byte_offset + info.size // 2)
        b = fh.read(8)
        fh.seek(info.byte_offset + info.size // 2)
        fh.write(bytes(x ^ 0xFF for x in b))
    msgs = []
    for steps, Cfg in ((tsteps, TopoConfig), (jsteps, JConfig)):
        with pytest.raises(RuntimeError, match="fletcher32 chunk-checksum mismatch") as e:
            steps.step_validate(Cfg.load(cfg), deep=True)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    assert str(tsteps._bit_rot_error(OSError("x"))) == str(jsteps._bit_rot_error(OSError("x")))


# ----------------------------------------------------------- device, hosts


def test_no_cpu_fallback_without_a_gpu(runs, tmp_path, monkeypatch):
    monkeypatch.delenv("TOPOTPU_PLATFORM")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _copy(runs["port"][0], tmp_path, "nogpu")
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        tmain.main(["interp", "--config", str(cfg)])
    monkeypatch.setenv("TOPOTPU_PLATFORM", "cpu")
    assert tmain._device() == CPU


def test_host_stages_need_no_gpu(runs, tmp_path, monkeypatch):
    """The stages that never reach the device run with no GPU and no
    TOPOTPU_PLATFORM, as the JAX package's run anywhere."""
    monkeypatch.delenv("TOPOTPU_PLATFORM")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _copy(runs["port"][0], tmp_path, "host")
    want = _by_stage(runs["port"][1])
    for stage in ("qa", "mosaic", "validate", "aggregate", "make-regions"):
        rc, lines = _run(tmain.main, [stage, "--config", str(cfg)])
        assert rc == 0 and lines[-1]["stage"] == stage
        if stage in ("qa", "mosaic", "validate"):
            assert lines[-1]["result"] == want[stage]


def test_multihost_host_side(tmp_path):
    assert multihost.init_multihost() == multihost.MultihostContext()
    assert multihost.init_multihost(None, 1, 0) == multihost.MultihostContext()
    for args, msg in (((None, 4, 1), "needs --coordinator"),
                      (("localhost:1234", 2, None), "needs --coordinator"),
                      (("localhost:1234", 2, 2), r"not in \[0, 2\)"),
                      (("localhost", 2, 0), "is not host:port")):
        with pytest.raises(ValueError, match=msg):
            multihost.init_multihost(*args)
    with pytest.raises(ValueError, match="needs --coordinator"):
        tmain.main(["interp", "--num-processes", "2", "--process-id", "0",
                    "--data-dir", str(tmp_path / "none")])

    @dataclasses.dataclass
    class Spec:
        tile_id: int

    tiles = [Spec(i) for i in range(7)]
    ctx = multihost.MultihostContext(process_index=1, process_count=3)
    assert [t.tile_id for t in multihost.partition_tiles(tiles, ctx)] == [1, 4]
    assert ctx.manifest_name() == "manifest_p001.json"

    assert multihost.merge_manifests(tmp_path) == {"tiles": {}}
    for i, keys in enumerate((["tmin_00000", "tmax_00000"], ["tmin_00001"])):
        (tmp_path / f"manifest_p{i:03d}.json").write_text(
            json.dumps({"tiles": {k: {"file": "f", "ts": 1.0} for k in keys}}))
    merged = multihost.merge_manifests(tmp_path)
    assert sorted(merged["tiles"]) == ["tmax_00000", "tmin_00000", "tmin_00001"]
    assert json.loads((tmp_path / "manifest.json").read_text()) == merged
    (tmp_path / "manifest_p002.json").write_text(
        json.dumps({"tiles": {"tmin_00001": {"file": "f", "ts": 2.0}}}))
    with pytest.raises(RuntimeError, match="claimed by two processes"):
        multihost.merge_manifests(tmp_path)
