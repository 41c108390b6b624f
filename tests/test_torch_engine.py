"""The port's production engine against the JAX package's, on the CPU.

The world of ``tests/test_direct_mosaic.py``: 48 x 48 cells, 60 stations,
seed 43, 2014-2015, 24 x 24 tiles (4 land tiles), k = 16, a 64-station pool;
var B = var A's normals + 9 C with anomalies x 0.85. Both engines get the
same numpy inputs; the JAX engine runs once per mode (module fixtures) on
the test harness's CPU mesh, the port's on ``torch.device("cpu")``, where
its step takes the kernels' plain versions.

Tolerances. The products are compared on their int16 lattices as
``tests/test_torch_point.py`` compares step buffers: identical fill
positions; dailies and normals within one lattice step + 1e-2 C, se within
one step + 2e-3 C. One corner cell of this world, (39, 47), has a nearly
collinear trend design: there the two float32 implementations part by up
to 2.0e-2 C in one month, each up to ~2e-2 C from the float64 oracle (its
December normal: port 2.1e-2 C, JAX 1.4e-3 C from float64; October 7.5e-3
against 7.2e-3 C). So at most 0.1 % of the values may lie outside the
bound, and every value lies within 3e-2 C. What the port writes twice on
the same inputs (resume, the in-memory mosaic) is compared bit for bit.
"""

import dataclasses
import json
import pathlib
import sys

import h5py
import numpy as np
import pytest
import torch

from topotpu.core.config import InterpParams as JInterp
from topotpu.core.config import MeshParams, TopoConfig as JConfig
from topotpu.core.dates import get_days_metadata as jdays
from topotpu.dist import engine as jengine
from topotpu.io.rasters import RasterStack as JRasters
from topotpu.io.synthetic import make_world
from topotpu_torch.core.config import InterpParams, TopoConfig
from topotpu_torch.core.dates import get_days_metadata
from topotpu_torch.dist import engine as tengine
from topotpu_torch.io.rasters import RasterStack

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
from chip_smoke import MemoryMosaic  # noqa: E402

torch.set_num_threads(1)

CPU = torch.device("cpu")
STEP = 160.0 / 65500.0     # the run-global lattice of dailies and normals
SE_STEP = 32.0 / 65500.0
VARS = ("tmin", "tmax")
K_TABLE = {1: {"tmin": (12, 8), "tmax": (16, 12)}}


@pytest.fixture(scope="module")
def world():
    days = jdays("2014-01-01", "2015-12-31")
    w = make_world(np.random.default_rng(43), nrows=48, ncols=48, n_stations=60,
                   ndays=days.ndays)
    nug, ps, rg = w.true_vario
    fields = dict(
        lon=w.stn_lon, lat=w.stn_lat, elev=w.stn_elev, tdi=w.stn_tdi, lst=w.stn_lst,
        norm=w.stn_norm, vario=np.tile(np.array([nug, ps, rg], np.float32), (60, 12, 1)),
        valid=np.ones((60, 12), bool), anoms=w.stn_anoms.astype(np.float32),
    )
    sets = {}
    for pkg, cls in (("jax", jengine.StationSet), ("port", tengine.StationSet)):
        a = cls(**fields)
        b = dataclasses.replace(a, norm=a.norm + 9.0, anoms=(a.anoms * 0.85).astype(np.float32))
        sets[pkg] = (a, b)
    return w, sets


def _engine(pkg, world, out, direct=True, **kw):
    """An engine of ``pkg`` ("jax" or "port") on the test world writing under
    ``out`` (direct mode: mosaics there, manifests in out/tiles)."""
    w, _ = world
    out.mkdir(parents=True, exist_ok=True)
    mosaics = {v: out / f"mosaic_{v}.h5" for v in VARS} if direct else None
    cls = kw.pop("cls", None)
    fields = dict(start_date="2014-01-01", end_date="2015-12-31", tile_rows=24, tile_cols=24)
    fields.update(kw.pop("config", {}))
    if pkg == "jax":
        fields.setdefault("interp", JInterp(k_neighbors=16, max_tile_stations=64))
        cfg = JConfig(mesh=MeshParams(n_devices=8), **fields)
        return (cls or jengine.TileEngine)(cfg, JRasters.from_world(w),
                                           jdays("2014-01-01", "2015-12-31"), out / "tiles",
                                           mosaic_paths=mosaics, **kw)
    fields.setdefault("interp", InterpParams(k_neighbors=16, max_tile_stations=64))
    cfg = TopoConfig(**fields)
    return (cls or tengine.TileEngine)(cfg, RasterStack.from_world(w),
                                       get_days_metadata("2014-01-01", "2015-12-31"),
                                       out / "tiles", device=CPU, mosaic_paths=mosaics, **kw)


def _run_pair(pkg, world, out, **kw):
    a, b = world[1][pkg]
    return _engine(pkg, world, out, **kw).run_pair("tmin", "tmax", a, b, progress=False)


@pytest.fixture(scope="module")
def runs(world, tmp_path_factory):
    """Each mode run once by both engines: {mode: {pkg: out dir}}."""
    root = tmp_path_factory.mktemp("engines")
    out = {}
    for pkg in ("jax", "port"):
        a, b = world[1][pkg]
        d = root / pkg
        assert _run_pair(pkg, world, d / "direct") == {"tmin": 4, "tmax": 4}
        assert _run_pair(pkg, world, d / "tiles", direct=False) == {"tmin": 4, "tmax": 4}
        assert _run_pair(pkg, world, d / "ktab", k_table=K_TABLE) == {"tmin": 4, "tmax": 4}
        eng = _engine(pkg, world, d / "chunked")
        assert eng.run_production_pair("tmin", "tmax", a, b, years_per_chunk=1,
                                       progress=False) == {"tmin": 8, "tmax": 8}
        for mode in ("direct", "tiles", "ktab", "chunked"):
            out.setdefault(mode, {})[pkg] = d / mode
    return out


# ----------------------------------------------------------------- helpers
def _within(got, want, step, tol, what):
    """The module docstring's rule on two float arrays with NaN fills."""
    assert np.array_equal(np.isnan(got), np.isnan(want)), f"{what}: fill positions"
    err = np.abs(np.asarray(got, np.float64) - want)[~np.isnan(want)]
    assert np.mean(err > step + tol) <= 1e-3, (what, np.mean(err > step + tol))
    assert err.max() <= 3e-2, (what, err.max())


def _daily(raw, step=STEP):
    return np.where(raw == -32768, np.nan, raw.astype(np.float64) * step)


def _mosaic(path, var):
    with h5py.File(path) as f:
        return (f[var][...], f["normal"][...], f["se"][...],
                {k: v.item() if hasattr(v, "item") else v for k, v in f.attrs.items()})


def _mosaics_close(got_dir, want_dir):
    for var in VARS:
        d_g, n_g, s_g, attrs_g = _mosaic(got_dir / f"mosaic_{var}.h5", var)
        d_w, n_w, s_w, attrs_w = _mosaic(want_dir / f"mosaic_{var}.h5", var)
        assert attrs_g == attrs_w
        _within(_daily(d_g), _daily(d_w), STEP, 1e-2, f"{var} daily")
        _within(n_g, n_w, STEP, 1e-2, f"{var} normal")
        _within(s_g, s_w, SE_STEP, 2e-3, f"{var} se")


def _manifest(path):
    tiles = json.loads(path.read_text())["tiles"]
    for info in tiles.values():
        del info["ts"]
    return tiles


def _manifests_equal(got_dir, want_dir):
    names = sorted(p.relative_to(want_dir) for p in want_dir.rglob("manifest.json"))
    assert names == sorted(p.relative_to(got_dir) for p in got_dir.rglob("manifest.json"))
    assert names
    for name in names:
        assert _manifest(got_dir / name) == _manifest(want_dir / name), name


def _mosaics_equal(got_dir, want_dir):
    for var in VARS:
        for g, w in zip(_mosaic(got_dir / f"mosaic_{var}.h5", var),
                        _mosaic(want_dir / f"mosaic_{var}.h5", var)):
            if isinstance(w, dict):
                assert g == w
            else:
                np.testing.assert_array_equal(g, w)


# ------------------------------------------------------------------- cases
def test_direct_run_pair_matches_jax(runs):
    got, want = runs["direct"]["port"], runs["direct"]["jax"]
    _mosaics_close(got, want)
    _manifests_equal(got / "tiles", want / "tiles")
    man = _manifest(got / "tiles" / "manifest.json")
    assert len(man) == 8 and all(e["verify"]["viol"] == 0 for e in man.values())
    assert not list((got / "tiles").glob("*_tile*.h5"))  # the mosaic is the output


def test_two_step_tile_files_match_jax(runs):
    got, want = runs["tiles"]["port"] / "tiles", runs["tiles"]["jax"] / "tiles"
    _manifests_equal(got, want)
    for var in VARS:
        for tile in range(4):
            name = f"{var}_tile{tile:05d}.h5"
            with h5py.File(got / name) as fg, h5py.File(want / name) as fw:
                for ds, tol in ((var, 1e-2), (f"{var}_normal", 1e-2), (f"{var}_se", 2e-3)):
                    g, w = fg[ds], fw[ds]
                    assert g.shape == w.shape and g.dtype == w.dtype == np.int16
                    step = (float(g.attrs["scale_factor"]) + float(w.attrs["scale_factor"])) / 2
                    dec = lambda d: np.where(d[...] == -32768, np.nan,  # noqa: E731
                                             d[...] * float(d.attrs["scale_factor"])
                                             + float(d.attrs["add_offset"]))
                    _within(dec(g), dec(w), step, tol, f"{name} {ds}")
                for key in ("lat", "lon", "time", "mth"):
                    np.testing.assert_array_equal(fg[key][...], fw[key][...])


def test_chunked_production_matches_jax_and_the_full_span(runs):
    got, want = runs["chunked"]["port"], runs["chunked"]["jax"]
    _mosaics_close(got, want)
    _manifests_equal(got / "tiles", want / "tiles")
    assert sorted(p.name for p in (got / "tiles").iterdir() if p.is_dir()) == [
        "chunk_2014_2014", "chunk_2015_2015"]
    full = runs["direct"]["port"]
    for var in VARS:
        d_c, n_c, _, attrs = _mosaic(got / f"mosaic_{var}.h5", var)
        d_f, n_f, _, _ = _mosaic(full / f"mosaic_{var}.h5", var)
        assert attrs["complete"] and attrs["reconciled"] and d_c.shape[0] == 730
        np.testing.assert_array_equal(d_c == -32768, d_f == -32768)
        # same lattice; the chunks' anomaly windows differ only by rounding
        assert np.abs(d_c.astype(np.int32) - d_f).max() <= 1
        np.testing.assert_allclose(np.nan_to_num(n_c), np.nan_to_num(n_f), atol=1e-4)


def test_k_table_per_variable_k_matches_jax(runs):
    got, want = runs["ktab"]["port"], runs["ktab"]["jax"]
    _manifests_equal(got / "tiles", want / "tiles")
    man = _manifest(got / "tiles" / "manifest.json")
    assert man["tmin_00001"]["k"] == [12, 8] and man["tmax_00001"]["k"] == [16, 12]
    assert "k" not in man["tmin_00000"]
    _mosaics_close(got, want)
    # the per-variable sizes reached the product: tile 1 differs from the
    # default-k run, the other tiles do not
    d_k, *_ = _mosaic(got / "mosaic_tmin.h5", "tmin")
    d_d, *_ = _mosaic(runs["direct"]["port"] / "mosaic_tmin.h5", "tmin")
    assert not np.array_equal(d_k[:, :24, 24:], d_d[:, :24, 24:])
    np.testing.assert_array_equal(d_k[:, 24:], d_d[:, 24:])


def test_nnghs_table_of_block_regions_gives_each_tile_its_block():
    """``cli/steps.py::_nnghs_table_core`` on a raster of 16 regions, each a
    block of 2 x 2 tiles numbered row-major (the layout of the benchmark's
    ``grid.optim-k``): every tile takes its block's (k, ka) of each
    variable, the region ids mapped to their places in ``ids``."""
    from topotpu_torch.cli.steps import _nnghs_table_core
    from topotpu_torch.core.grid import GridSpec

    n = 256  # 8 x 8 tiles of 32 x 32
    grid = GridSpec(lon0=-106.0, lat0=41.0, cellsize=1 / 120, nrows=n, ncols=n)
    flat = np.zeros((n, n), np.float32)
    rasters = RasterStack(grid, flat, flat, np.zeros((12, n, n), np.float32),
                          np.ones((n, n), bool))
    cfg = TopoConfig(tile_rows=32, tile_cols=32)
    r, c = np.ogrid[:n, :n]
    reg = ((r // 64) * 4 + c // 64 + 100).astype(np.int32)
    kn, ka = np.array([16, 24, 32, 48] * 4), np.repeat([8, 16, 24, 32], 4)
    ks = {"tmin": (kn, ka), "tmax": (np.roll(kn, -5), np.roll(ka, -5))}
    table = _nnghs_table_core(reg, np.arange(16) + 100, ks, rasters, cfg)
    assert sorted(table) == list(range(64))
    for tid, ent in table.items():
        ti, tj = divmod(tid, 8)
        b = (ti // 2) * 4 + tj // 2
        nb = (b + 5) % 16
        assert ent == {"tmin": (kn[b], ka[b]), "tmax": (kn[nb], ka[nb])}, tid


@pytest.mark.parametrize("direct", [True, False])
def test_two_shard_mesh_equals_one_device(runs, world, tmp_path, direct):
    """The engine over a mesh that lists the CPU twice (each tile's cells in
    two shards) writes what the one-device engine writes, bit for bit: the
    direct mosaics on the run-global lattice, and the per-tile files whose
    scales are the min and max over both shards."""
    from topotpu_torch.dist.mesh import make_mesh

    mesh = make_mesh(devices=[CPU, CPU])
    mode = "direct" if direct else "tiles"
    d = tmp_path / mode
    eng = _engine("port", world, d, direct=direct, mesh=mesh)
    assert eng.mesh is mesh and eng.device == CPU
    a, b = world[1]["port"]
    assert eng.run_pair("tmin", "tmax", a, b, progress=False) == {"tmin": 4, "tmax": 4}
    want = runs[mode]["port"]
    _manifests_equal(d / "tiles", want / "tiles")
    if direct:
        _mosaics_equal(d, want)
        return
    for var in VARS:
        for tile in range(4):
            name = f"{var}_tile{tile:05d}.h5"
            with h5py.File(d / "tiles" / name) as fg, h5py.File(want / "tiles" / name) as fw:
                assert sorted(fg) == sorted(fw)
                for ds in (var, f"{var}_normal", f"{var}_se"):
                    np.testing.assert_array_equal(fg[ds][...], fw[ds][...])
                    assert dict(fg[ds].attrs.items()).keys() == dict(fw[ds].attrs.items()).keys()
                    for key in ("scale_factor", "add_offset"):
                        assert fg[ds].attrs[key] == fw[ds].attrs[key]


def test_resume_and_fresh_invalidation(runs, world, tmp_path):
    """Dropped manifest claims recompute exactly those tiles, bit for bit; a
    changed pack window rebuilds the mosaic and every tile; a corrupt mosaic
    is rebuilt fresh, its stale claims dropped."""
    import shutil

    d = tmp_path / "run"
    shutil.copytree(runs["direct"]["port"], d)
    man_path = d / "tiles" / "manifest.json"
    man = json.loads(man_path.read_text())
    dropped = [k for k in man["tiles"] if k.endswith("00001")]
    assert len(dropped) == 2
    for k in dropped:
        del man["tiles"][k]
    man_path.write_text(json.dumps(man))
    with h5py.File(d / "mosaic_tmin.h5", "r+") as f:
        f["tmin"][:, :24, 24:] = -32768
    assert _run_pair("port", world, d)["tmin"] == 1
    _mosaics_equal(d, runs["direct"]["port"])

    assert _run_pair("port", world, d, config=dict(pack_temp_lo=-80.0))["tmin"] == 4
    d_new, *_ = _mosaic(d / "mosaic_tmin.h5", "tmin")
    with h5py.File(d / "mosaic_tmin.h5") as f:
        assert float(f["tmin"].attrs["scale_factor"]) == pytest.approx(150.0 / 65500.0)

    bad = tmp_path / "corrupt"
    (bad / "tiles").mkdir(parents=True)
    (bad / "mosaic_tmin.h5").write_bytes(b"\x00" * 512)
    (bad / "tiles" / "manifest.json").write_text(json.dumps({"tiles": {
        "tmin_00000": {"file": "mosaic_tmin.h5", "ts": 1.0},
        "tmax_00000": {"file": "mosaic_tmax.h5", "ts": 1.0}}}))
    assert _run_pair("port", world, bad) == {"tmin": 4, "tmax": 4}
    _mosaics_equal(bad, runs["direct"]["port"])


def test_resume_from_the_jax_packages_mosaic_and_manifest(runs, world, tmp_path):
    """The JAX engine dies after writing two tile-pairs; the port resumes
    from its mosaic and manifest. The result is a full port run: the port's
    tiles bit for bit, the JAX package's within the parity tolerance."""

    class Crashing(jengine.TileEngine):
        def _write_tile_pair(self, spec, var_a, var_b, result):
            if len(self.manifest["tiles"]) >= 4:
                raise RuntimeError("simulated crash")
            return super()._write_tile_pair(spec, var_a, var_b, result)

    d = tmp_path / "handover"
    with pytest.raises(RuntimeError, match="simulated crash"):
        _run_pair("jax", world, d, cls=Crashing)
    jax_done = _manifest(d / "tiles" / "manifest.json")
    assert len(jax_done) == 4
    assert _run_pair("port", world, d) == {"tmin": 2, "tmax": 2}
    _mosaics_close(d, runs["direct"]["port"])
    full = _manifest(runs["direct"]["port"] / "tiles" / "manifest.json")
    assert _manifest(d / "tiles" / "manifest.json") == full
    jax_tiles = {int(k[-5:]) for k in jax_done}
    for var in VARS:
        d_h, n_h, _, attrs = _mosaic(d / f"mosaic_{var}.h5", var)
        d_p, n_p, *_ = _mosaic(runs["direct"]["port"] / f"mosaic_{var}.h5", var)
        assert attrs["complete"] and attrs["n_tiles"] == 4
        for tile in set(range(4)) - jax_tiles:
            r0, c0 = 24 * (tile // 2), 24 * (tile % 2)
            sl = (slice(None), slice(r0, r0 + 24), slice(c0, c0 + 24))
            np.testing.assert_array_equal(d_h[sl], d_p[sl])
            np.testing.assert_array_equal(n_h[sl], n_p[sl])


def test_run_pair_falls_back_on_mismatched_networks(world, tmp_path):
    out = {}
    for pkg in ("jax", "port"):
        a, b = world[1][pkg]
        b2 = dataclasses.replace(b, lon=b.lon + 0.01)  # different geometry
        eng = _engine(pkg, world, tmp_path / pkg)
        assert eng.run_pair("tmin", "tmax", a, b2, progress=False) == {"tmin": 4, "tmax": 4}
        out[pkg] = tmp_path / pkg
    _mosaics_close(out["port"], out["jax"])
    _manifests_equal(out["port"] / "tiles", out["jax"] / "tiles")
    for var in VARS:
        assert not _mosaic(out["port"] / f"mosaic_{var}.h5", var)[3]["reconciled"]


def test_pool_cap_drops_count_and_warn_as_in_jax(world, tmp_path, capsys):
    """One tile over the whole world with a 24-station cap drops stations
    inside the tile: the count equals the JAX engine's, the warning comes
    once; an ample cap drops nothing and stays quiet."""
    a_j, _ = world[1]["jax"]
    a_t, _ = world[1]["port"]
    big = dict(tile_rows=48, tile_cols=48)
    cap = lambda n, Interp: Interp(k_neighbors=16, max_tile_stations=n)  # noqa: E731
    eng_j = _engine("jax", world, tmp_path / "j", direct=False,
                    config=dict(**big, interp=cap(24, JInterp)))
    capsys.readouterr()
    eng_j.prepare(eng_j.tiling.tile(0), a_j)
    jax_said = capsys.readouterr().out
    eng_t = _engine("port", world, tmp_path / "t", direct=False,
                    config=dict(**big, interp=cap(24, InterpParams)))
    assert eng_t.run("tmin", a_t, progress=False) == 1
    assert eng_t.pool_in_tile_dropped == eng_j.pool_in_tile_dropped > 0
    port_said = capsys.readouterr().out
    assert port_said.count("WARNING") == 1 and port_said == jax_said
    eng_t.prepare(eng_t.tiling.tile(0), a_t)  # warned once per engine
    assert eng_t.pool_in_tile_dropped == 2 * eng_j.pool_in_tile_dropped
    assert "WARNING" not in capsys.readouterr().out

    eng_ok = _engine("port", world, tmp_path / "ok", direct=False)
    for spec in eng_ok.tiling.tiles():
        eng_ok.prepare(spec, a_t)
    assert eng_ok.pool_in_tile_dropped == 0
    assert "WARNING" not in capsys.readouterr().out


def test_memory_mosaic_matches_the_h5py_writer(runs, world, tmp_path):
    """``chip_smoke.py``'s in-memory mosaic, behind the engine's writer class
    attribute, holds the arrays and attributes the HDF5 mosaic holds, and
    the manifest is the same."""

    class InMemory(tengine.TileEngine):
        MOSAIC_WRITER = MemoryMosaic

    a, b = world[1]["port"]
    d = tmp_path / "mem"
    eng = _engine("port", world, d, cls=InMemory)
    assert eng.run_production_pair("tmin", "tmax", a, b, years_per_chunk=1,
                                   progress=False) == {"tmin": 8, "tmax": 8}
    _manifests_equal(d / "tiles", runs["chunked"]["port"] / "tiles")
    assert not list(d.glob("*.h5"))
    for var in VARS:
        mem = MemoryMosaic.STORE.pop(d / f"mosaic_{var}.h5")
        want = _mosaic(runs["chunked"]["port"] / f"mosaic_{var}.h5", var)
        for got, w in zip((mem["daily"], mem["normal"], mem["se"]), want):
            np.testing.assert_array_equal(got, w)
        file_attrs = {k: v for k, v in mem["attrs"].items()
                      if k not in ("scale_factor", "add_offset")}
        assert file_attrs == {k: want[3][k] for k in file_attrs}
        assert set(file_attrs) == {"layout", "n_tiles", "complete", "reconciled",
                                   "process_index", "process_count"}
        with h5py.File(runs["chunked"]["port"] / f"mosaic_{var}.h5") as f:
            assert mem["attrs"]["scale_factor"] == float(f[var].attrs["scale_factor"])
            assert mem["attrs"]["add_offset"] == float(f[var].attrs["add_offset"])


def test_engine_without_a_device_needs_a_card(world, tmp_path):
    w, _ = world
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tengine.TileEngine(TopoConfig(tile_rows=24, tile_cols=24), RasterStack.from_world(w),
                           get_days_metadata("2014-01-01", "2015-12-31"), tmp_path)


# ---------------------------------------------------------- stall watchdog
def _bare_engine(stall_s: int) -> tengine.TileEngine:
    """A pipeline-only engine (no world/files): _pipelined touches just
    PIPELINE_DEPTH (class attr), config.stall_timeout_s, and _on_stall."""
    eng = tengine.TileEngine.__new__(tengine.TileEngine)
    eng.config = dataclasses.replace(TopoConfig(), stall_timeout_s=stall_s)
    return eng


class _Status:
    def tick(self):
        pass


def test_stall_watchdog_fires_on_wedged_pipeline():
    """A fetch that never completes blocks a pipeline stage without an
    exception: the watchdog must notice zero progress past stall_timeout_s
    and invoke _on_stall exactly once (the production action exits 75;
    the test injects an unblocking recorder)."""
    import threading
    import time

    eng = _bare_engine(stall_s=1)
    unblock = threading.Event()
    fired: list[float] = []

    def on_stall(idle):
        fired.append(idle)
        unblock.set()  # release the wedge so the test run drains

    eng._on_stall = on_stall

    def step(spec):
        return spec, {"v": torch.zeros(2)}

    def write(spec, host):
        assert isinstance(host["v"], np.ndarray)  # fetched to the host
        if not fired:
            assert unblock.wait(30), "watchdog never fired"

    t0 = time.monotonic()
    assert eng._pipelined([0], step, write, _Status()) == 1
    assert len(fired) == 1
    assert fired[0] >= 1.0  # fired only after a genuine idle window
    assert time.monotonic() - t0 >= 1.0


def test_stall_watchdog_quiet_while_progressing():
    """Slow-but-moving pipelines must never trip the watchdog: total wall
    exceeds stall_timeout_s several times over, but every tile completes
    within it."""
    import time

    eng = _bare_engine(stall_s=2)
    fired: list[float] = []
    eng._on_stall = lambda idle: fired.append(idle)

    def step(spec):
        return spec, {"v": np.zeros(2)}

    def write(spec, host):
        time.sleep(0.5)

    assert eng._pipelined(list(range(10)), step, write, _Status()) == 10
    assert not fired  # 5 s of wall, zero false positives
