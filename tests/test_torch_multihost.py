"""Jobs over several processes with the port: real OS processes joined by
``torch.distributed`` (gloo) on localhost, on the CPU (``TOPOTPU_PLATFORM=cpu``).

The counterpart of ``tests/test_multihost.py``: two processes of ``python -m
topotpu_torch.cli interp --coordinator ... --num-processes 2 --process-id i``
on one data_dir, then the mosaic stage, against a one-process run of the same
artifacts. Each process interpolates its strided tiles with a one-shard mesh,
as the one-process run does, so every product is compared bit for bit.

The rendezvous port is never free between its choice and the group's bind:
the test binds a listening socket on port 0 and hands it to process 0
(``TOPOTPU_COORDINATOR_FD``), which serves the rendezvous on it. Every child
runs under a timeout, so a hang fails its test and not the suite. Each test
takes a few seconds (the children's imports of torch most of it).
"""

import dataclasses
import json
import os
import pathlib
import shutil
import socket
import subprocess
import sys
import textwrap

import h5py
import numpy as np
import pytest
import torch

from topotpu.cli import steps as jsteps
from topotpu.core.config import TopoConfig as JConfig
from topotpu.core.grid import Tiling as JTiling
from topotpu.io import ncdf as jncdf
from topotpu.io.rasters import RasterStack as JRasters
from topotpu_torch.cli import main as tmain
from topotpu_torch.cli import steps as tsteps
from topotpu_torch.core import constants as C
from topotpu_torch.core.config import InterpParams, TopoConfig
from topotpu_torch.core.dates import get_days_metadata
from topotpu_torch.core.grid import Tiling
from topotpu_torch.dist import multihost
from topotpu_torch.io import ncdf
from topotpu_torch.io.rasters import RasterStack
from topotpu_torch.io.stndb import StationDB, write_serial_db
from topotpu_torch.io.synthetic import make_world

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
VARS = (C.TMIN, C.TMAX)
CHILD_TIMEOUT_S = 120


def _config(data, start="2015-01-01", end="2015-02-28", **kw) -> TopoConfig:
    return TopoConfig(data_dir=str(data), start_date=start, end_date=end,
                      tile_rows=8, tile_cols=8,
                      interp=InterpParams(k_neighbors=8, k_neighbors_anom=8,
                                          max_tile_stations=64), **kw)


def _build_artifacts(data: pathlib.Path, cfg: TopoConfig):
    """``tests/test_multihost.py``'s world and artifacts, written by the
    port: rasters.h5, all_obs.h5 and serial DBs with the true variogram."""
    days = get_days_metadata(cfg.start_date, cfg.end_date)
    world = make_world(np.random.default_rng(17), nrows=32, ncols=32, n_stations=60,
                       ndays=days.ndays, ocean_frac=0.1)
    data.mkdir(parents=True, exist_ok=True)
    RasterStack.from_world(world).save(data / "rasters.h5")
    S = world.n_stations
    filled = (world.stn_norm[np.arange(S)[:, None], days.month_idx[None, :]]
              + world.stn_anoms).astype(np.float32)
    attrs = {
        C.STN_ID: np.array([f"SYNTH{i:05d}" for i in range(S)]),
        C.LON: world.stn_lon, C.LAT: world.stn_lat,
        C.ELEV: world.stn_elev, C.TDI: world.stn_tdi,
        C.LST: world.stn_lst.astype(np.float32),
    }
    with StationDB.create(data / "all_obs.h5", attrs, days.date64) as db:
        db.set_obs(C.TMIN, filled)
        db.set_obs(C.TMAX, filled + 10.0)
    vario = np.tile(np.asarray(world.true_vario, np.float32), (S, 12, 1))
    bad = np.zeros(S, bool)
    with StationDB(data / "all_obs.h5") as src:
        write_serial_db(data / "serial_tmin.h5", src, C.TMIN, filled, world.stn_norm, bad,
                        vario)
        write_serial_db(data / "serial_tmax.h5", src, C.TMAX, filled + 10.0,
                        world.stn_norm + 10.0, bad, vario)
    return world, days


def _launch(argvs_of_rank):
    """Start one process a rank (``argvs_of_rank(coordinator)`` gives their
    argument lists), joined at a port this function holds bound and
    listening until process 0 serves on it; wait for all, under a timeout.
    Returns their outputs; raises with them if any failed."""
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    sock.listen()
    coordinator = f"127.0.0.1:{sock.getsockname()[1]}"
    env = dict(os.environ, TOPOTPU_PLATFORM="cpu", OMP_NUM_THREADS="1")
    procs = []
    try:
        for rank, argv in enumerate(argvs_of_rank(coordinator)):
            fd_env = {multihost.COORDINATOR_FD_ENV: str(sock.fileno())} if rank == 0 else {}
            procs.append(subprocess.Popen(
                [sys.executable] + argv, cwd=REPO, env=dict(env, **fd_env),
                pass_fds=(sock.fileno(),) if rank == 0 else (),
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ))
        outs = [p.communicate(timeout=CHILD_TIMEOUT_S)[0] for p in procs]
    finally:
        sock.close()
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {rank} exited {p.returncode}:\n{out[-3000:]}"
    return outs


def _cli_interp(cfg_path, *extra, n=2):
    def argvs(coordinator):
        return [["-m", "topotpu_torch.cli", "interp", "--config", str(cfg_path), *extra,
                 "--coordinator", coordinator, "--num-processes", str(n), "--process-id", str(i)]
                for i in range(n)]
    return _launch(argvs)


def _copy(data, cfg, dest, products=True):
    """A copy of the data_dir ``data`` at ``dest`` (without the products
    where ``products`` is false) and the path of its config file."""
    shutil.copytree(data, dest, ignore=None if products else shutil.ignore_patterns(
        "tiles", "mosaic_*"))
    path = dest.with_suffix(".json")
    path.write_text(dataclasses.replace(cfg, data_dir=str(dest)).to_json())
    return path


def _one_process(data, cfg, single, monkeypatch, *extra):
    """The same artifacts interpolated and assembled by one process of the
    port's CLI, in the data_dir ``single`` (a copy without products)."""
    path = _copy(data, cfg, single, products=False)
    monkeypatch.setenv("TOPOTPU_PLATFORM", "cpu")
    for stage in ("interp", "mosaic"):
        assert tmain.main([stage, "--config", str(path), *extra]) == 0
    return single


def _rig(tmp, cfg):
    data = tmp / "data"
    world, days = _build_artifacts(data, cfg)
    (tmp / "cfg.json").write_text(cfg.to_json())
    return data, tmp / "cfg.json"


def _manifest_parts(tiles, n=2):
    return [json.loads((tiles / f"manifest_p{i:03d}.json").read_text())["tiles"]
            for i in range(n)]


def _check_strided(tiles, rasters, cfg, n=2):
    """Each of the ``n`` processes' manifests holds its strided tiles only,
    and together they hold every land tile once; returns them."""
    parts = _manifest_parts(tiles, n)
    assert all(parts)
    assert sum(len(m) for m in parts) == len(set().union(*parts))
    for i, m in enumerate(parts):
        assert all(int(k.split("_")[1]) % n == i for k in m)
    land = [t.tile_id for t in Tiling(rasters.grid, cfg.tile_rows,
                                      cfg.tile_cols).land_tiles(rasters.landmask)]
    assert set().union(*parts) == {f"{v}_{t:05d}" for v in VARS for t in land}
    return parts


def _mosaics_equal(a, b, n_days):
    for var in VARS:
        with h5py.File(a / f"mosaic_{var}.h5") as fa, h5py.File(b / f"mosaic_{var}.h5") as fb:
            assert fa[var].shape[0] == n_days
            np.testing.assert_array_equal(fa[var][...], fb[var][...])
            for name in ("normal", "se"):
                np.testing.assert_array_equal(fa[name][...], fb[name][...])
            for key in ("scale_factor", "add_offset"):
                assert fa[var].attrs[key] == fb[var].attrs[key]


@pytest.fixture(scope="module")
def direct_run(tmp_path_factory):
    """Two processes, direct to their mosaic shards (the production
    default), unchunked; the shards kept as the interp stage left them."""
    tmp = tmp_path_factory.mktemp("mh_direct")
    cfg = _config(tmp / "data")
    assert cfg.mosaic_direct
    data, cfg_path = _rig(tmp, cfg)
    _cli_interp(cfg_path)
    return tmp, data, cfg


def test_two_process_interp_disjoint_and_mergeable(tmp_path, monkeypatch):
    """Per-tile files: disjoint strided manifests, and the merged mosaic
    equals the one-process run's bit for bit."""
    cfg = _config(tmp_path / "data", mosaic_direct=False)
    data, cfg_path = _rig(tmp_path, cfg)
    _cli_interp(cfg_path)
    tiles = data / "tiles"
    rasters = RasterStack.load(data / "rasters.h5")
    m0, m1 = _check_strided(tiles, rasters, cfg)
    assert all((tiles / info["file"]).exists() for info in {**m0, **m1}.values())

    res = tsteps.step_mosaic(cfg)
    assert res[C.TMIN] == res[C.TMAX] > 0
    merged = json.loads((tiles / "manifest.json").read_text())["tiles"]
    assert merged == {**m0, **m1}
    val = tsteps.step_validate(cfg)
    assert val[C.TMIN]["status"] == val[C.TMAX]["status"] == "ok", val
    single = _one_process(data, cfg, tmp_path / "single", monkeypatch)
    _mosaics_equal(data, single, 59)


def test_two_process_direct_mosaic_virtual_master(direct_run, tmp_path, monkeypatch):
    """Each process writes its strided tiles into its own finalized shard;
    the mosaic stage publishes one virtual master a variable that reads
    equal to the one-process direct mosaic, bit for bit."""
    tmp, data, cfg = direct_run
    run = tmp_path / "run"
    cfg = TopoConfig.load(_copy(data, cfg, run))
    for var in VARS:
        for i in range(2):
            with h5py.File(run / f"mosaic_{var}_p{i:03d}.h5") as f:
                assert f.attrs["layout"] == "direct" and bool(f.attrs["complete"])
                assert int(f.attrs["process_index"]) == i
                assert int(f.attrs["process_count"]) == 2
    assert not list((run / "tiles").glob("*_tile*.h5"))
    rasters = RasterStack.load(run / "rasters.h5")
    _check_strided(run / "tiles", rasters, cfg)

    res = tsteps.step_mosaic(cfg)
    n_land = len(list(Tiling(rasters.grid, 8, 8).land_tiles(rasters.landmask)))
    assert res[C.TMIN] == res[C.TMAX] == n_land and "crossvar" not in res
    for var in VARS:
        with h5py.File(run / f"mosaic_{var}.h5") as f:
            assert bool(f.attrs["virtual"]) and bool(f.attrs["complete"])
            assert f[var].is_virtual
    val = tsteps.step_validate(cfg)
    assert val[C.TMIN]["status"] == val[C.TMAX]["status"] == "ok", val
    assert val["crossvar"]["violations"] == 0
    single = _one_process(data, cfg, tmp_path / "single", monkeypatch)
    _mosaics_equal(run, single, 59)


@pytest.mark.parametrize("n", [2, 4])
def test_two_process_chunked_direct_mosaic(tmp_path, monkeypatch, n):
    """Two (and four) processes x one-year chunks x direct: full-span shards
    written a chunk at a time, each stamped with its own index and the
    process count, strided ownership in every chunk's manifests, and masters
    equal to the one-process chunked direct run bit for bit."""
    cfg = _config(tmp_path / "data", start="2014-01-01", end="2015-12-31")
    data, cfg_path = _rig(tmp_path, cfg)
    _cli_interp(cfg_path, "--chunk-years", "1", n=n)
    rasters = RasterStack.load(data / "rasters.h5")
    chunks = sorted((data / "tiles").glob("chunk_*_*"))
    assert [d.name for d in chunks] == ["chunk_2014_2014", "chunk_2015_2015"]
    for d in chunks:
        _check_strided(d, rasters, cfg, n)
        assert not list(d.glob("*_tile*.h5"))
    land = [t.tile_id for t in Tiling(rasters.grid, 8, 8).land_tiles(rasters.landmask)]
    for var in VARS:
        for i in range(n):
            with h5py.File(data / f"mosaic_{var}_p{i:03d}.h5") as f:
                assert f[var].shape[0] == 730 and bool(f.attrs["complete"])
                assert int(f.attrs["process_index"]) == i
                assert int(f.attrs["process_count"]) == n
                assert int(f.attrs["n_tiles"]) == sum(t % n == i for t in land)
    res = tsteps.step_mosaic(cfg)
    assert res[C.TMIN] == res[C.TMAX] > 0
    val = tsteps.step_validate(cfg)
    assert val[C.TMIN]["status"] == val[C.TMAX]["status"] == "ok", val
    single = _one_process(data, cfg, tmp_path / "single", monkeypatch, "--chunk-years", "1")
    _mosaics_equal(data, single, 730)


@pytest.mark.parametrize("fault", ["missing", "unfinalized"])
def test_missing_or_unfinalized_shard_raises_the_jax_message(direct_run, tmp_path, fault):
    """Both packages' mosaic stages refuse a shard set with a shard missing
    or not finalized, with the same message, and publish nothing."""
    tmp, data, cfg = direct_run
    messages = []
    for pkg, steps, config in (("port", tsteps, TopoConfig), ("jax", jsteps, JConfig)):
        run = tmp_path / pkg
        cfg_pkg = config.load(_copy(data, cfg, run))
        shard = run / f"mosaic_{C.TMAX}_p001.h5"
        if fault == "missing":
            shard.unlink()
        else:
            with h5py.File(shard, "r+") as f:
                f.attrs["complete"] = False
        with pytest.raises(RuntimeError) as err:
            steps.step_mosaic(cfg_pkg)
        messages.append(str(err.value))
        assert not (run / f"mosaic_{C.TMAX}.h5").exists()
    assert messages[0] == messages[1]
    assert ("1 of 2 tmax shards present" if fault == "missing"
            else "mosaic_tmax_p001.h5 is not finalized") in messages[0]


def test_build_virtual_mosaic_matches_jax(direct_run, tmp_path):
    """Both packages' ``build_virtual_mosaic`` over the same shard files:
    the same datasets, attributes, virtual sources and reads."""
    tmp, data, cfg = direct_run
    rasters = RasterStack.load(data / "rasters.h5")
    jrasters = JRasters.load(data / "rasters.h5")
    days = get_days_metadata(cfg.start_date, cfg.end_date)
    land = list(Tiling(rasters.grid, 8, 8).land_tiles(rasters.landmask))
    jland = list(JTiling(jrasters.grid, 8, 8).land_tiles(jrasters.landmask))
    for var in VARS:
        shards = [data / f"mosaic_{var}_p{i:03d}.h5" for i in range(2)]
        got = ncdf.build_virtual_mosaic(data / f"port_{var}.h5", var, shards, rasters.grid,
                                        days.date64, land)
        want = jncdf.build_virtual_mosaic(data / f"jax_{var}.h5", var, shards, jrasters.grid,
                                          days.date64, jland)
        assert got == want
        with h5py.File(data / f"port_{var}.h5") as fg, h5py.File(data / f"jax_{var}.h5") as fw:
            assert sorted(fg) == sorted(fw)
            assert dict(fg.attrs) == dict(fw.attrs)
            for name in fw:
                g, w = fg[name], fw[name]
                assert (g.shape, g.dtype, g.is_virtual) == (w.shape, w.dtype, w.is_virtual)
                assert sorted(g.attrs) == sorted(w.attrs)
                for key in w.attrs:
                    # object references into each file
                    if key not in ("DIMENSION_LIST", "REFERENCE_LIST"):
                        np.testing.assert_array_equal(g.attrs[key], w.attrs[key])
                if w.is_virtual:
                    assert [(s.file_name, s.dset_name) for s in g.virtual_sources()] == [
                        (s.file_name, s.dset_name) for s in w.virtual_sources()]
                np.testing.assert_array_equal(g[...], w[...])


CHILD = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from topotpu_torch.core.config import InterpParams
    from topotpu_torch.core.dates import get_days_metadata
    from topotpu_torch.dist import mesh as tmesh
    from topotpu_torch.dist import multihost
    from topotpu_torch.interp.point import PairTileInputs, VarFields
    from topotpu_torch.io.synthetic import make_world, tile_inputs_from_world

    torch.set_num_threads(1)
    coordinator, rank, out = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    ctx = multihost.init_multihost(coordinator, 2, rank)
    assert (ctx.process_index, ctx.process_count) == (rank, 2)
    assert multihost.is_coordinator() == (rank == 0)
    days = get_days_metadata("2015-01-01", "2015-02-28")
    world = make_world(np.random.default_rng(7), nrows=16, ncols=16, n_stations=60,
                       ndays=days.ndays)
    rows, cols = np.unravel_index(np.arange(256), (16, 16))
    ti, layout = tile_inputs_from_world(world, days.month_idx, rows, cols, "cpu")
    pair = PairTileInputs(ti, VarFields(ti.stn_norm + 0.2, ti.stn_vario, ti.stn_anoms * 0.5))
    params = InterpParams(k_neighbors=16)
    results = {}
    for name, mesh in (("global", multihost.global_mesh()),
                       ("two_local", tmesh.CellMesh((torch.device("cpu"),) * 2,
                                                    dist.group.WORLD))):
        fn = tmesh.sharded_interp_tile_pair_flat(mesh, params, reconcile=True)
        res = fn(tmesh.shard_pair_inputs(mesh, pair), layout.slot_of_day)
        results[name + "_buf"] = res.buf.numpy()
        results[name + "_scales"] = res.scales.numpy()
    multihost.barrier("done")
    np.savez(out, reductions=tmesh._pmin_pmax.calls, **results)
""")


def test_global_mesh_step_over_two_processes(tmp_path):
    """``init_multihost`` in two processes, then the dynamic-lattice pair
    step over ``global_mesh()`` (one CPU shard a process) and over a mesh of
    two CPU shards a process (four shards, process-major): each process's
    columns and the global scales equal the single-device step's bit for
    bit, after one ``all_reduce`` a step."""
    import topotpu_torch.interp.point as tpoint
    from topotpu_torch.interp.point import PairTileInputs, VarFields
    from topotpu_torch.io.synthetic import tile_inputs_from_world

    outs = [tmp_path / f"rank{i}.npz" for i in range(2)]
    _launch(lambda coordinator: [["-c", CHILD, coordinator, str(i), str(outs[i])]
                                 for i in range(2)])
    days = get_days_metadata("2015-01-01", "2015-02-28")
    world = make_world(np.random.default_rng(7), nrows=16, ncols=16, n_stations=60,
                       ndays=days.ndays)
    rows, cols = np.unravel_index(np.arange(256), (16, 16))
    ti, layout = tile_inputs_from_world(world, days.month_idx, rows, cols, "cpu")
    pair = PairTileInputs(ti, VarFields(ti.stn_norm + 0.2, ti.stn_vario, ti.stn_anoms * 0.5))
    want = tpoint.interp_tile_pair_flat(pair, layout.slot_of_day, InterpParams(k_neighbors=16),
                                        reconcile=True)
    for rank, path in enumerate(outs):
        got = np.load(path)
        assert int(got["reductions"]) == 2
        for name in ("global", "two_local"):
            np.testing.assert_array_equal(got[name + "_buf"],
                                          want.buf.numpy()[:, rank * 128 : (rank + 1) * 128])
            np.testing.assert_array_equal(got[name + "_scales"], want.scales.numpy())


def test_rendezvous_on_a_held_socket(monkeypatch):
    """Process 0 serves the rendezvous on the listening socket it is handed,
    at the port that socket holds: a one-process group forms on it, barriers
    and reports the coordinator, and leaves."""
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    sock.listen()
    monkeypatch.setenv("TOPOTPU_PLATFORM", "cpu")
    monkeypatch.setenv(multihost.COORDINATOR_FD_ENV, str(os.dup(sock.fileno())))
    try:
        ctx = multihost.init_multihost(f"127.0.0.1:{sock.getsockname()[1]}", 1, 0)
        assert ctx == multihost.MultihostContext(0, 1)
        multihost.barrier()
        assert multihost.is_coordinator()
        assert multihost.global_mesh().group is None  # one process: nothing spans
    finally:
        torch.distributed.destroy_process_group()
        sock.close()
