"""The production engine on the card against the same engine on CPU tensors.
Marked ``cuda``: it skips without a CUDA device. It imports nothing of the
JAX package and no h5py (both runs write into ``chip_smoke.py``'s in-memory
mosaic), so it runs on the card's machine with
``python -m pytest tests/test_torch_cuda_engine.py -m cuda --noconftest``.

A 64 x 64 world, 80 stations, 2015-2017 in one-year chunks (365, 366 and
365 days), 32 x 32 tiles, k = 16, a 64-station pool, a k_table on one tile.
Tolerances are those of ``tests/test_torch_engine.py``: identical fill
positions, dailies and normals within one lattice step + 1e-2 C and se
within one step + 2e-3 C on all but 0.1 % of values, every value within
3e-2 C (the card's kernels and their plain versions round the nearly
collinear trend design differently); the manifests are equal but for the
time stamps.
"""

import json
import pathlib
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
from chip_smoke import MemoryMosaic, engine_inputs  # noqa: E402
from topotpu_torch.core.config import InterpParams, TopoConfig  # noqa: E402
from topotpu_torch.dist.engine import TileEngine  # noqa: E402

pytestmark = pytest.mark.cuda

STEP = 160.0 / 65500.0
SE_STEP = 32.0 / 65500.0


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


class _Engine(TileEngine):
    MOSAIC_WRITER = MemoryMosaic
    PIPELINE_DEPTH = 1  # a fetch pool of 5 buffers: fewer than a chunk's takes


def _run(out, device, mesh=None, engine=_Engine, k_table=None):
    world, days, rasters, a, b = engine_inputs(64, 80, "2015-01-01", "2017-12-31", seed=3)
    cfg = TopoConfig(tile_rows=32, tile_cols=32,
                     interp=InterpParams(k_neighbors=16, max_tile_stations=64))
    mosaics = {v: out / f"mosaic_{v}.h5" for v in ("tmin", "tmax")}
    eng = engine(cfg, rasters, days, out / "tiles", device=device, mosaic_paths=mosaics,
                 k_table=k_table or {2: {"tmin": (12, 8), "tmax": (16, 12)}}, mesh=mesh)
    counts = eng.run_production_pair("tmin", "tmax", a, b, years_per_chunk=1, progress=False)
    assert counts == {"tmin": 12, "tmax": 12}
    store = {v: MemoryMosaic.STORE.pop(p) for v, p in mosaics.items()}
    manifests = {}
    for path in sorted((out / "tiles").rglob("manifest.json")):
        tiles = json.loads(path.read_text())["tiles"]
        for info in tiles.values():
            del info["ts"]
        manifests[path.parent.name] = tiles
    return eng, store, manifests


def _within(got, want, step, tol):
    assert np.array_equal(np.isnan(got), np.isnan(want))
    err = np.abs(np.asarray(got, np.float64) - want)[~np.isnan(want)]
    assert np.mean(err > step + tol) <= 1e-3 and err.max() <= 3e-2, err.max()


def test_engine_on_the_card_matches_the_cpu_run(dev, tmp_path):
    eng, card, man_card = _run(tmp_path / "card", dev)
    _, cpu, man_cpu = _run(tmp_path / "cpu", torch.device("cpu"))
    assert man_card == man_cpu and len(man_card) == 3
    assert man_card["chunk_2016_2016"]["tmax_00002"]["k"] == [16, 12]
    for var in ("tmin", "tmax"):
        g, w = card[var], cpu[var]
        assert g["attrs"] == w["attrs"] and g["attrs"]["complete"]
        dec = lambda q: np.where(q == -32768, np.nan, q * STEP)  # noqa: E731
        _within(dec(g["daily"]), dec(w["daily"]), STEP, 1e-2)
        _within(g["normal"], w["normal"], STEP, 1e-2)
        _within(g["se"], w["se"], SE_STEP, 2e-3)

    # the pinned pools outlive the chunks: the 365-day product shape was
    # taken by 8 tile-pairs in two chunks from at most 5 buffers, the
    # 366-day one has its own; the inputs' layout is the same for every
    # chunk (31 day slots a month), so one staging ring of PIPELINE_DEPTH
    # buffers serves all three
    pool = eng._fetch_pool
    assert pool.cap == 5 and len(pool.allocated) == 2
    rows = {key[0][0][0]: n for key, n in pool.allocated.items()}
    assert set(rows) == {2 * (365 + 24), 2 * (366 + 24)}
    assert 1 <= rows[2 * (365 + 24)] <= 5 and 1 <= rows[2 * (366 + 24)] <= 4
    assert all(len(ring) <= 1 for ring in eng._staging._rings.values())
    assert len(eng._staging._rings) == 1 and eng._staging.nbytes > 0


def test_per_variable_sizes_at_k64_on_the_card_match_the_cpu_run(dev, tmp_path):
    """A tile at tmin (48, 16) / tmax (16, 32), a tile of the benchmark's
    ``grid.optim-k``: selection at 48, so the card runs the K = 64
    instantiation of ``krig_normals`` with k_normal 48 and 16 in one pair,
    two launches a step (three chunks: 3 x (3 + 2)), packed with G = 2;
    against the plain path on the CPU, at the tolerances above."""
    from topotpu_torch.kernels.krig_normals import krig_normals_indexed

    table = {1: {"tmin": (48, 16), "tmax": (16, 32)}}
    before = krig_normals_indexed.launches
    _, card, man_card = _run(tmp_path / "card", dev, k_table=table)
    assert krig_normals_indexed.launches - before == 15
    _, cpu, man_cpu = _run(tmp_path / "cpu", torch.device("cpu"), k_table=table)
    assert man_card == man_cpu
    assert man_card["chunk_2016_2016"]["tmin_00001"]["k"] == [48, 16]
    assert man_card["chunk_2016_2016"]["tmax_00001"]["k"] == [16, 32]
    for var in ("tmin", "tmax"):
        g, w = card[var], cpu[var]
        assert g["attrs"] == w["attrs"] and g["attrs"]["complete"]
        dec = lambda q: np.where(q == -32768, np.nan, q * STEP)  # noqa: E731
        _within(dec(g["daily"]), dec(w["daily"]), STEP, 1e-2)
        _within(g["normal"], w["normal"], STEP, 1e-2)
        _within(g["se"], w["se"], SE_STEP, 2e-3)


def test_two_shard_mesh_on_the_card_equals_one_device(dev, tmp_path):
    """The engine over two shards of the card (the mesh lists it twice)
    writes what the one-device engine writes, bit for bit, the k_table
    tile included: its gain rows are computed in plain torch, whose batched
    products may pick their kernel by the batch size (``kernels/wls.py``)."""
    from topotpu_torch.dist.mesh import make_mesh

    _, one, man_one = _run(tmp_path / "one", dev)
    eng, two, man_two = _run(tmp_path / "two", None, mesh=make_mesh(devices=[dev, dev]))
    assert len(eng.mesh.devices) == 2 and man_two == man_one
    for var in ("tmin", "tmax"):
        for key in ("daily", "normal", "se"):
            np.testing.assert_array_equal(two[var][key], one[var][key])
        assert two[var]["attrs"] == one[var]["attrs"]


def test_engine_on_a_second_card_stays_on_it(tmp_path, monkeypatch):
    """An engine whose mesh is ``cuda:1``, run while ``cuda:0`` is the
    current device (a rank of a job over several processes that takes the
    second card, as ``local_mesh`` gives it), records every event behind
    its copies on ``cuda:1``'s stream and writes what the engine on
    ``cuda:0`` writes, bit for bit. An event recorded on the current
    device's stream completes before the copy it stands for, and the writer
    may read a buffer mid-copy."""
    from topotpu_torch.dist.mesh import make_mesh

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    first, second = torch.device("cuda", 0), torch.device("cuda", 1)
    _, want, man_want = _run(tmp_path / "first", first)
    recorded_on = []
    record = torch.cuda.Event.record

    def spy(self, stream=None):
        recorded_on.append((torch.cuda.current_stream() if stream is None else stream).device)
        return record(self, stream)

    monkeypatch.setattr(torch.cuda.Event, "record", spy)
    torch.cuda.set_device(first)
    eng, got, man_got = _run(tmp_path / "second", None, mesh=make_mesh(devices=[second]))
    assert torch.cuda.current_device() == 0 and eng.device == second
    assert recorded_on and set(recorded_on) == {second}
    assert man_got == man_want
    for var in ("tmin", "tmax"):
        for key in ("daily", "normal", "se"):
            np.testing.assert_array_equal(got[var][key], want[var][key])
        assert got[var]["attrs"] == want[var]["attrs"]


def test_a_traced_rank_on_the_second_card_holds_a_context_there_only(tmp_path):
    """A fresh process that is rank 1 of a job with one card a rank does
    what the CLI's ``interp --trace`` does: it takes its card
    (``multihost.local_devices``) before the profiler starts, then runs the
    engine on the mesh ``local_mesh`` gives it. It then holds a CUDA
    context on ``cuda:1`` and on no other card: a profiler started, or a
    buffer pinned, while ``cuda:0`` was current would open one there."""
    import json
    import os
    import subprocess

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    tests = str(pathlib.Path(__file__).resolve().parent)
    code = f"""
import json, pathlib, sys
sys.path[:0] = [{tests!r}]
import torch
import test_torch_cuda_engine as t
from topotpu_torch.dist import multihost
from topotpu_torch.utils.profiling import device_trace

multihost.local_devices(1, torch.cuda.device_count())
out = pathlib.Path({str(tmp_path)!r})
with device_trace(out / "trace", "_p001"):
    eng, _, manifests = t._run(out / "rank", None)
torch.cuda.synchronize()
held = [i for i in range(torch.cuda.device_count()) if torch._C._cuda_hasPrimaryContext(i)]
print(json.dumps(dict(device=str(eng.device), current=torch.cuda.current_device(),
                      contexts=held, chunks=len(manifests))))
"""
    env = dict(os.environ, LOCAL_WORLD_SIZE=str(torch.cuda.device_count()), LOCAL_RANK="1")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=600, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got == dict(device="cuda:1", current=1, contexts=[1], chunks=3)
    assert sorted(f.name for f in (tmp_path / "trace").iterdir()) == [
        "spans_p001.json", "trace_p001.json"]
