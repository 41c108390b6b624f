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


def _run(out, device, mesh=None):
    world, days, rasters, a, b = engine_inputs(64, 80, "2015-01-01", "2017-12-31", seed=3)
    cfg = TopoConfig(tile_rows=32, tile_cols=32,
                     interp=InterpParams(k_neighbors=16, max_tile_stations=64))
    mosaics = {v: out / f"mosaic_{v}.h5" for v in ("tmin", "tmax")}
    eng = _Engine(cfg, rasters, days, out / "tiles", device=device, mosaic_paths=mosaics,
                  k_table={2: {"tmin": (12, 8), "tmax": (16, 12)}}, mesh=mesh)
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
