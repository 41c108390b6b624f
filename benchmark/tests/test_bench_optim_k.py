"""The cell ``grid.optim-k`` at a small size on the CPU, through the program's
plain paths: correct, and not correct with the control, with an answer
altered where the program produces it, or with one tile run at another
region's sizes. Its two readers and its counts against values worked out by
hand on synthetic records.

The small size: a 64 x 64 region of 32 x 32 tiles, each tile a region of
its own (4 regions), tmin at k 16 / 20 and ka 8 / 16, tmax at region
3 - r's: so the two variables differ in k and in ka in every tile, two
``krig_normals_indexed`` calls a step."""

import collections

import pytest
import tiny
from test_bench_span_metrics import MAIN, MS, _read, _trace

from benchlib import catalog, peaks
from benchlib.record import Record
from topotpu_torch.utils import profiling

CELL = "grid.optim-k"
SIZES = [[16, 8], [20, 8], [16, 16], [20, 16]]
OVERRIDES = {
    "config": dict(tiny.OVERRIDES["grid.year-chunks"]["config"], regions={"block_tiles": 1},
                   nnghs={"tmin": SIZES, "tmax": SIZES[::-1]}),
    "cell": {"sample_cells": 64},
}


def _cell(options=None):
    import torch

    from benchlib import runner

    return runner.run_cell(CELL, tiny.SEED, 0.5, False, torch.device("cpu"),
                           overrides=dict(OVERRIDES, options=options or {}))


def test_cell_runs_and_is_correct():
    out = _cell()
    assert out["correct"], out["checks"]
    assert out["attempted"] == 4 and out["failed"] == 0  # one chunk of 4 tile-pairs
    assert out["checks"]["k_table_faults"]["value"] == 0
    assert "setup_s" in out["metrics"]


def test_control_is_not_correct():
    out = _cell({"control": True})
    assert not out["correct"], out["checks"]


def test_altered_answer_is_not_correct():
    out = _cell({"fault": "answer"})
    assert not out["correct"] and out["checks"]["daily_err_C"]["value"] > 0.4, out["checks"]


def test_a_tile_at_another_regions_sizes_is_not_correct():
    out = _cell({"k_table_fault": True})
    assert not out["correct"]
    assert out["checks"]["k_table_faults"]["value"] == 1 and out["failed"] == 1


def test_the_region_table_from_the_configuration():
    drv = catalog.load_module("drivers", "grid_optim_k")
    cfg = catalog.load_json("configs", "topowx-grid-30s-optim-k")
    reg, ids, ks = drv.regions(cfg, 1024, 1024)
    assert list(ids) == list(range(16)) and reg.shape == (1024, 1024)
    assert reg[0, 0] == 0 and reg[0, 255] == 0 and reg[0, 256] == 1 and reg[256, 0] == 4
    assert reg[1023, 1023] == 15
    want = drv.region_sizes(cfg, 1024, 1024)
    assert len(want) == 64
    # tile 10 (row 1, col 2) lies in block (0, 1), region 1: tmin (24, 8), tmax region 6's
    assert want[10] == {"tmin": [24, 8], "tmax": [32, 16]}
    for tid, ent in want.items():
        assert ent["tmin"][0] != ent["tmax"][0] and ent["tmin"][1] != ent["tmax"][1]
    # every (k, ka) pair once a variable; half the tiles select above 32 (K = 64)
    for v in ("tmin", "tmax"):
        assert len({tuple(s) for s in cfg["nnghs"][v]}) == 16
    assert sum(max(e["tmin"] + e["tmax"]) > 32 for e in want.values()) == 32


def test_sized_counts_by_hand():
    c = catalog.load_module("counts", "krig_normals_sized")
    frozen = catalog.load_module("counts", "krig_normals")
    for k in (4, 32, 48):
        for P in (12, 24):
            shape = dict(C=10, k=k, S=7, V=2, P=P, N=1)
            assert c.flops(**shape, k_normal=k, k_anom=k) == frozen.flops(**shape)
            assert c.nbytes(**shape, k_normal=k, k_anom=k) == frozen.nbytes(**shape)
            assert c.flops(**shape) == frozen.flops(**shape)
    # k 4 slots, the systems on 3, the gain rows on 2; one system's solve at 3:
    # covariance 18, Cholesky 9, two solves 36, OK 30
    assert c.solve_flops(3, xyz=False) == 93
    # a neighbourhood: weights 30, pair distances 54, 2 fixed columns 48; gains:
    # 3 columns 48, (10 + 4) x 3 x 2 = 84, 200; their own weights 20
    per_nbr = 30 + 54 + 48 + 48 + 84 + 200 + 20
    # a system: 1 column 24, normal equations 14 x 3 x 3, 200, residuals 30,
    # variogram 18, the solve
    per_sys = 24 + 126 + 200 + 30 + 18 + 93
    assert c.flops(C=10, k=4, S=7, V=2, P=12, N=1, k_normal=3, k_anom=2) == (
        10 * (per_nbr + 12 * per_sys)) == 63760
    # bytes: all 4 slots read, every output written, whatever the sizes
    assert c.nbytes(C=10, k=4, S=7, V=2, P=12, N=1, k_normal=3, k_anom=2) == (
        40 * 13 + (7 * 115 + 160) * 4 + (12 * 10 * 8 + 40) * 4) == 8380


def _run(monkeypatch, records, ranges=(), ops=(), traced=True, meta=True):
    """A run record with the program's records [(name, t0_ms, t1_ms, key)] of
    the main thread, as taken under a profiler, and a synthetic trace."""
    got = collections.deque(maxlen=100)
    for i, (name, a, b, key) in enumerate(records, 1):
        got.append(profiling.SpanRecord(i, name, int(a * MS), int(b * MS), MAIN, key, None))
    monkeypatch.setattr(profiling, "_profiled", got)
    rec = Record()
    rec.main_thread = MAIN
    rec.trace = _trace(ranges, ops) if traced else None
    if meta:
        rec.meta["krig_normals_sized"] = dict(C=10, S=7, V=2, N=1)
    return rec


BIG, SMALL = (4, 4, 4, 24), (4, 3, 2, 12)
STEPS = [  # two tile-pairs: one at one size, one at two
    ("engine.launch", 100, 120, None), ("step.krig", 102, 103, BIG),
    ("engine.launch", 300, 330, None), ("step.krig", 305, 306, SMALL),
    ("step.krig", 307, 308, BIG),
]
RANGES = [(n, a, b) for n, a, b, _ in STEPS]
OPS = [  # (name, launched at, runs from, to), ms
    ("krig_normals_indexed_kernel<1>", 102.5, 130, 132),
    ("topk", 304, 332, 333),
    ("krig_normals_indexed_kernel<1>", 305.5, 333, 336),
    ("krig_normals_indexed_kernel<1>", 307.5, 336, 340),
    ("krig_normals_indexed_kernel<1>", 350, 360, 370),  # launched outside every step.krig
]


def _least(key):
    c = catalog.load_module("counts", "krig_normals_sized")
    k, kn, ka, P = key
    shape = dict(C=10, S=7, V=2, N=1, k=k, P=P, k_normal=kn, k_anom=ka)
    return peaks.bound_s(c.nbytes(**shape), c.flops(**shape))


def test_krig_launches_a_tile_pair(monkeypatch):
    run = _run(monkeypatch, STEPS, RANGES, OPS)
    assert _read("step.krig_launches", run) == pytest.approx(3 / 2)


def test_the_roofline_takes_each_launchs_own_sizes(monkeypatch):
    run = _run(monkeypatch, STEPS, RANGES, OPS)
    want = 100 * (2 * _least(BIG) + _least(SMALL)) / ((2 + 3 + 4) * 1e-3)
    assert _read("krig_normals_roofline.grid-k", run) == pytest.approx(want)
    # the first launch at the small sizes instead: another share
    swapped = [(n, a, b, SMALL if key == BIG and a == 102 else key) for n, a, b, key in STEPS]
    run = _run(monkeypatch, swapped, RANGES, OPS)
    want2 = 100 * (_least(BIG) + 2 * _least(SMALL)) / ((2 + 3 + 4) * 1e-3)
    assert _read("krig_normals_roofline.grid-k", run) == pytest.approx(want2) != want


def test_the_roofline_matches_by_time_where_a_record_is_missing(monkeypatch):
    """Two ranges at 302-303 and 305-306 ms and only the second's record:
    both take its key, the nearest start."""
    steps = [("step.krig", 305, 306, SMALL)]
    ranges = [("step.krig", 302, 303), ("step.krig", 305, 306)]
    ops = [("krig_normals_indexed_kernel<1>", 302.5, 330, 331),
           ("krig_normals_indexed_kernel<1>", 305.5, 331, 333)]
    run = _run(monkeypatch, steps, ranges, ops)
    assert _read("krig_normals_roofline.grid-k", run) == pytest.approx(
        100 * 2 * _least(SMALL) / 3e-3)


@pytest.mark.parametrize("name", ["step.krig_launches", "krig_normals_roofline.grid-k"])
def test_nothing_without_a_trace_or_the_spans(monkeypatch, name):
    assert _read(name, _run(monkeypatch, STEPS, RANGES, OPS, traced=False)) is None
    # a program without step.krig (the parent of this cell's change)
    old = [s for s in STEPS if s[0] != "step.krig"]
    assert _read(name, _run(monkeypatch, old, [(n, a, b) for n, a, b, _ in old], OPS)) is None
    run = _run(monkeypatch, STEPS, RANGES, OPS)
    monkeypatch.delattr(profiling, "recorded")
    assert _read(name, run) is None


def test_the_readers_are_in_the_benchmark():
    bench = catalog.benchmark_json()
    names = {m["name"]: m for m in bench["per_layer"]}
    for name in ("step.krig_launches", "krig_normals_roofline.grid-k"):
        assert names[name]["workloads"] == [CELL]
        assert names[name]["moves"] == "mem_peak_gib"
    e2e, per_layer = catalog.cell_metrics(bench, CELL)
    assert {m["name"] for m in e2e} == {"mem_peak_gib", "setup_s"}
    # the per-layer metrics that read one k from the cell's meta are not its
    assert not {"krig_normals_roofline.grid", "scatter_daily_packed_roofline"} & {
        m["name"] for m in per_layer}
