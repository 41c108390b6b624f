"""The four-rank grid cell (``grid.year-4gpu``) on the CPU at a small size:
four real processes (``TOPOTPU_PLATFORM=cpu``, gloo), a 64 x 64 region of
four 32 x 32 tiles, one a rank. Its run is correct, and its comparison
fails where it should: with the control (the reference in TF32 in the
program's place), with a fault planted in rank 2's shard, with a worker
killed in the window (the run ends with an error, within the bound). The
plain assembly of the shards (``reference/shards.py``) equals a
one-process run bit for bit, and the readers of the cell's new metrics read
synthetic records as worked out by hand. Every run is bounded: a run that
would hang fails its test."""

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import pytest

import tiny
from benchlib import catalog, runner
from benchlib.record import Record
from benchlib.trace import Tracer
from reference import shards

CELL = "grid.year-4gpu"
OVERRIDES = {
    "config": {"region_rows": 64, "region_cols": 64, "tile_rows": 32, "tile_cols": 32,
               "end_date": "1950-12-31", "margin_km": 100.0, "km2_per_station": 400.0,
               "k_neighbors": 16, "k_neighbors_anom": 16},
    "cell": {"sample_cells": 64},
}
RUN_TIMEOUT_S = 300


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    """Every rank on the CPU with one thread: the world's float reductions
    on the CPU follow the thread count, and the ranks' digests must agree."""
    import torch

    monkeypatch.setenv("TOPOTPU_PLATFORM", "cpu")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _run(options=None, seconds=0.5, **over):
    import torch

    ov = {k: dict(v, **over.get(k, {})) for k, v in OVERRIDES.items()}
    return runner.run_cell(CELL, tiny.SEED, seconds, False, torch.device("cpu"),
                           overrides=dict(ov, options=options or {}))


def test_four_ranks_run_correct():
    out = _run()
    assert out["correct"], out["checks"]
    assert out["device"]["count"] == 4 and "setup_s" in out["metrics"]
    assert out["attempted"] >= 4 and out["failed"] == 0
    assert list(out["checks"]) == ["normal_se_err_C", "daily_err_C", "ok_mismatch",
                                   "manifest_faults", "shard_faults", "rank_faults",
                                   "chunks_compared_short"]


def test_control_is_not_correct():
    out = _run({"control": True})
    assert not out["correct"]
    assert out["checks"]["daily_err_C"]["value"] > out["checks"]["daily_err_C"]["limit"]


def test_fault_in_rank_2s_shard_is_not_correct():
    checks = _run({"fault_rank": 2})["checks"]
    assert (checks["daily_err_C"]["value"] > checks["daily_err_C"]["limit"]
            or checks["shard_faults"]["value"] > 0)


def test_a_worker_that_loaded_the_jax_package_is_a_rank_fault():
    """Rank 2 with ``topotpu`` in its modules at the end of its window:
    it hands on no result and exits with an error, so the run is not
    correct (or, should rank 0 see the exit before the window has closed,
    ends with an error that names the rank)."""
    try:
        out = _run({"banned_rank": 2})
    except RuntimeError as e:
        assert "worker(s) [2] died" in str(e)
        return
    assert not out["correct"] and out["checks"]["rank_faults"]["value"] == 1


def test_a_worker_killed_in_the_window_ends_the_run_within_the_bound(tmp_path):
    """Rank 1 killed 1 s into a 4 s window: rank 0 ends with an error that
    counts it, the other workers killed, well inside the window plus the
    cell's 60 s bound."""
    code = (f"import sys; sys.path[:0] = [{tiny.BENCH + '/tests'!r}]\n"
            "import tiny, test_bench_grid4 as t\n"
            "t._run({'kill': [1, 1.0]}, seconds=4.0)\n")
    t = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", code], cwd=tiny.ROOT, capture_output=True,
                          text=True, timeout=RUN_TIMEOUT_S,
                          env=dict(os.environ, TOPOTPU_PLATFORM="cpu", OMP_NUM_THREADS="1"))
    took = time.perf_counter() - t
    assert proc.returncode != 0
    assert "worker(s) [1] died (rank_faults 1)" in proc.stderr, proc.stderr[-3000:]
    assert took < 4.0 + 60 + 60  # the window, the bound, the set-up


def _job(processes, seconds=0.3):
    """The cell's driver run as ``runner.run_cell`` runs it, every cell of
    the region sampled, with ``processes`` ranks; returns the assembled
    product."""
    import torch

    found = catalog.resolve(CELL)
    driver = catalog.load_module("drivers", found["driver"])
    config = dict(found["config"], **OVERRIDES["config"], processes=processes)
    cell = dict(found["cell"], sample_cells=64 * 64)
    with tempfile.TemporaryDirectory() as tmp:
        ctx = runner.Ctx(name=CELL, cell=cell, config=config,
                         traffic=found["traffic"]["params"], seed=tiny.SEED, seconds=seconds,
                         device=torch.device("cpu"), rec=Record(), tracer=Tracer(False, None),
                         tmpdir=tmp, options={})
        s = driver.setup(ctx)
        t0 = time.perf_counter()
        driver.window(ctx, s)
        ctx.rec.window = (t0, time.perf_counter())
        return driver.product(driver.release(ctx, s))


def test_shards_assemble_to_the_one_process_product_bit_for_bit():
    four, one = _job(4), _job(1)
    assert four["shard_faults"] == one["shard_faults"] == 0
    assert set(four["finished"]) == {0, 1, 2, 3} and min(four["finished"].values()) >= 1
    n = min(len(four["daily"]), len(one["daily"]))
    assert n >= 1
    for key in ("normal", "se"):
        np.testing.assert_array_equal(four[key], one[key])
        assert np.isfinite(four[key]).all()
    for j in range(n):
        if four["comparable"][j].all() and one["comparable"][j].all():
            np.testing.assert_array_equal(four["daily"][j], one["daily"][j])
            assert (four["daily"][j] != -32768).all()


def test_assemble_takes_each_cell_from_its_owner():
    owner = shards.owners(shards.tile_ids([0, 0, 40, 40], [0, 40, 0, 40], 32, 32, 64), 4)
    assert owner.tolist() == [0, 1, 2, 3]
    values = np.arange(4)[:, None] * 10 + np.arange(4)[None, :]  # shard p, cell i: 10 p + i
    wrote = np.eye(4, dtype=bool)
    wrote[3, 0] = True  # shard 3 wrote cell 0, which shard 0 owns
    out, foreign = shards.assemble(values, wrote, owner, -1)
    assert out.tolist() == [0, 11, 22, 33] and foreign.tolist() == [1, 0, 0, 0]
    wrote[1, 1] = False
    assert shards.assemble(values, wrote, owner, -1)[0].tolist() == [0, -1, 22, 33]
    assert shards.claim_faults([[0, 4], [1], [2], [3]], 4) == 0
    assert shards.claim_faults([[0, 4], [1, 4], [2], [3]], 4) == 2  # a second claim, not its own
    attrs = dict(complete=True, process_index=2, process_count=4, n_tiles=3)
    assert shards.attr_faults(attrs, 2, 4, 3) == 0
    assert shards.attr_faults(dict(attrs, process_index=1), 2, 4, 3) == 1


def _record(ranks, window=(10.0, 20.0), traced=True):
    from benchlib.trace import Trace

    rec = Record()
    rec.window = window
    rec.meta["ranks"] = ranks
    if traced:
        base = time.time_ns() - time.perf_counter_ns()  # the trace's clock on perf_counter's
        ops = [{"ph": "X", "cat": "kernel", "name": "k", "ts": (window[0] + a) * 1e6,
                "dur": (b - a) * 1e6, "tid": 7} for a, b in ((1.0, 3.0), (2.0, 4.0), (8.0, 9.0))]
        rec.trace = Trace({"baseTimeNanoseconds": base, "traceEvents": ops}, *window)
    return rec


def _read(name, run):
    return catalog.load_module("metrics", name).read(run)


S = 1_000_000_000  # ns a second


def test_rank_readers_on_synthetic_records():
    ranks = [dict(rank=r, var_cell_days=1000 * (r + 1), tile_pairs=1, records=recs)
             for r, recs in enumerate([
                 [("multihost.barrier", 10 * S, 10 * S + S // 2), ("engine.write", 11 * S, 12 * S)],
                 [("multihost.barrier", 9 * S, 11 * S)],        # opened before the window: 1 s in
                 [("multihost.barrier", 19 * S, 21 * S)],       # closed after it: 1 s in
                 [("multihost.barrier", 18 * S, 20 * S), ("multihost.init", 1 * S, 2 * S)]])]
    rec = _record(ranks)
    assert _read("ranks.product_rate", rec) == pytest.approx(10000 / 10.0)
    assert _read("ranks.end_wait_share", rec) == pytest.approx(100.0 * 4.5 / 40.0)
    assert _read("device.idle_share.grid", rec) == pytest.approx(100.0 * (1 - 4.0 / 10.0))
    untraced = _record(ranks, traced=False)
    assert _read("ranks.product_rate", untraced) == pytest.approx(1000.0)
    assert _read("ranks.end_wait_share", untraced) is None
    assert _read("device.idle_share.grid", untraced) is None
    # a program whose barriers take no span, and a run with no ranks' counts
    quiet = _record([dict(r, records=[]) for r in ranks])
    assert _read("ranks.end_wait_share", quiet) is None
    assert _read("ranks.product_rate", _record([])) is None


def test_the_cell_is_declared():
    bench = json.loads((catalog.ROOT / "BENCHMARK.json").read_text())
    cell = next(w for w in bench["workloads"] if w["name"] == CELL)
    assert cell["chips"] == 4 and catalog.resolve(CELL)["driver"] == "grid_ranks"
    e2e, per_layer = catalog.cell_metrics(bench, CELL)
    assert {m["name"] for m in e2e} == {"mem_peak_gib", "setup_s"}
    engine = {m["name"] for m in per_layer if "grid.year-chunks" in m.get("workloads", ())}
    assert {m["name"] for m in per_layer} == {"ranks.product_rate", "ranks.end_wait_share"} | engine
    assert {"engine.product_rate", "step.launches", "device.idle_share.grid",
            "krig_normals_roofline.grid", "scatter_daily_packed_roofline"} <= engine
