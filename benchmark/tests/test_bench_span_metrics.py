"""The readers of the program's spans against values worked out by hand: a
run record with a trace made from a synthetic Chrome trace (the program's
``record_function`` ranges and the device operations they launched) and
hand-placed span records. Each reader reads nothing without a trace, and
nothing from a program without spans."""

import collections
import time

import pytest
import tiny  # noqa: F401  (paths)

from benchlib import catalog
from benchlib.record import Record
from benchlib.trace import Trace
from topotpu_torch.utils import profiling

MAIN, FETCH, WRITER = 101, 102, 103
MS = 1_000_000  # ns


def _trace(ranges, ops):
    """A ``Trace`` over the window (0, 10) s of ``perf_counter`` from
    ``ranges`` [(name, t0_ms, t1_ms)] on the main thread and ``ops``
    [(name, launch_ms, t0_ms, t1_ms)]: times in ms of ``perf_counter``."""
    base = time.time_ns() - time.perf_counter_ns()  # the trace's clock on perf_counter's
    ev = [{"ph": "X", "cat": "user_annotation", "name": n, "ts": a * 1e3, "dur": (b - a) * 1e3,
           "tid": MAIN} for n, a, b in ranges]
    for corr, (n, launch, a, b) in enumerate(ops, 1):
        ev.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                   "ts": launch * 1e3, "dur": 5.0, "tid": MAIN, "args": {"correlation": corr}})
        ev.append({"ph": "X", "cat": "kernel", "name": n, "ts": a * 1e3, "dur": (b - a) * 1e3,
                   "tid": 7, "args": {"correlation": corr}})
    return Trace({"baseTimeNanoseconds": base, "traceEvents": ev}, 0.0, 10.0)


def _run(monkeypatch, records, ranges=(), ops=(), traced=True):
    """A run record whose main thread is ``MAIN``, and the program's records
    [(name, t0_ms, t1_ms, thread)] as taken under a profiler."""
    got = collections.deque(maxlen=100)
    for i, (name, a, b, thread) in enumerate(records, 1):
        got.append(profiling.SpanRecord(i, name, int(a * MS), int(b * MS), thread, None, None))
    monkeypatch.setattr(profiling, "_profiled", got)
    rec = Record()
    rec.main_thread = MAIN
    rec.trace = _trace(ranges, ops) if traced else None
    return rec


def _read(name, run):
    return catalog.load_module("metrics", name).read(run)


GRID = [  # two tile-pairs
    ("engine.write", 100, 160, WRITER), ("engine.write", 200, 250, WRITER),
    ("engine.write.verify", 110, 130, WRITER), ("engine.write.viol", 130, 135, WRITER),
    ("engine.write.verify", 210, 220, WRITER), ("engine.write.mosaic", 100, 110, WRITER),
    ("engine.buffer_wait", 50, 90, MAIN), ("engine.queue_wait", 150, 160, MAIN),
    ("engine.stage_wait", 170, 172, MAIN),
    ("engine.buffer_wait", 300, 330, WRITER),  # not the main thread's: left out
    ("engine.fetch_wait", 60, 63, FETCH), ("engine.fetch_wait", 180, 181, FETCH),
    ("engine.write", 9_990, 10_020, WRITER),  # ends past the window: left out
]


def test_engine_waits_and_the_verify_share(monkeypatch):
    run = _run(monkeypatch, GRID)
    assert _read("engine.main_wait_ms", run) == pytest.approx((40 + 10 + 2) / 2)
    assert _read("engine.fetch_wait_ms", run) == pytest.approx((3 + 1) / 2)
    assert _read("engine.verify_share", run) == pytest.approx(100 * (20 + 5 + 10) / (60 + 50))


LAUNCH = [("engine.launch", 100, 120), ("engine.launch", 300, 330),
          ("geo.distance", 101, 103), ("geo.select_neighbors", 104, 110),
          ("geo.select_neighbors", 301, 305)]
STEP_OPS = [  # (name, launched at, runs from, to), ms
    ("dist", 102, 130, 131), ("topk", 105, 131, 134), ("krig", 112, 134, 150),
    ("topk", 302, 340, 342.5), ("krig", 310, 343, 360), ("copy", 321, 361, 362),
    ("stray", 200, 210, 211),  # launched outside every range
]


def test_step_launches_and_grid_selection_time(monkeypatch):
    run = _run(monkeypatch, GRID, LAUNCH, STEP_OPS)
    assert _read("step.launches", run) == pytest.approx(6 / 2)
    assert _read("selection.device_ms.grid", run) == pytest.approx((1 + 3 + 2.5) / 2, rel=1e-6)


def test_params_selection_time(monkeypatch):
    run = _run(monkeypatch, [], LAUNCH, STEP_OPS)
    assert _read("selection.device_ms.params", run) == pytest.approx((3 + 2.5) / 2, rel=1e-6)


def test_em_launches_a_trip(monkeypatch):
    ranges = [("ppca.em_step", 10, 20), ("ppca.em_step", 20.5, 30), ("ppca.sync", 31, 40)]
    ops = [("gemm", 11, 50, 51), ("inv", 12, 51, 52), ("where", 21, 52, 53),
           ("any", 32, 53, 54)]  # the flag read's launch is not a trip's
    run = _run(monkeypatch, [], ranges, ops)
    assert _read("ppca.launches_per_iter", run) == pytest.approx(3 / 2)


def test_infill_and_station_stage_seconds(monkeypatch):
    run = _run(monkeypatch, [
        ("infill.call", 0, 4_000, MAIN), ("infill.select_predictors", 10, 410, MAIN),
        ("infill.call", 4_000, 8_000, MAIN), ("infill.select_predictors", 4_010, 4_210, MAIN),
        ("params.krig_params", 100, 1_100, MAIN), ("variogram.fit", 100, 150, MAIN),
        ("variogram.fit", 150, 230, MAIN),
        ("xval.sweep_anoms", 1_200, 5_200, MAIN), ("xval.score", 1_300, 2_000, MAIN),
        ("xval.score", 3_000, 4_500, MAIN),
    ])
    assert _read("infill.select_s", run) == pytest.approx((0.4 + 0.2) / 2)
    assert _read("params.gn_fit_s", run) == pytest.approx(0.05 + 0.08)
    assert _read("params.loo_score_s", run) == pytest.approx(0.7 + 1.5)


NAMES = ["engine.main_wait_ms", "engine.fetch_wait_ms", "engine.verify_share", "step.launches",
         "selection.device_ms.grid", "selection.device_ms.params", "infill.select_s",
         "ppca.launches_per_iter", "params.gn_fit_s", "params.loo_score_s"]


@pytest.mark.parametrize("name", NAMES)
def test_nothing_without_a_trace(monkeypatch, name):
    assert _read(name, _run(monkeypatch, GRID, LAUNCH, STEP_OPS, traced=False)) is None


@pytest.mark.parametrize("name", NAMES)
def test_nothing_from_a_program_without_spans(monkeypatch, name):
    """A trace without the program's ranges, and a ``profiling`` module
    without ``recorded``, as before the program had spans."""
    run = _run(monkeypatch, GRID, [("bench.step", 100, 120)], STEP_OPS)
    monkeypatch.delattr(profiling, "recorded")
    assert _read(name, run) is None


def test_each_reader_is_in_the_benchmark():
    names = {m["name"]: m for m in catalog.benchmark_json()["per_layer"]}
    assert set(NAMES) <= set(names)
    assert all("workloads" in names[n] for n in NAMES)
