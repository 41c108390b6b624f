"""The share cell (``network.infill-span``) at a tiny size on the CPU: the
driver's set-up, window and check through the program's plain paths, its
comparison failing with the control and with a planted fault, a program
without ``targets`` stopping in set-up, the EM trip's counts against a
hand count, and the cell's two readers on a synthetic trace."""

import collections
import types

import pytest
import tiny

from benchlib import catalog, peaks
from benchlib.record import Record
from test_bench_span_metrics import MAIN, MS, _trace
from topotpu_torch.utils import profiling

CELL = "network.infill-span"
OVERRIDES = {
    "config": {"n_stations": 300, "lon_min": -106.0, "lon_max": -103.0, "lat_min": 38.0,
               "lat_max": 41.0, "start_date": "2014-07-01", "end_date": "2015-12-31",
               "shares": 3,
               "ppca": {"n_components": 4, "n_neighbors": 8, "max_iters": 40, "tol": 1e-5,
                        "batch_size": 32}},
    "traffic": {"warmup_targets": 40},
    "cell": {"sample_targets": 8},
}


def _run(options=None, seconds=0.5):
    import torch

    from benchlib import runner

    ov = dict(OVERRIDES, options=options or {})
    return runner.run_cell(CELL, tiny.SEED, seconds, False, torch.device("cpu"), overrides=ov)


@pytest.fixture
def calls(monkeypatch):
    """The (targets, network size) of every ``infill_network`` call."""
    from topotpu_torch.infill import pipeline

    got = []
    infill = pipeline.infill_network

    def spy(obs, *a, targets=None, **kw):
        got.append((None if targets is None else targets.tolist(), len(obs)))
        return infill(obs, *a, targets=targets, **kw)

    monkeypatch.setattr(pipeline, "infill_network", spy)
    return got


def test_span_cell_runs_and_is_correct(calls, monkeypatch):
    """Set-up, a window of three calls (the driver's clock stands still
    until the third has ended, whatever the host's speed) and the check."""
    drv = catalog.load_module("drivers", "network_span")
    monkeypatch.setattr(drv, "time", types.SimpleNamespace(
        perf_counter=lambda: 0.0 if len(calls) < 4 else 1e9))
    load = catalog.load_module
    monkeypatch.setattr(catalog, "load_module", lambda kind, name, dirs=None: (
        drv if (kind, name) == ("drivers", "network_span") else load(kind, name, dirs)))
    out = _run()
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and "setup_s" in out["metrics"]
    warm, window = calls[0], calls[1:]
    assert warm == (list(range(0, 120, 3)), 300)  # 40 targets of share 0, all stations
    assert len(window) == 3 and out["attempted"] == 300
    for i, (targets, pool) in enumerate(window):
        assert pool == 300 and targets == list(range(i % 3, 300, 3))  # shares in turn
    assert {"filled_err_C", "normal_err_C", "predictor_shortfall", "observed_changed",
            "predictor_faults", "nonfinite_values"} == set(out["checks"])


@pytest.mark.parametrize("options", [{"control": True}, {"fault": "answer"}])
def test_span_cell_control_and_fault_are_not_correct(options):
    out = _run(options)
    assert not out["correct"], out["checks"]
    c = out["checks"]["filled_err_C"]
    assert c["value"] > c["limit"]


def test_a_program_without_targets_stops_in_setup(monkeypatch):
    """The parent of the cell: ``infill_network`` without ``targets`` stops
    set-up before the world is made."""
    from benchlib import network
    from topotpu_torch.infill import pipeline

    def old(obs, month_idx, params, batch_size=None, stn_lon=None, stn_lat=None,
            min_obs_days=365, *, device):
        raise AssertionError("called")

    monkeypatch.setattr(pipeline, "infill_network", old)
    monkeypatch.setattr(network, "network", lambda ctx: pytest.fail("the world was made"))
    with pytest.raises(SystemExit, match="takes no targets"):
        _run()


def test_em_step_counts():
    c = catalog.load_module("counts", "ppca_em_step")
    B, T, V, q = 2, 10, 3, 2
    # a day: 8 V q + 4 q^2 + 12 V = 48 + 16 + 36; a target: 2 V q^2 + q + 2 q^3
    # + 2 q^2 + 2 q^3 / 3 + 2 V q^2 + V = 24 + 2 + 16 + 8 + 16 / 3 + 24 + 3
    assert c.flops(B, T, V, q) == pytest.approx(2 * (10 * 100 + 77 + 16 / 3))
    # X, Yc, mask read and X written (13 B an entry); W, c, sigma^2, delta,
    # the count read and written (4 B each), the flag read and written
    assert c.nbytes(B, T, V, q) == 2 * 10 * 3 * 13 + 2 * (2 * 4 * (6 + 3 + 3) + 2)
    # config #3's trip at 25,203 days is bound by its bytes
    big = (32, 25203, 25, 12)
    least = c.nbytes(*big) / peaks.HBM_BYTES_PER_S
    assert peaks.bound_s(c.nbytes(*big), c.flops(*big)) == least


def _records(monkeypatch, records):
    """The program's records [(id, name, t0_ms, t1_ms, key, parent)] as taken
    under a profiler."""
    got = collections.deque(maxlen=100)
    for i, name, a, b, key, parent in records:
        got.append(profiling.SpanRecord(i, name, int(a * MS), int(b * MS), MAIN, key, parent))
    monkeypatch.setattr(profiling, "_profiled", got)


SHAPE = (32, 1000, 25, 12)
RECORDS = [(1, "ppca.impute", 100, 400, SHAPE, None), (2, "ppca.em_step", 110, 120, None, 1),
           (3, "ppca.em_step", 130, 140, None, 1), (4, "ppca.sync", 141, 142, None, 1),
           (5, "infill.select.device", 10, 90, (5, 300, 1000), None)]
RANGES = [("infill.select.device", 10, 90), ("ppca.impute", 100, 400),
          ("ppca.em_step", 110, 120), ("ppca.em_step", 130, 140), ("ppca.sync", 141, 142)]
OPS = [("upload", 11, 20, 30), ("gemm", 40, 30, 32.5), ("topk", 80, 33, 34),
       ("em_a", 111, 112, 112.2), ("em_b", 112, 112.2, 112.3), ("em_c", 131, 132, 132.3),
       ("flag", 141.5, 142, 142.01)]


def _read(name, traced=True):
    run = Record()
    run.main_thread = MAIN
    run.trace = _trace(RANGES, OPS) if traced else None
    return catalog.load_module("metrics", name).read(run)


def test_span_cell_readers(monkeypatch):
    _records(monkeypatch, RECORDS)
    assert _read("infill.select_device_ms") == pytest.approx(10 + 2.5 + 1, rel=1e-6)
    c = catalog.load_module("counts", "ppca_em_step")
    least = peaks.bound_s(c.nbytes(*SHAPE), c.flops(*SHAPE))
    trip = (0.2 + 0.1 + 0.3) / 2 * 1e-3  # s of device time a trip
    assert _read("ppca.em_step_roofline") == pytest.approx(100 * least / trip, rel=1e-6)


@pytest.mark.parametrize("name", ["infill.select_device_ms", "ppca.em_step_roofline"])
def test_span_cell_readers_read_nothing_without_their_spans(monkeypatch, name):
    """Nothing without a trace; the roofline nothing from a program whose
    trips have no ``ppca.impute`` parent, as before the span existed."""
    _records(monkeypatch, RECORDS)
    assert _read(name, traced=False) is None
    _records(monkeypatch, [(2, "ppca.em_step", 110, 120, None, 9),
                           (3, "ppca.em_step", 130, 140, None, 9)])
    if name == "ppca.em_step_roofline":
        assert _read(name) is None
