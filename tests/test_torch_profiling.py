"""The port's spans and their exporter (``topotpu_torch.utils.profiling``).

``span`` records nothing and allocates nothing where nothing records;
``recording()`` keeps every thread's spans with their parents and keys; the
program's stages open their spans where the work happens (the engine's three
threads, the PPCA EM loop, the station sweeps); under ``torch.profiler`` a
span is also a ``record_function`` range of its name; ``device_trace``
writes the Chrome trace and the spans on its clock. On the CPU, at small
sizes.
"""

import collections
import json
import math
import pathlib
import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from topotpu_torch.core.config import InterpParams, PPCAParams, TopoConfig, VariogramParams
from topotpu_torch.core.dates import get_days_metadata
from topotpu_torch.dist import engine as tengine
from topotpu_torch.infill import infill_network
from topotpu_torch.interp.params import build_krig_params
from topotpu_torch.interp.xval import optimize_nnghs_anoms
from topotpu_torch.io.rasters import RasterStack
from topotpu_torch.io.synthetic import (
    make_world,
    station_arrays_from_world,
    station_network_from_world,
)
from topotpu_torch.utils import profiling as prof

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
from chip_smoke import MemoryMosaic  # noqa: E402

torch.set_num_threads(1)

CPU = torch.device("cpu")
VARS = ("tmin", "tmax")
WRITE_CHILDREN = {"engine.write.mosaic", "engine.write.verify", "engine.write.viol",
                  "engine.write.manifest", "engine.write.pace"}


def _by_name(records):
    out = collections.defaultdict(list)
    for r in records:
        out[r.name].append(r)
    return out


def _children(records, parent, name=None):
    return [r for r in records if r.parent == parent.id and name in (None, r.name)]


# ----------------------------------------------------------------- recorder


def test_span_off_is_the_shared_noop_and_records_nothing():
    before = len(prof.recorded())
    a, b = prof.span("a"), prof.span("b", key=(1, 2))
    assert a is b is prof._OFF
    with a, b:
        pass
    assert len(prof.recorded()) == before


def test_recording_nests_parents_per_thread_and_keeps_keys_and_threads():
    def other():
        with prof.span("w.outer", key=7):
            with prof.span("w.inner"):
                pass

    with prof.recording() as got:
        with prof.span("m.outer", key=(0, 3)):
            t = threading.Thread(target=other)
            t.start()
            with prof.span("m.inner"):
                t.join()
            with prof.span("m.second"):
                pass
    by = {r.name: r for r in got}
    assert set(by) == {"m.outer", "m.inner", "m.second", "w.outer", "w.inner"}
    main = threading.get_native_id()
    assert {by[n].thread for n in ("m.outer", "m.inner", "m.second")} == {main}
    assert by["w.outer"].thread == by["w.inner"].thread == t.native_id != main
    # a span's parent is the innermost span open on its own thread
    assert by["m.inner"].parent == by["m.second"].parent == by["m.outer"].id
    assert by["w.inner"].parent == by["w.outer"].id
    assert by["m.outer"].parent is None and by["w.outer"].parent is None
    assert by["m.outer"].key == (0, 3) and by["w.outer"].key == 7 and by["m.inner"].key is None
    for r in got:
        assert r.t0 <= r.t1
    assert by["m.outer"].t0 <= by["m.inner"].t0 <= by["m.inner"].t1 <= by["m.outer"].t1
    assert got[-1].name == "m.outer"  # appended as each span closes


def test_spans_of_many_threads_lose_no_record_and_keep_their_own_parents():
    """More threads than cores, switching as often as the interpreter can:
    every record arrives once, ids are unique, and each inner span's parent
    is the outer span of its own thread."""
    import sys

    n_threads, n_spans = 16, 300
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(i):
            for j in range(n_spans):
                with prof.span("outer", key=(i, j)):
                    with prof.span("inner", key=(i, j)):
                        pass

        with prof.recording() as got:
            threads = [threading.Thread(target=work, args=(i,)) for i in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert len(got) == 2 * n_threads * n_spans
    assert len({r.id for r in got}) == len(got)
    outer = {r.id: r for r in got if r.name == "outer"}
    for r in got:
        if r.name == "inner":
            o = outer[r.parent]
            assert (o.key, o.thread) == (r.key, r.thread)
        else:
            assert r.parent is None


def test_nested_recordings_each_get_every_record_and_stop_at_their_end():
    with prof.recording() as outer:
        with prof.span("a"):
            pass
        with prof.recording() as inner:
            with prof.span("b"):
                pass
        with prof.span("c"):
            pass
    assert [r.name for r in outer] == ["a", "b", "c"]
    assert [r.name for r in inner] == ["b"]
    assert prof.span("d") is prof._OFF


def test_a_span_that_raises_is_recorded_and_leaves_the_stack_as_it_was():
    with prof.recording() as got:
        with prof.span("outer"):
            with pytest.raises(ValueError):
                with prof.span("fails"):
                    raise ValueError("x")
            with prof.span("after"):
                pass
    by = {r.name: r for r in got}
    assert by["fails"].parent == by["after"].parent == by["outer"].id


def test_recorded_keeps_the_newest_profiled_records_within_the_window(monkeypatch):
    monkeypatch.setattr(prof, "_profiled", collections.deque(maxlen=3))
    import time

    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(5):
            with prof.span("s", key=i):
                pass
        t_mid = time.perf_counter()
        with prof.span("late"):
            pass
    assert [r.key for r in prof.recorded()] == [3, 4, None]
    assert [r.name for r in prof.recorded(t0=t_mid)] == ["late"]
    assert [r.key for r in prof.recorded(t1=t_mid)] == [3, 4]


def test_a_span_opens_a_record_function_only_under_a_profiler(monkeypatch):
    opened = []

    class Counting:
        def __init__(self, name):
            opened.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(prof, "record_function", Counting)
    with prof.recording() as got:
        with prof.span("quiet"):
            pass
    assert [r.name for r in got] == ["quiet"] and opened == []
    with profile(activities=[ProfilerActivity.CPU]):
        with prof.span("traced"):
            pass
    assert opened == ["traced"]


def test_main_thread_spans_are_profiler_ranges_of_the_same_names_and_nesting(tmp_path):
    x = torch.ones(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as p:
        with prof.span("t.outer"):
            with prof.span("t.inner"):
                (x @ x).sum()
            with prof.span("t.inner"):
                (x + x).sum()
    p.export_chrome_trace(str(tmp_path / "t.json"))
    events = json.loads((tmp_path / "t.json").read_text())["traceEvents"]
    ranges = [e for e in events if e.get("cat") == "user_annotation"
              and e["name"].startswith("t.")]
    outer = [e for e in ranges if e["name"] == "t.outer"]
    inner = [e for e in ranges if e["name"] == "t.inner"]
    assert len(outer) == 1 and len(inner) == 2
    o = outer[0]
    for e in inner:
        assert o["ts"] <= e["ts"] and e["ts"] + e["dur"] <= o["ts"] + o["dur"]
        assert e["tid"] == o["tid"] == threading.get_native_id()
    names = [e["name"] for e in events if e.get("cat") == "cpu_op"]
    assert "aten::mm" in names
    got = [r for r in prof.recorded() if r.name.startswith("t.")][-3:]
    assert [r.name for r in got] == ["t.inner", "t.inner", "t.outer"]
    assert got[0].parent == got[1].parent == got[2].id


def test_device_trace_writes_a_trace_on_the_cpu(tmp_path):
    x = torch.ones(128, 128)
    with prof.device_trace(tmp_path / "trace"):
        (x @ x).sum()
    events = json.loads((tmp_path / "trace" / "trace.json").read_text())["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)
    assert json.loads((tmp_path / "trace" / "spans.json").read_text()) == {"spans": []}


# ------------------------------------------------------------------ engine


@pytest.fixture(scope="module")
def engine_trace(tmp_path_factory):
    """A direct-mode ``run_production_pair`` over two one-year chunks (four
    24 x 24 tiles a chunk) under ``device_trace``: (records, trace dir,
    tile-pairs written)."""
    root = tmp_path_factory.mktemp("engine")
    days = get_days_metadata("2014-01-01", "2015-12-31")
    w = make_world(np.random.default_rng(43), nrows=48, ncols=48, n_stations=60,
                   ndays=days.ndays)
    a = tengine.StationSet(
        lon=w.stn_lon, lat=w.stn_lat, elev=w.stn_elev, tdi=w.stn_tdi, lst=w.stn_lst,
        norm=w.stn_norm, vario=np.tile(np.asarray(w.true_vario, np.float32), (60, 12, 1)),
        valid=np.ones((60, 12), bool), anoms=w.stn_anoms.astype(np.float32))
    b = tengine.StationSet(**{**a.__dict__, "norm": a.norm + 9.0,
                              "anoms": (a.anoms * 0.85).astype(np.float32)})
    cfg = TopoConfig(start_date="2014-01-01", end_date="2015-12-31", tile_rows=24,
                     tile_cols=24, interp=InterpParams(k_neighbors=16, max_tile_stations=64))
    class Engine(tengine.TileEngine):
        MOSAIC_WRITER = MemoryMosaic  # runs where h5py is missing too

    eng = Engine(cfg, RasterStack.from_world(w), days, root / "tiles", device=CPU,
                 mosaic_paths={v: root / f"mosaic_{v}" for v in VARS})
    with prof.device_trace(root / "trace") as got:
        done = eng.run_production_pair(*VARS, a, b, years_per_chunk=1, progress=False)
    assert done == {"tmin": 8, "tmax": 8}
    return list(got), root / "trace", 8


def test_engine_spans_of_every_tile_pair_share_its_key(engine_trace):
    got, _, n_pairs = engine_trace
    by = _by_name(got)
    main = threading.get_native_id()
    keys = {r.key for r in by["engine.write"]}
    assert len(keys) == len(by["engine.write"]) == n_pairs
    assert {k[0] for k in keys} == {0, 365}  # the chunks' day offsets
    assert sorted(r.key for r in by["engine.chunk"]) == [0, 365]
    threads = {}
    for name in ("engine.prepare", "engine.launch", "engine.fetch_wait", "engine.write"):
        assert sorted(r.key for r in by[name]) == sorted(keys), name
        threads[name] = {r.thread for r in by[name]}
    assert threads["engine.prepare"] == threads["engine.launch"] == {main}
    # each chunk's pipeline runs a fetch thread and a writer thread of its own
    fetch, writer = threads["engine.fetch_wait"], threads["engine.write"]
    assert len(fetch) == len(writer) == 2 and not (fetch & writer) and main not in fetch | writer
    for w in by["engine.write"]:
        kids = _children(got, w)
        assert WRITE_CHILDREN <= {r.name for r in kids}, w.key
        assert all(r.thread == w.thread and w.t0 <= r.t0 <= r.t1 <= w.t1 for r in kids)
    for p in by["engine.prepare"]:
        assert {r.name for r in _children(got, p)} == {"engine.prepare.host", "engine.stage"}
    for launch in by["engine.launch"]:
        kids = {r.name for r in _children(got, launch)}
        assert {"geo.distance", "geo.select_neighbors"} <= kids
    chunks = {r.id for r in by["engine.chunk"]}
    assert all(r.parent in chunks for r in by["engine.drain"])
    assert len(by["engine.drain"]) == 2


def test_device_trace_writes_the_trace_and_the_spans_on_its_clock(engine_trace):
    got, trace_dir, _ = engine_trace
    trace = json.loads((trace_dir / "trace.json").read_text())
    spans = json.loads((trace_dir / "spans.json").read_text())["spans"]
    assert len(spans) == len(got)
    assert {s["name"] for s in spans} == {r.name for r in got}
    base = int(trace.get("baseTimeNanoseconds", 0))
    timed = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    lo = min(base + 1e3 * float(e["ts"]) for e in timed)
    hi = max(base + 1e3 * (float(e["ts"]) + float(e.get("dur", 0))) for e in timed)
    writer = {s["thread"] for s in spans if s["name"] == "engine.write"}
    on_writer = [s for s in spans if s["thread"] in writer]
    assert on_writer and all(lo <= s["t0"] <= s["t1"] <= hi for s in on_writer)
    assert all(isinstance(s["key"], list) for s in spans if s["name"] == "engine.write")
    # the main thread's spans are the trace's own ranges, in order
    main = threading.get_native_id()
    ranges = sorted((e for e in timed if e.get("cat") == "user_annotation"
                     and e.get("tid") == main), key=lambda e: e["ts"])
    mine = sorted((s for s in spans if s["thread"] == main), key=lambda s: s["t0"])
    assert [e["name"] for e in ranges] == [s["name"] for s in mine]
    gap = max(abs(base + 1e3 * float(e["ts"]) - s["t0"]) for e, s in zip(ranges, mine))
    assert gap < 5e6, gap  # ns


# ------------------------------------------------------------------- infill


@pytest.fixture(scope="module")
def network():
    world = make_world(np.random.default_rng(42), nrows=30, ncols=30, n_stations=40,
                       ndays=365)
    days = get_days_metadata("2015-01-01", "2015-12-31")
    _, obs = station_network_from_world(world, days.month_idx, 0.2, seed=1)
    return world, days, obs


@pytest.mark.parametrize("max_iters,tol", [(200, 1e-3), (5, 1e-5)], ids=["stops", "cap"])
def test_infill_records_one_em_step_a_trip_and_one_sync_a_flag_read(network, max_iters, tol):
    world, days, obs = network
    batch = 16
    params = PPCAParams(n_components=4, n_neighbors=8, max_iters=max_iters, tol=tol,
                        batch_size=batch)
    with prof.recording() as got:
        res = infill_network(obs, days.month_idx, params, stn_lon=world.stn_lon,
                             stn_lat=world.stn_lat, device=CPU)
    (call,) = [r for r in got if r.name == "infill.call"]
    assert call.key == (obs.shape[0], obs.shape[0])  # (targets, stations)
    assert {r.name for r in _children(got, call)} == {
        "infill.select_predictors", "infill.batch", "infill.fetch", "infill.normals"}
    batches = sorted(_children(got, call, "infill.batch"), key=lambda r: r.key)
    S = obs.shape[0]
    order = np.argsort(np.isfinite(obs).sum(axis=1), kind="stable")
    order = order[np.arange(math.ceil(S / batch) * batch) % S]
    assert [r.key for r in batches] == list(range(len(order) // batch))
    stopped = 0
    for b in batches:
        (imp,) = _children(got, b, "ppca.impute")  # one EM a batch, keyed by its shape
        assert imp.key == (batch, obs.shape[1], 1 + params.n_neighbors, params.n_components)
        assert {r.name for r in _children(got, b)} == {"ppca.impute"}
        steps = len(_children(got, imp, "ppca.em_step"))
        syncs = len(_children(got, imp, "ppca.sync"))
        most = int(res.n_iters[order[b.key * batch : (b.key + 1) * batch]].max())
        if steps == max_iters:
            assert syncs == math.ceil(max_iters / 8)
        else:  # stopped at a flag read, at most 7 trips after the last active one
            stopped += 1
            assert most <= steps <= most + 7 and steps % 8 == 0
            assert syncs == steps // 8 + 1
    assert stopped == (len(batches) if max_iters == 200 else 0)


@pytest.mark.parametrize("share", [False, True], ids=["whole", "share"])
def test_infill_records_the_device_selection_keyed_by_its_rows(network, monkeypatch, share):
    """With the device branch taken, one ``infill.select.device`` record
    inside ``infill.select_predictors``, keyed (gram rows, stations, days),
    and ``infill.call`` keyed (targets, stations)."""
    from topotpu_torch.infill import pipeline

    world, days, obs = network
    monkeypatch.setattr(pipeline, "DEVICE_SELECT_FLOPS", 0.0)
    S, T = obs.shape
    targets = np.arange(1, S, 3) if share else None
    n_t = S if targets is None else len(targets)
    params = PPCAParams(n_components=4, n_neighbors=8, max_iters=5, batch_size=16)
    with prof.recording() as got:
        res = infill_network(obs, days.month_idx, params, stn_lon=world.stn_lon,
                             stn_lat=world.stn_lat, device=CPU, targets=targets)
    assert res.filled.shape == (n_t, T)
    (call,) = [r for r in got if r.name == "infill.call"]
    assert call.key == (n_t, S)
    (sel,) = _children(got, call, "infill.select_predictors")
    (dev,) = [r for r in got if r.name == "infill.select.device"]
    assert dev.parent == sel.id and dev.key == (n_t, S, T)


# ------------------------------------------------------- station parameters


@pytest.fixture(scope="module")
def stations():
    world = make_world(np.random.default_rng(17), nrows=40, ncols=40, n_stations=80,
                       ndays=365, cellsize=1.0 / 30.0, vario=(0.05, 1.0, 160.0))
    return station_arrays_from_world(world)


def test_nnghs_anoms_records_one_loo_daily_a_candidate_with_fetch_and_score(stations):
    """The sweep's inputs are made once (one ``xval.daily_inputs``, keyed by
    the candidates it serves, holding the anomalies' grouping on the device,
    ``xval.group_anoms`` keyed (S, T), then the 12 months' selection: one
    ``geo.select_neighbors`` keyed by its 12 months), then one
    ``xval.loo_daily`` a candidate holds its scoring and its one fetch."""
    with prof.recording() as got:
        optimize_nnghs_anoms(*stations.krig(), stations.anoms, stations.month_idx,
                             candidates=(8, 12, 16), base_params=InterpParams(k_neighbors=16),
                             device=CPU)
    (sweep,) = [r for r in got if r.name == "xval.sweep_anoms"]
    (inputs,) = _children(got, sweep, "xval.daily_inputs")
    assert inputs.key == 3
    group, sel = _children(got, inputs)
    assert (group.name, group.key) == ("xval.group_anoms", stations.anoms.shape)
    assert (sel.name, sel.key) == ("geo.select_neighbors", 12)
    assert group.t1 <= sel.t0
    assert sum(r.name == "xval.group_anoms" for r in got) == 1
    assert sum(r.name == "geo.select_neighbors" for r in got) == 1
    loo = _children(got, sweep, "xval.loo_daily")
    assert sorted(r.key for r in loo) == [8, 12, 16]
    assert all(inputs.t1 <= r.t0 for r in loo)
    for r in loo:
        kids = [c.name for c in _children(got, r)]
        assert kids.count("xval.fetch") == 1 and kids.count("xval.score") == 1
        assert "geo.select_neighbors" not in kids


def test_krig_params_records_one_variogram_fit_a_month(stations):
    s = stations
    with prof.recording() as got:
        build_krig_params(s.lon, s.lat, s.elev, s.tdi, s.lst, s.norm, s.valid,
                          VariogramParams(k_fit_neighbors=16, gn_iters=5), InterpParams(),
                          device=CPU)
    (call,) = [r for r in got if r.name == "params.krig_params"]
    fits = _children(got, call, "variogram.fit")
    assert [r.key for r in fits] == list(range(12))
    for f in fits:
        assert [(c.name, c.key) for c in _children(got, f)] == [("geo.select_neighbors", 1)]
