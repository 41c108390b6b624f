"""The reader of ``params.fit_launches`` against values worked out by hand,
on the synthetic traces and span records of ``test_bench_span_metrics``:
the device operations launched inside the ``variogram.fit`` ranges, over the
number of those ranges. It reads nothing without a trace, and nothing from a
program without spans."""

import pytest
import tiny  # noqa: F401  (paths)
from test_bench_span_metrics import GRID, LAUNCH, STEP_OPS, _read, _run

from benchlib import catalog
from topotpu_torch.utils import profiling

NAME = "params.fit_launches"


def test_fit_launches_a_month(monkeypatch):
    ranges = [("params.krig_params", 5, 60), ("variogram.fit", 10, 20),
              ("geo.select_neighbors", 11, 13), ("variogram.fit", 20.5, 30),
              ("xval.sweep_normals", 40, 50)]
    ops = [("topk", 12, 50, 51), ("scatter", 15, 51, 52), ("variogram_fit_kernel", 19, 52, 53),
           ("variogram_fit_kernel", 29, 53, 54),
           ("krig", 41, 54, 55)]  # the sweep's launch is not a fit's
    run = _run(monkeypatch, [], ranges, ops)
    assert _read(NAME, run) == pytest.approx(4 / 2)


def test_nothing_without_a_trace(monkeypatch):
    assert _read(NAME, _run(monkeypatch, GRID, LAUNCH, STEP_OPS, traced=False)) is None


def test_nothing_from_a_program_without_spans(monkeypatch):
    """A trace without the program's ranges, and a ``profiling`` module
    without ``recorded``, as before the program had spans."""
    run = _run(monkeypatch, GRID, [("bench.step", 100, 120)], STEP_OPS)
    monkeypatch.delattr(profiling, "recorded")
    assert _read(NAME, run) is None


def test_the_reader_is_in_the_benchmark():
    names = {m["name"]: m for m in catalog.benchmark_json()["per_layer"]}
    assert names[NAME]["workloads"] == ["network.params"]
