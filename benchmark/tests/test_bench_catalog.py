"""Every cell, configuration, traffic mix, metric and count of
``BENCHMARK.json`` is found by name, and a cell added as a file is picked
up with no change to the code."""

import json

import tiny  # noqa: F401  (paths)

from benchlib import catalog


def test_benchmark_names_resolve():
    b = catalog.benchmark_json()
    for c in b["configs"]:
        assert (catalog.ROOT / c["file"]).is_file()
        assert catalog.load_json("configs", c["name"])["name"] == c["name"]
    for w in b["workloads"]:
        found = catalog.resolve(w["name"])
        assert found["cell"]["config"] == w["config"]
        assert found["cell"]["traffic"] == w["traffic"]
        assert found["cell"]["chips"] == w["chips"]
        assert callable(catalog.load_module("drivers", found["driver"]).window)
        e2e, per_layer = catalog.cell_metrics(b, w["name"])
        names = {m["name"] for m in e2e}
        assert "setup_s" in names and len(names) >= 2 and per_layer
    for m in b["end_to_end"] + b["per_layer"]:
        assert callable(catalog.load_module("metrics", m["name"]).read)


def test_a_cell_file_is_picked_up(tmp_path):
    cell = json.loads((catalog.BENCH_DIR / "cells" / "grid.year-chunks.json").read_text())
    (tmp_path / "grid.tiny-added.json").write_text(json.dumps(cell))
    bench = catalog.benchmark_json()
    bench["workloads"].append({"name": "grid.tiny-added", "config": cell["config"],
                               "traffic": cell["traffic"], "chips": 1, "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "grid.year-chunks" in m.get("workloads", []):
            m["workloads"].append("grid.tiny-added")
    tiny.OVERRIDES["grid.tiny-added"] = tiny.OVERRIDES["grid.year-chunks"]
    try:
        out = tiny.run("grid.tiny-added", bench=bench, cell_dirs=[tmp_path])
        traced = tiny.run("grid.tiny-added", trace=True, bench=bench, cell_dirs=[tmp_path])
    finally:
        del tiny.OVERRIDES["grid.tiny-added"]
    assert out["correct"] and traced["correct"]
    assert "setup_s" in out["metrics"]  # mem_peak_gib reads nothing without a GPU
    assert {"engine.product_rate", "engine.tile_pair_p95_ms",
            "engine.write_ms"} <= set(traced["metrics"])


def test_each_per_layer_metric_moves_an_end_to_end_metric_of_its_cells():
    b = catalog.benchmark_json()
    for w in b["workloads"]:
        e2e, per_layer = catalog.cell_metrics(b, w["name"])
        names = {m["name"] for m in e2e}
        assert all(m["moves"] in names for m in per_layer), w["name"]
