"""Each cell runs end to end on the CPU at a small size, through the
program's plain paths, and its comparison with the reference fails where it
should: with the control (the reference in TF32 in the program's place) and
with an answer altered where the program produces it."""

import json

import pytest

import tiny

CELLS = sorted(tiny.OVERRIDES)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_and_is_correct(cell):
    out = tiny.run(cell)
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert set(out) == {"correct", "attempted", "failed", "metrics", "device", "checks"}
    assert list(out)[-1] == "checks"  # the numbers compared come last
    json.dumps(out)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert "setup_s" in out["metrics"]
    assert all(c["value"] <= c["limit"] for c in out["checks"].values())


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    out = tiny.run(cell, options={"control": True})
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_altered_answer_is_not_correct(cell):
    out = tiny.run(cell, options={"fault": "answer"})
    assert not out["correct"], out["checks"]


def test_same_seed_same_inputs():
    import torch

    from benchlib import world

    kw = dict(region_rows=16, region_cols=16, lon_min=-106.0, lat_max=41.0, cellsize=1 / 120,
              margin_km=30.0, km2_per_station=200.0, ndays=40, vario=(0.05, 1.0, 40.0),
              dtr_mean=11.0, dtr_sd=2.5, mode_km=300.0, km2_per_mode=250000.0,
              own_anom_frac=0.5)
    a = world.make(tiny.SEED, torch.device("cpu"), **kw)
    b = world.make(tiny.SEED, torch.device("cpu"), **kw)
    c = world.make(tiny.SEED + 1, torch.device("cpu"), **kw)
    assert all((x == y).all() for x, y in zip(a[1], b[1]))
    assert len(a[1].lon) == len(c[1].lon)  # every seed the same sizes
    assert not (a[1].anoms == c[1].anoms).all()


def test_half_the_tiles_unwritten_is_not_correct(monkeypatch):
    from topotpu_torch.dist import engine

    write = engine.TileEngine._write_tile_pair

    def every_other(self, spec, var_a, var_b, result):
        if spec.tile_id % 2 == 0:
            write(self, spec, var_a, var_b, result)

    monkeypatch.setattr(engine.TileEngine, "_write_tile_pair", every_other)
    out = tiny.run("grid.year-chunks")
    assert not out["correct"] and out["checks"]["manifest_faults"]["value"] > 0


def test_half_the_batch_left_out_is_not_correct(monkeypatch):
    from topotpu_torch.infill import pipeline

    batch = pipeline._infill_batch

    def half(obs_all, mask_all, cols, *a):
        filled, iters = batch(obs_all, mask_all, cols, *a)
        rest = cols[len(cols) // 2 :, 0]
        filled[len(cols) // 2 :] = obs_all[rest]  # left as observed, zeros where missing
        return filled, iters

    monkeypatch.setattr(pipeline, "_infill_batch", half)
    assert not tiny.run("network.infill")["correct"]


def test_em_step_returning_its_state_is_not_correct(monkeypatch):
    from topotpu_torch.stats import ppca

    monkeypatch.setattr(ppca, "_em_step", lambda X, W, c, sig2, T, eyeq: (X, W, c, sig2))
    assert not tiny.run("network.infill")["correct"]
