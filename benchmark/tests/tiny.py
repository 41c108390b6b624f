"""Small sizes of the cells for the CPU tests: the same code paths as on the
chip (the program's plain versions run where CUDA kernels would), a region
and a network a test run can hold."""

import os
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (BENCH, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)

SEED = 2147483647 + 12345  # above 32 signed bits, as the driver's seeds may be

OVERRIDES = {
    "grid.year-chunks": {
        "config": {"region_rows": 64, "region_cols": 64, "tile_rows": 32, "tile_cols": 32,
                   "end_date": "1950-12-31", "margin_km": 100.0, "km2_per_station": 400.0,
                   "k_neighbors": 16, "k_neighbors_anom": 16},
        "cell": {"sample_cells": 64},
    },
    "network.infill": {
        "config": {"n_stations": 300, "lon_min": -106.0, "lon_max": -103.0, "lat_min": 38.0,
                   "lat_max": 41.0, "start_date": "2015-01-01", "infill_blocks": 2,
                   "ppca": {"n_components": 4, "n_neighbors": 8, "max_iters": 40, "tol": 1e-5,
                            "batch_size": 32}},
        "traffic": {"warmup_stations": 40},
        "cell": {"sample_targets": 8},
    },
}
OVERRIDES["network.params"] = {
    "config": OVERRIDES["network.infill"]["config"],
    "traffic": {"warmup_stations": 100},
    "cell": {"sample_stations": 16},
}


def run(cell, seconds=0.5, options=None, trace=False, **kw):
    import torch

    from benchlib import runner

    ov = dict(OVERRIDES[cell], options=options or {})
    return runner.run_cell(cell, SEED, seconds, trace, torch.device("cpu"), overrides=ov, **kw)
