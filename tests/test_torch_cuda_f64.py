"""The float64 validation mode with its float32 side on the card. Marked
``cuda``: it skips without a CUDA device. It imports nothing of the JAX
package, so it runs on the card's machine with
``python -m pytest tests/test_torch_cuda_f64.py -m cuda --noconftest``.

A 64 x 64 tile of a 64 x 64 world, 120 stations, 365 days, k = 16, every
station valid in every month: the float32 side is the production path, one
``krig_normals_indexed`` launch and one launch of ``scatter_daily``'s float
entry, no packed launch; the float64 side runs the plain versions on the CPU.
The bar is the BASELINE parity bar of the validate-f64 step: normal and
daily RMSE under 0.05 C.
"""

import numpy as np
import pytest
import torch

from topotpu_torch.core.config import InterpParams
from topotpu_torch.core.dates import get_days_metadata
from topotpu_torch.interp.f64check import compare_f32_f64
from topotpu_torch.io.synthetic import make_world, tile_inputs_from_world
from topotpu_torch.kernels.krig_normals import krig_normals_indexed
from topotpu_torch.kernels.scatter_daily import scatter_daily, scatter_daily_packed

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def test_compare_f32_f64_on_the_card(dev):
    world = make_world(np.random.default_rng(4), nrows=64, ncols=64, n_stations=120, ndays=365)
    days = get_days_metadata("2015-01-01", "2015-12-31")
    rows, cols = np.unravel_index(np.arange(64 * 64), (64, 64))
    ti, layout = tile_inputs_from_world(world, days.month_idx, rows, cols, dev)
    wrappers = (krig_normals_indexed, scatter_daily, scatter_daily_packed)
    for w in wrappers:
        w.launches = 0
    r = compare_f32_f64(ti, InterpParams(k_neighbors=16), day_valid=layout.day_valid,
                        device=dev)
    assert [w.launches for w in wrappers] == [1, 1, 0]
    assert r["n_compared"] > 0.9 * 12 * 64 * 64
    assert r["normal"]["rmse"] < 0.05 and r["daily"]["rmse"] < 0.05, r
    assert r["se"]["rmse"] < 0.05 and r["ok_flip_rate"] < 0.01, r
