"""``ppca_impute`` on the card against a float64 run of the same inputs on
the CPU, at config #3's widths (V = 25, q = 12, 200 iterations) on series
with a seasonal cycle, where the EM is far from converged at the cap and
carries any difference of its init along. Marked ``cuda``: it skips without
a CUDA device. Run it on a machine with the card with
``python -m pytest tests/test_torch_cuda_ppca.py -m cuda --noconftest``.

Tolerance: ``filled`` within 2e-3 on 99.9 % of entries and 1e-2 on all (the
CPU's own float32 run sits within 2e-5 / 7e-5 of float64 on these inputs,
measured); iteration counts within one.
"""

import numpy as np
import pytest
import torch

from topotpu_torch.stats.ppca import ppca_impute

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def test_ppca_impute_card_matches_float64(dev):
    rng = np.random.default_rng(5)
    B, T, V, q = 8, 10957, 25, 12
    phase = rng.uniform(0, 0.05, (B, 1, V))
    season = 12.0 * np.cos(2 * np.pi * (np.arange(T)[None, :, None] / 365.25 + phase))
    modes = np.einsum("btk,bvk->btv", rng.standard_normal((B, T, 8)),
                      rng.uniform(0.2, 1.5, (B, V, 8)))
    Y = (season + modes + 0.3 * rng.standard_normal((B, T, V))).astype(np.float32)
    mask = rng.uniform(size=Y.shape) > 0.35
    Y = np.where(mask, Y, 0.0).astype(np.float32)
    kw = dict(n_components=q, max_iters=200, tol=1e-5)

    got = ppca_impute(torch.from_numpy(Y).to(dev), torch.from_numpy(mask).to(dev), **kw)
    want = ppca_impute(torch.from_numpy(Y).double(), torch.from_numpy(mask), **kw)
    d = np.abs(got.filled.cpu().double().numpy() - want.filled.numpy())
    assert np.quantile(d, 0.999) <= 2e-3 and d.max() <= 1e-2, (np.quantile(d, 0.999), d.max())
    d_it = np.abs(got.n_iters.cpu().numpy().astype(int) - want.n_iters.numpy())
    assert d_it.max() <= 1
    np.testing.assert_array_equal(got.filled.cpu().numpy()[mask], Y[mask])
