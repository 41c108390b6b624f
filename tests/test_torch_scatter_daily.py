"""The port's daily-anomaly contraction against the JAX package: the plain
version (and the wrapper on CPU tensors, which runs it) against the Pallas
``scatter_daily_matmul`` in interpret mode, with duplicate indices, at the
cases of ``tests/test_pallas_scatter.py``; rtol and atol 1e-5."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from topotpu.interp.anoms import predict_daily_gathered as j_gathered
from topotpu.kernels.pallas_scatter import scatter_daily_matmul
from topotpu_torch.interp.anoms import predict_daily, predict_daily_gathered, scatter_gains
from topotpu_torch.kernels.scatter_daily import scatter_daily, scatter_daily_ref

torch.set_num_threads(1)


def _case(seed, C, S, k, D):
    rng = np.random.default_rng(seed)
    g = rng.normal(size=(C, k)).astype(np.float32)
    idx = rng.integers(0, S, (C, k)).astype(np.int32)
    idx[:, 1] = idx[:, 0]  # duplicates accumulate
    mask = rng.uniform(size=(C, k)) > 0.1
    Y = rng.normal(size=(S, D)).astype(np.float32)
    return g, idx, mask, Y


@pytest.mark.parametrize("C, S, k, D", [(1024, 96, 12, 31), (512, 128, 8, 2977)])
def test_matches_pallas_interpret(C, S, k, D):
    g, idx, mask, Y = _case(0, C, S, k, D)
    planes = (idx.T.copy(), g.T.copy(), mask.T.astype(np.float32), Y)
    want = np.asarray(scatter_daily_matmul(*map(jnp.asarray, planes), interpret=True))
    for fn in (scatter_daily_ref, scatter_daily):
        got = fn(*map(torch.from_numpy, planes))
        assert got.shape == (C, D)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_any_cell_count_and_the_anoms_forms_agree():
    """Any C (no multiple-of-512 rule); the port's predict_daily_gathered,
    scatter_gains + predict_daily and the JAX gather form all agree."""
    C, S, k, D = 300, 40, 16, 62
    g, idx, mask, Y = _case(1, C, S, k, D)
    T = torch.from_numpy
    got = scatter_daily(T(idx.T.copy()), T(g.T.copy()), T(mask.T.astype(np.float32)), T(Y))
    want = np.asarray(j_gathered(jnp.asarray(g), jnp.asarray(idx), jnp.asarray(mask),
                                 jnp.asarray(Y)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    gathered = predict_daily_gathered(T(g), T(idx), T(mask), T(Y))
    dense = predict_daily(scatter_gains(T(g), T(idx), T(mask), S), T(Y))
    np.testing.assert_allclose(gathered.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(dense.numpy(), want, rtol=1e-5, atol=1e-5)


def test_wrapper_refuses_mixed_devices():
    g, idx, mask, Y = _case(2, 8, 4, 3, 5)
    T = torch.from_numpy
    with pytest.raises(ValueError, match="several devices"):
        scatter_daily(T(idx.T.copy()), T(g.T.copy()), T(mask.T.astype(np.float32)),
                      T(Y).to("meta"))
