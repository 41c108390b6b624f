"""The port's fused OK solve (plain version, both entries) against the JAX
Pallas kernel ``pallas_krig.ok_solve_fused`` / ``ok_solve_fused_xyz`` in
interpret mode, on the CPU.

Tolerances are ``tests/test_pallas_krig.py``'s: weights rtol 2e-4, atol 2e-5
(5e-5 at k = 64, whose TPU kernel takes the looped factorisation), variance
rtol 2e-3, atol 1e-4; ok flags identical; masked slots exactly 0. The xyz
cases keep every pair distance inside the TPU kernel's Taylor-series window
(``ASIN_VALID_KM``), where its asin matches the port's exact one to 1e-6
relative. The JAX kernel needs B to be a multiple of 128; the port takes any
B, so a ragged B is checked against the JAX run on the padded batch.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from topotpu.kernels import pallas_krig
from topotpu.oracle.numpy_ref import haversine_km
from topotpu_torch.kernels.ok_solve_fused import (
    ok_solve_fused,
    ok_solve_fused_xyz,
)

torch.set_num_threads(1)


def _setup(seed, B, k, masked):
    """Batch-last inputs, as ``test_pallas_krig._setup`` builds them, plus the
    unit-sphere rows of the same neighbours."""
    rng = np.random.default_rng(seed)
    lon = rng.uniform(-104, -102, (B, k))
    lat = rng.uniform(39, 41, (B, k))
    dp = haversine_km(lon[:, :, None], lat[:, :, None],
                      lon[:, None, :], lat[:, None, :]).astype(np.float32)
    for b in range(B):
        np.fill_diagonal(dp[b], 0.0)
    d0 = haversine_km(rng.uniform(-104, -102, (B, 1)), rng.uniform(39, 41, (B, 1)),
                      lon, lat).astype(np.float32)
    mask = np.ones((B, k), bool)
    if masked:
        mask[:, -masked:] = False
    lonr, latr = np.deg2rad(lon), np.deg2rad(lat)
    xyz = np.stack([np.cos(latr) * np.cos(lonr), np.cos(latr) * np.sin(lonr),
                    np.sin(latr)])  # (3, B, k)
    f32 = lambda a: np.ascontiguousarray(a, np.float32)  # noqa: E731
    return dict(
        dp=f32(dp.transpose(1, 2, 0)), xyz=f32(xyz.transpose(0, 2, 1).reshape(3 * k, B)),
        d0=f32(d0.T), mask=f32(mask.T), nug=f32(rng.uniform(0.01, 0.1, B)),
        ps=f32(rng.uniform(0.5, 2.0, B)), rg=f32(rng.uniform(30, 150, B)),
    )


def _jax(case, xyz, B):
    fn = pallas_krig.ok_solve_fused_xyz if xyz else pallas_krig.ok_solve_fused
    first = case["xyz"] if xyz else case["dp"]
    w, var, ok = fn(*(jnp.asarray(a[..., :B]) for a in (
        first, case["d0"], case["mask"], case["nug"], case["ps"], case["rg"])),
        jitter_frac=1e-5, min_neighbors=3, interpret=True)
    return np.asarray(w), np.asarray(var), np.asarray(ok)


def _port(case, xyz, B):
    fn = ok_solve_fused_xyz if xyz else ok_solve_fused
    first = case["xyz"] if xyz else case["dp"]
    out = fn(*(torch.from_numpy(np.ascontiguousarray(a[..., :B])) for a in (
        first, case["d0"], case["mask"], case["nug"], case["ps"], case["rg"])),
        jitter_frac=1e-5, min_neighbors=3)
    return tuple(t.numpy() for t in out)


@pytest.mark.parametrize("xyz", [False, True], ids=["pair", "xyz"])
@pytest.mark.parametrize("k, masked", [(16, 3), (64, 5)])
def test_ok_solve_matches_pallas_kernel(xyz, k, masked):
    B = 128
    case = _setup(k, B, k, masked)
    # xyz cases stay inside the TPU kernel's Taylor window
    assert case["dp"].max() < pallas_krig.ASIN_VALID_KM
    w, var, ok = _port(case, xyz, B)
    jw, jvar, jok = _jax(case, xyz, B)
    assert w.shape == (k, B) and var.shape == (B,) and ok.dtype == bool
    np.testing.assert_allclose(w, jw, rtol=2e-4, atol=5e-5 if k > 32 else 2e-5)
    np.testing.assert_allclose(var, jvar, rtol=2e-3, atol=1e-4)
    np.testing.assert_array_equal(ok, jok)
    assert ok.all()
    assert np.all(w[case["mask"] < 0.5] == 0.0)
    np.testing.assert_allclose(w.sum(0), 1.0, atol=1e-4)


@pytest.mark.parametrize("xyz", [False, True], ids=["pair", "xyz"])
def test_ok_solve_flags_underpopulated(xyz):
    """Two valid slots of eight (min_neighbors = 3): no cell is ok, in the
    port as in the JAX kernel, and masked weights stay exactly 0."""
    case = _setup(1, 128, 8, 6)
    w, var, ok = _port(case, xyz, 128)
    jw, jvar, jok = _jax(case, xyz, 128)
    assert not ok.any() and not jok.any()
    assert np.all(w[case["mask"] < 0.5] == 0.0)
    np.testing.assert_allclose(w, jw, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(var, jvar, rtol=2e-3, atol=1e-4)


def test_ok_solve_ragged_batch():
    """B = 200 is no multiple of 128: the port takes it as it is and agrees
    with the JAX kernel's run on the first 128 cells and on the padded 256."""
    k, B = 16, 200
    case = _setup(2, 256, k, 2)
    w, var, ok = _port(case, False, B)
    assert w.shape == (k, B)
    jw, jvar, jok = _jax(case, False, 256)
    np.testing.assert_allclose(w, jw[:, :B], rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(var, jvar[:B], rtol=2e-3, atol=1e-4)
    np.testing.assert_array_equal(ok, jok[:B])
    wx, varx, okx = _port(case, True, B)
    jwx, jvarx, jokx = _jax(case, True, 256)
    np.testing.assert_allclose(wx, jwx[:, :B], rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(varx, jvarx[:B], rtol=2e-3, atol=1e-4)
    np.testing.assert_array_equal(okx, jokx[:B])


@pytest.mark.parametrize("xyz", [False, True], ids=["pair", "xyz"])
def test_ok_solve_exactly_min_neighbors_is_ok(xyz):
    """Three valid slots of eight with min_neighbors = 3: every cell is ok
    (the rule is n_valid >= min_neighbors), as in the JAX kernel."""
    case = _setup(4, 128, 8, 5)
    w, var, ok = _port(case, xyz, 128)
    jw, jvar, jok = _jax(case, xyz, 128)
    assert ok.all() and jok.all()
    np.testing.assert_allclose(w, jw, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(var, jvar, rtol=2e-3, atol=1e-4)
    np.testing.assert_allclose(w.sum(0), 1.0, atol=1e-5)
    assert np.all(w[3:] == 0.0)


@pytest.mark.parametrize("k", [16, 64])
def test_ok_solve_pair_reads_lower_triangle(k):
    """A pair tensor whose strict upper triangle is NaN, against the
    symmetric one. The port reads the diagonal and the lower triangle only,
    at every k, so it gives the symmetric result. The JAX kernel does too at
    k <= 32 (its unrolled factorisation reads columns); above 32 its looped
    factorisation reads rows of the full matrix (``_chol_and_two_solves_looped``),
    so NaN reaches every weight and variance and no cell is ok: recorded here
    as that kernel's behaviour. ``chip_smoke.py``'s bound for the pair entry
    counts k (k + 1) / 2 pair floats a cell where both read only those."""
    B = 128
    case = _setup(k + 7, B, k, 3)
    nan_up = dict(case, dp=case["dp"].copy())
    rows, cols = np.triu_indices(k, 1)
    nan_up["dp"][rows, cols, :] = np.nan
    for got, want in zip(_port(nan_up, False, B), _port(case, False, B)):
        np.testing.assert_array_equal(got, want)
    jw, jvar, jok = _jax(nan_up, False, B)
    if k <= pallas_krig.LOOPED_K_THRESHOLD:
        for got, want in zip((jw, jvar, jok), _jax(case, False, B)):
            np.testing.assert_array_equal(got, want)
    else:
        assert np.isnan(jw).all() and np.isnan(jvar).all() and not jok.any()
