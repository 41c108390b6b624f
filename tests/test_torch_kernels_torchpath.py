"""The port's plain batched solves (WLS, GWR gain, OK kriging) against
``topotpu.kernels`` and the float64 numpy oracle, plus the masked-station
algebra: a masked station must not move the kriging mean or variance."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from topotpu.kernels import batched_gwr_gain as j_gain
from topotpu.kernels import batched_wls as j_wls
from topotpu.kernels import ok_solve as j_ok_solve
from topotpu.kernels.cholesky import assemble_exp_cov as j_assemble
from topotpu.kernels.wls import center_design as j_center
from topotpu.oracle import numpy_ref as oracle
from topotpu_torch.kernels import (
    assemble_exp_cov,
    batched_gwr_gain,
    batched_wls,
    center_design,
    ok_solve,
)

torch.set_num_threads(1)
T = torch.from_numpy


def _random_wls(seed, B=16, k=24, p=4):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(B, k, p)).astype(np.float32)
    X[..., 0] = 1.0
    beta = rng.normal(size=(B, p))
    y = (np.einsum("bkp,bp->bk", X, beta) + 0.01 * rng.normal(size=(B, k))).astype(np.float32)
    w = rng.uniform(0.1, 1.0, size=(B, k)).astype(np.float32)
    w[:, -3:] = 0.0  # masked tail
    return X, y, w


def test_wls_and_gain_match_jax_and_oracle():
    X, y, w = _random_wls(0)
    beta = batched_wls(T(X), T(y), T(w)).numpy()
    np.testing.assert_allclose(beta, np.asarray(j_wls(X, y, w)), rtol=1e-4, atol=1e-4)
    for b in range(X.shape[0]):
        np.testing.assert_allclose(beta[b], oracle.wls_lstsq(X[b], y[b], w[b]),
                                   rtol=5e-3, atol=5e-3)
    x0 = np.random.default_rng(1).normal(size=(16, 4)).astype(np.float32)
    g = batched_gwr_gain(T(X), T(w), T(x0)).numpy()
    np.testing.assert_allclose(g, np.asarray(j_gain(X, w, x0)), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose((g * y).sum(-1), (x0 * beta).sum(-1), rtol=1e-3, atol=1e-3)
    assert np.all(g[:, -3:] == 0.0)


def test_center_design_matches_jax():
    rng = np.random.default_rng(2)
    scale = np.array([1000.0, 5.0, 0.01])
    cov = (rng.normal(size=(8, 20, 3)) * scale + [2000.0, 10.0, 0.5]).astype(np.float32)
    pt = (rng.normal(size=(8, 3)) * scale + [2000.0, 10.0, 0.5]).astype(np.float32)
    w = rng.uniform(0.2, 1.0, size=(8, 20)).astype(np.float32)
    X, x0, sc = center_design(T(cov), T(pt), T(w))
    jX, jx0, jsc = j_center(cov, pt, w)
    np.testing.assert_allclose(X.numpy(), np.asarray(jX), rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(x0.numpy(), np.asarray(jx0))
    np.testing.assert_allclose(sc.numpy(), np.asarray(jsc), rtol=1e-5)


def _kriging_setup(seed, B=12, k=16, masked=3):
    rng = np.random.default_rng(seed)
    lon = rng.uniform(-104, -102, size=(B, k))
    lat = rng.uniform(39, 41, size=(B, k))
    dp = oracle.haversine_km(lon[..., :, None], lat[..., :, None],
                             lon[..., None, :], lat[..., None, :])
    d0 = oracle.haversine_km(rng.uniform(-104, -102, (B, 1)),
                             rng.uniform(39, 41, (B, 1)), lon, lat)
    mask = np.ones((B, k), bool)
    if masked:
        mask[:, -masked:] = False
    f = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return (f(dp), f(d0), f(rng.normal(size=(B, k))), mask,
            f(rng.uniform(0.01, 0.1, B)), f(rng.uniform(0.5, 2.0, B)),
            f(rng.uniform(30.0, 150.0, B)))


@pytest.mark.parametrize("jitter", [0.0, 1e-5])
def test_ok_solve_matches_jax_and_augmented_oracle(jitter):
    dp, d0, resid, mask, nug, ps, rg = _kriging_setup(3)
    C, c0, sill = assemble_exp_cov(T(dp), T(d0), T(nug), T(ps), T(rg), T(mask),
                                   jitter_frac=jitter)
    jC, jc0, jsill = j_assemble(dp, d0, nug, ps, rg, mask, jitter_frac=jitter)
    np.testing.assert_allclose(C.numpy(), np.asarray(jC), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(c0.numpy(), np.asarray(jc0), rtol=1e-6, atol=1e-7)
    sol = ok_solve(C, c0, T(mask), sill)
    jsol = j_ok_solve(jC, jc0, jnp.asarray(mask), jsill)
    np.testing.assert_allclose(sol.weights.numpy(), np.asarray(jsol.weights),
                               rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(sol.variance.numpy(), np.asarray(jsol.variance),
                               rtol=1e-3, atol=1e-4)
    np.testing.assert_array_equal(sol.ok.numpy(), np.asarray(jsol.ok))
    if jitter == 0.0:
        pred = (sol.weights.numpy() * resid).sum(-1)
        for b in range(dp.shape[0]):
            m = mask[b]
            want_pred, want_var, want_lam = oracle.ok_krige_augmented(
                dp[b][np.ix_(m, m)], d0[b][m], resid[b][m], nug[b], ps[b], rg[b]
            )
            np.testing.assert_allclose(pred[b], want_pred, rtol=2e-3, atol=2e-3)
            np.testing.assert_allclose(sol.variance.numpy()[b], max(want_var, 0.0),
                                       rtol=2e-2, atol=2e-3)
            np.testing.assert_allclose(sol.weights.numpy()[b][m], want_lam,
                                       rtol=5e-3, atol=5e-3)
    np.testing.assert_allclose(sol.weights.numpy().sum(-1), 1.0, atol=1e-4)


def test_masked_station_cannot_perturb_solution():
    """A masked station gets an identity row and zero right-hand sides, so
    its weight is exactly 0 and the solution equals the one with the station
    pushed infinitely far away."""
    dp, d0, _, mask, nug, ps, rg = _kriging_setup(4, masked=0)
    mask2 = mask.copy()
    mask2[:, -4:] = False

    def run(dpair, dpoint, msk):
        C, c0, sill = assemble_exp_cov(T(dpair), T(dpoint), T(nug), T(ps), T(rg),
                                       T(msk), jitter_frac=0.0)
        return C, c0, ok_solve(C, c0, T(msk), sill)

    C, c0, s_masked = run(dp, d0, mask2)
    # the algebra: masked rows/cols are identity, masked c0 and ones are 0
    eye = torch.eye(16)
    assert torch.equal(C[:, -4:, :], eye[-4:].expand(12, 4, 16))
    assert torch.equal(C[:, :, -4:], eye[:, -4:].expand(12, 16, 4))
    assert torch.all(c0[:, -4:] == 0.0)
    assert torch.all(s_masked.weights[:, -4:] == 0.0)

    dp_far, d0_far = dp.copy(), d0.copy()
    d0_far[:, -4:] = 1e7
    dp_far[:, -4:, :] = 1e7
    dp_far[:, :, -4:] = 1e7
    _, _, s_removed = run(dp_far, d0_far, mask2)
    np.testing.assert_allclose(s_masked.weights.numpy(), s_removed.weights.numpy(), atol=1e-5)
    np.testing.assert_allclose(s_masked.variance.numpy(), s_removed.variance.numpy(), atol=1e-5)
