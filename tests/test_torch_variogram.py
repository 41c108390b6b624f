"""The port's variogram model, empirical estimator and Gauss-Newton fit
against ``topotpu.stats.variogram`` and the float64 loop/scipy oracles.

Tolerances. The model and the 3 x 3 solve agree to float32 rounding (rtol
1e-6). Empirical variograms: identical pair counts, gamma and mean distance
within rtol 1e-5 of the JAX package (sums taken in another order) and rtol
1e-4 of the float64 loop oracle (``tests/test_variogram.py``'s bar). The fit
is a damped Gauss-Newton loop with accept/reject steps, which amplifies
float32 differences in the parameters along the flat directions of the SSE
surface, so the two fits are held by what they fit: the fitted curves at the
bin distances agree within 1e-3 of the sill, and each weighted SSE is within
1 % (+1e-9) of the other's; parameters themselves only loosely.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from topotpu.oracle import numpy_ref as oracle
from topotpu.stats import variogram as jvario
from topotpu_torch.stats import variogram as tvario

torch.set_num_threads(1)
T = torch.from_numpy


def test_model_matches_jax():
    h = np.array([0.0, 0.5, 1.0, 10.0, 100.0, 1e4], np.float32)
    for args in ((0.1, 1.0, 30.0), (0.0, 2.5, 1e-9)):
        for name in ("exp_variogram", "exp_covariance"):
            got = getattr(tvario, name)(T(h), *args).numpy()
            want = np.asarray(getattr(jvario, name)(jnp.asarray(h), *args))
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7, err_msg=name)
    g = tvario.exp_variogram(T(h), 0.1, 1.0, 30.0).numpy()
    c = tvario.exp_covariance(T(h), 0.1, 1.0, 30.0).numpy()
    assert g[0] == 0.0 and c[0] == np.float32(1.1)
    np.testing.assert_allclose(g[1:] + c[1:], 1.1, rtol=1e-6)


def _neighbourhoods(seed, B, k, n_masked):
    rng = np.random.default_rng(seed)
    lon = rng.uniform(-104, -102, (B, k))
    lat = rng.uniform(39, 41, (B, k))
    dist = oracle.haversine_km(lon[..., :, None], lat[..., :, None],
                               lon[..., None, :], lat[..., None, :])
    vals = rng.normal(size=(B, k))
    mask = np.ones((B, k), bool)
    mask[:, k - n_masked:] = False
    mask[0, :] = False  # an element with no valid pair at all
    mask[1, :2] = True
    mask[1, 2:] = False  # one pair
    return dist.astype(np.float32), vals.astype(np.float32), mask


@pytest.mark.parametrize("n_bins, max_dist_frac", [(15, 1.0), (10, 0.6)])
def test_empirical_matches_jax_and_loop_oracle(n_bins, max_dist_frac):
    dist, vals, mask = _neighbourhoods(0, 12, 24, 5)
    got = tvario.empirical_variogram(T(dist), T(vals), T(mask), n_bins, max_dist_frac)
    want = jvario.empirical_variogram(jnp.asarray(dist), jnp.asarray(vals),
                                      jnp.asarray(mask), n_bins=n_bins,
                                      max_dist_frac=max_dist_frac)
    np.testing.assert_array_equal(got.npairs.numpy(), np.asarray(want.npairs))
    for f in ("gamma", "h", "cutoff"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   rtol=1e-5, atol=1e-6, err_msg=f)
    # no valid pair; one pair, which lies beyond a cutoff below its distance
    assert got.npairs.numpy()[0].sum() == 0
    assert got.npairs.numpy()[1].sum() == (1 if max_dist_frac >= 1.0 else 0)
    for b in range(2, 12):
        m = mask[b]
        cutoff = float(got.cutoff[b])
        wg, wh, wn = oracle.empirical_variogram_loops(
            dist[b][np.ix_(m, m)].astype(np.float64), vals[b][m].astype(np.float64),
            n_bins, cutoff)
        np.testing.assert_array_equal(got.npairs.numpy()[b], wn)
        np.testing.assert_allclose(got.gamma.numpy()[b], wg, rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(got.h.numpy()[b], wh, rtol=1e-4, atol=1e-6)


def _synthetic_emp(seed, B, n_bins=15, noise=0.0):
    """Exponential-model curves with multiplicative noise, as
    ``tests/test_variogram.py`` builds them, plus a few empty bins."""
    rng = np.random.default_rng(seed)
    nug = rng.uniform(0.0, 0.2, B)
    ps = rng.uniform(0.5, 3.0, B)
    rg = rng.uniform(30, 150, B)
    h = np.linspace(5, 300, n_bins)[None, :].repeat(B, 0)
    gamma = nug[:, None] + ps[:, None] * (1 - np.exp(-h / rg[:, None]))
    gamma = gamma * (1 + noise * rng.normal(size=gamma.shape))
    npairs = rng.integers(5, 80, (B, n_bins)).astype(np.float64)
    npairs[::3, 0] = 0.0
    npairs[1::4, -3:] = 0.0
    gamma = np.where(npairs > 0, gamma, 0.0)
    h = np.where(npairs > 0, h, 0.0)
    f32 = lambda a: a.astype(np.float32)  # noqa: E731
    return f32(gamma), f32(h), f32(npairs), np.full(B, 300.0, np.float32)


def _wsse(gamma, h, npairs, nug, ps, rg):
    """Weighted SSE of the fit objective, float64 (``tests/test_variogram.py``)."""
    ok = npairs > 0
    w = np.where(ok, npairs / np.maximum(h, 1e-3) ** 2, 0.0)
    w = w / w.sum(-1, keepdims=True)
    model = nug[:, None] + ps[:, None] * (1 - np.exp(-h / rg[:, None]))
    return np.sum(np.where(ok, w * (gamma - model) ** 2, 0.0), -1)


def _assert_fits_agree(got, want, gamma, h, npairs):
    ok = np.asarray(want.ok)
    np.testing.assert_array_equal(got.ok.numpy(), ok)
    g = [got.nugget.numpy(), got.psill.numpy(), got.rng.numpy()]
    w = [np.asarray(want.nugget), np.asarray(want.psill), np.asarray(want.rng)]
    g64 = [a.astype(np.float64) for a in g]
    w64 = [a.astype(np.float64) for a in w]
    sill = w64[0] + w64[1]
    curve = lambda p: p[0][:, None] + p[1][:, None] * (1 - np.exp(-h / p[2][:, None]))  # noqa: E731
    np.testing.assert_array_less(np.abs(curve(g64) - curve(w64))[ok].max(1),
                                 1e-3 * sill[ok] + 1e-6)
    sg, sw = _wsse(gamma, h, npairs, *g64), _wsse(gamma, h, npairs, *w64)
    assert np.all(sg[ok] <= 1.01 * sw[ok] + 1e-9) and np.all(sw[ok] <= 1.01 * sg[ok] + 1e-9)
    np.testing.assert_allclose(got.sse.numpy()[ok], np.asarray(want.sse)[ok],
                               rtol=1e-2, atol=1e-9)
    for a, b in zip(g, w):
        np.testing.assert_allclose(a[ok], b[ok], rtol=0.05, atol=0.02)


@pytest.mark.parametrize("noise", [0.0, 0.05, 0.3])
def test_fit_matches_jax(noise):
    gamma, h, npairs, cutoff = _synthetic_emp(1, 32, noise=noise)
    emp_t = tvario.EmpiricalVariogram(*(T(a) for a in (gamma, h, npairs, cutoff)))
    emp_j = jvario.EmpiricalVariogram(*(jnp.asarray(a) for a in (gamma, h, npairs, cutoff)))
    got = tvario.fit_exp_variogram(emp_t, n_iters=60)
    want = jvario.fit_exp_variogram(emp_j, n_iters=60)
    _assert_fits_agree(got, want, gamma.astype(np.float64), h.astype(np.float64),
                       npairs.astype(np.float64))


def test_fit_of_empirical_residual_variograms_matches_jax_and_scipy():
    """Fits of empirical variograms of correlated residual fields (what
    krig-params fits) agree with the JAX fit, and both meet
    ``tests/test_variogram.py``'s bar against scipy's least squares (wSSE
    within 10 %) on the same share of stations. That share is not 1: the
    Gauss-Newton step is clamped onto the box (nugget >= 0) after it is
    solved, so on fields whose best nugget is 0 it stalls short of the
    optimum that scipy's bounded trust-region method reaches (about one fit
    in six on these fields, in both packages). Hence the bar on at least
    70 % of the fits, and the same verdict from both packages on all but
    one."""
    B, k = 24, 48
    rng = np.random.default_rng(5)
    lon = rng.uniform(-104, -103, (B, k))
    lat = rng.uniform(39, 40, (B, k))
    dist = oracle.haversine_km(lon[..., :, None], lat[..., :, None],
                               lon[..., None, :], lat[..., None, :])
    cov = 0.8 * np.exp(-dist / 25.0) + 0.05 * np.eye(k)
    vals = np.einsum("bij,bj->bi", np.linalg.cholesky(cov), rng.normal(size=(B, k)))
    mask = np.ones((B, k), bool)
    mask[:, -4:] = False
    d32, v32 = dist.astype(np.float32), vals.astype(np.float32)
    emp = tvario.empirical_variogram(T(d32), T(v32), T(mask))
    jemp = jvario.empirical_variogram(jnp.asarray(d32), jnp.asarray(v32), jnp.asarray(mask))
    got = tvario.fit_exp_variogram(emp)
    want = jvario.fit_exp_variogram(jemp)
    gamma, h, npairs = (a.numpy().astype(np.float64) for a in emp[:3])
    _assert_fits_agree(got, want, gamma, h, npairs)
    assert got.ok.numpy().all()
    scipy_sse = np.array([
        _wsse(gamma[b : b + 1], h[b : b + 1], npairs[b : b + 1],
              *(np.array([v]) for v in oracle.fit_exp_scipy(gamma[b], h[b], npairs[b])))[0]
        for b in range(B)
    ])
    within = []
    for fit in (got, want):
        p = [np.asarray(a).astype(np.float64) for a in (fit.nugget, fit.psill, fit.rng)]
        within.append(_wsse(gamma, h, npairs, *p) <= scipy_sse * 1.1 + 1e-10)
    assert within[0].mean() >= 0.7 and within[1].mean() >= 0.7, [w.mean() for w in within]
    assert np.sum(within[0] != within[1]) <= 1


def test_fit_flags_insufficient_bins():
    z = torch.zeros((3, 15))
    npairs = torch.zeros((3, 15))
    npairs[1, :3] = 10.0   # three bins: fewer than min_bins = 4
    npairs[2, :4] = 10.0
    emp = tvario.EmpiricalVariogram(gamma=z + 0.5, h=z + 10.0, npairs=npairs,
                                    cutoff=torch.ones(3))
    fit = tvario.fit_exp_variogram(emp)
    np.testing.assert_array_equal(fit.ok.numpy(), [False, False, True])
    for f in fit[:4]:
        assert torch.isfinite(f).all()


def test_helpers_match_jax():
    rng = np.random.default_rng(6)
    A = rng.normal(size=(20, 3, 3)).astype(np.float32)
    A = A @ A.transpose(0, 2, 1) + 0.5 * np.eye(3, dtype=np.float32)
    A[3] = 0.0  # singular: the determinant guard
    b = rng.normal(size=(20, 3)).astype(np.float32)
    np.testing.assert_allclose(tvario._solve3(T(A), T(b)).numpy(),
                               np.asarray(jvario._solve3(jnp.asarray(A), jnp.asarray(b))),
                               rtol=1e-5, atol=1e-6)
    x = rng.normal(size=(6, 15)).astype(np.float32)
    ok = rng.uniform(size=(6, 15)) > 0.5
    ok[0] = False
    ok[1, 7:] = False
    for name in ("_first_valid", "_tail_mean"):
        np.testing.assert_allclose(getattr(tvario, name)(T(x), T(ok)).numpy(),
                                   np.asarray(getattr(jvario, name)(jnp.asarray(x),
                                                                    jnp.asarray(ok))),
                                   rtol=1e-6, atol=1e-7, err_msg=name)
