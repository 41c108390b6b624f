"""The port's batched PPCA imputation (``topotpu_torch.stats.ppca``) against
``topotpu.stats.ppca`` on the same seeded inputs, on the CPU.

Tolerances. The two packages run the same float32 EM with different BLAS
and eigensolvers, so their trajectories part by rounding only: on these
problems ``filled`` and ``recon`` agree within 1e-4 (values of a few units),
``mu`` within 2e-6 and ``sigma2`` within 2e-5 relative (measured; the port's
init is float64, the JAX package's float32). The tests hold them to 1e-3,
1e-5 and 1e-4 relative. ``W`` is compared after aligning
each column's sign (an eigensolver's choice; the EM is invariant to it),
within 1e-3. Iteration counts may differ by one where a relative change sits
at ``tol``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from topotpu.stats import ppca as jppca
from topotpu_torch.stats import ppca as tppca

torch.set_num_threads(1)


def _problem(B, T, V, q, seed, miss=0.25, noise=0.3):
    """Rank-q series with noise and per-variable offsets, entries missing at
    random: (Y with missing = 0, mask) as float32 / bool numpy."""
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((B, T, q))
    w = rng.standard_normal((B, V, q))
    Y = (np.einsum("btq,bvq->btv", z, w) + noise * rng.standard_normal((B, T, V))
         + 3.0 * rng.standard_normal((B, 1, V))).astype(np.float32)
    mask = rng.uniform(size=Y.shape) > miss
    return np.where(mask, Y, 0.0).astype(np.float32), mask


def _both(Y, mask, q, **kw):
    want = jppca.ppca_impute(jnp.asarray(Y), jnp.asarray(mask), q, **kw)
    got = tppca.ppca_impute(torch.from_numpy(Y), torch.from_numpy(mask), q, **kw)
    return got, want


def _assert_close(got, want):
    for f, atol, rtol in (("filled", 1e-3, 0), ("recon", 1e-3, 0), ("mu", 1e-5, 0),
                          ("sigma2", 0, 1e-4)):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   rtol=rtol, atol=atol, err_msg=f)
    Wg, Ww = got.W.numpy(), np.asarray(want.W)
    sign = np.sign(np.einsum("bvq,bvq->bq", Wg, Ww))[:, None, :]
    np.testing.assert_allclose(Wg * sign, Ww, atol=1e-3, err_msg="W up to column sign")
    d_it = np.abs(got.n_iters.numpy().astype(int) - np.asarray(want.n_iters))
    assert d_it.max() <= 1, (got.n_iters, want.n_iters)
    same = d_it == 0
    np.testing.assert_array_equal(got.converged.numpy()[same], np.asarray(want.converged)[same])


@pytest.mark.parametrize("B,T,V,q,max_iters", [
    (3, 200, 8, 2, 200),
    (2, 300, 10, 9, 200),    # q = V - 1
    (4, 500, 13, 4, 200),
    (2, 365, 25, 12, 200),   # config #3's V and q
    (3, 240, 8, 3, 13),      # a cap that is no multiple of the stop-test interval
])
def test_ppca_impute_matches_jax(B, T, V, q, max_iters):
    Y, mask = _problem(B, T, V, q, seed=B * T + V)
    got, want = _both(Y, mask, q, max_iters=max_iters, tol=1e-5)
    _assert_close(got, want)
    assert got.n_iters.dtype == torch.int32
    assert int(got.n_iters.max()) <= max_iters
    np.testing.assert_array_equal(got.filled.numpy()[mask], Y[mask])


def test_ppca_exact_on_lowrank_noiseless(rng):
    """``tests/test_ppca_infill.py``'s case on the port: a rank-2 noiseless
    matrix with holes is reconstructed nearly exactly, as in the JAX package."""
    B, T, V, q = 2, 300, 10, 2
    U = rng.normal(size=(B, T, q))
    Wt = rng.normal(size=(B, q, V))
    Y = (U @ Wt).astype(np.float32)
    mask = rng.uniform(size=Y.shape) > 0.25
    Y0 = np.where(mask, Y, 0.0).astype(np.float32)
    got, want = _both(Y0, mask, q, max_iters=2000, tol=1e-7)
    err = np.abs(got.filled.numpy() - Y)[~mask]
    scale = np.abs(Y).mean()
    assert err.mean() < 0.03 * scale, f"mean err {err.mean():.4f} (scale {scale:.2f})"
    assert err.max() < 0.5 * scale, f"max err {err.max():.4f}"
    assert float(got.sigma2.max()) < 0.01
    np.testing.assert_allclose(got.filled.numpy(), np.asarray(want.filled), atol=1e-3)


def test_ppca_per_target_convergence():
    """``tests/test_ppca_infill.py``'s case on the port: a planted hard target
    runs to the cap and reports not converged, without changing the easy
    targets' iteration counts or results; the counts are the JAX package's."""
    rng = np.random.default_rng(3)
    B, T, V, q = 2, 400, 10, 2
    z = rng.standard_normal((B, T, q)).astype(np.float32)
    w = rng.standard_normal((B, V, q)).astype(np.float32)
    Y = np.einsum("btq,bvq->btv", z, w) + 0.1 * rng.standard_normal((B, T, V)).astype(
        np.float32)
    mask = rng.uniform(size=(B, T, V)) > 0.2
    Yh = 5.0 * rng.standard_normal((1, T, V)).astype(np.float32)
    mh = rng.uniform(size=(1, T, V)) > 0.6
    kw = dict(max_iters=60, tol=1e-4)

    easy = tppca.ppca_impute(torch.from_numpy(Y), torch.from_numpy(mask), q, **kw)
    Yb, mb = np.concatenate([Y, Yh]), np.concatenate([mask, mh])
    both, want = _both(Yb, mb, q, **kw)
    assert both.converged[:B].all() and not both.converged[B]
    assert int(both.n_iters[B]) == kw["max_iters"]
    np.testing.assert_array_equal(both.n_iters[:B].numpy(), easy.n_iters.numpy())
    assert (easy.n_iters < kw["max_iters"]).all()
    np.testing.assert_allclose(both.filled[:B].numpy(), easy.filled.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(both.n_iters.numpy(), np.asarray(want.n_iters))
    np.testing.assert_array_equal(both.converged.numpy(), np.asarray(want.converged))


def test_init_is_float64_accurate():
    """The EM's init on float32 series with a seasonal cycle, config #3's
    V = 25 and q = 12: the eigenvalue at the q boundary is ~1e-3 of the
    largest, so a float32 covariance and eigensolver move the top-q subspace;
    the port computes both in float64. W0 W0^T and sigma0^2 within 1e-6 of
    a float64 numpy run, relative to the largest entry (float32 storage)."""
    rng = np.random.default_rng(5)
    B, T, V, q = 3, 3650, 25, 12
    phase = rng.uniform(0, 0.05, (B, 1, V))
    season = 12.0 * np.cos(2 * np.pi * (np.arange(T)[None, :, None] / 365.25 + phase))
    modes = np.einsum("btk,bvk->btv", rng.standard_normal((B, T, 8)),
                      rng.uniform(0.2, 1.5, (B, V, 8)))
    Y = (season + modes + 0.3 * rng.standard_normal((B, T, V))).astype(np.float32)
    mask = rng.uniform(size=Y.shape) > 0.35
    Yt, mt = torch.from_numpy(Y), torch.from_numpy(mask)
    mu = tppca._masked_mean(Yt, mt)
    Yc = torch.where(mt, Yt - mu[:, None, :], 0.0)
    W0, sig0 = tppca._init(Yc, mt.float(), q)
    assert W0.dtype == sig0.dtype == torch.float32

    x, m = Yc.numpy().astype(np.float64), mask.astype(np.float64)
    cov = np.einsum("btv,btw->bvw", x, x) / np.maximum(np.einsum("btv,btw->bvw", m, m), 1.0)
    ev, U = np.linalg.eigh(cov)
    assert (ev[:, -q] / ev[:, -1]).max() < 1e-2  # the ill-conditioned case
    want = np.einsum("bvq,bq,bwq->bvw", U[..., -q:], ev[:, -q:], U[..., -q:])
    got = np.einsum("bvq,bwq->bvw", W0.double().numpy(), W0.double().numpy())
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())
    np.testing.assert_allclose(sig0.numpy(), np.maximum(ev[:, :-q].mean(axis=1), 1e-6), rtol=1e-6)


def test_ppca_rejects_q_not_below_v():
    Y, mask = _problem(1, 50, 4, 2, seed=0)
    with pytest.raises(ValueError, match="n_components"):
        tppca.ppca_impute(torch.from_numpy(Y), torch.from_numpy(mask), 4)


def test_variance_adjust_matches_jax(rng):
    """Imputed entries shrunk toward the mean are rescaled per month to the
    observed variance, as in the JAX package (to float32 rounding, 1e-5)."""
    B, T = 5, 730
    month_idx = (np.arange(T) // 31 % 12).astype(np.int32)
    filled = rng.normal(size=(B, T)).astype(np.float32)
    obs = rng.uniform(size=(B, T)) > 0.3
    obs[3] = True                 # nothing imputed: unchanged
    obs[4, : T - 5] = False       # almost nothing observed: unchanged
    filled = np.where(obs, filled, 0.3 * filled).astype(np.float32)
    want = np.asarray(jppca.variance_adjust(jnp.asarray(filled), jnp.asarray(obs),
                                            jnp.asarray(month_idx)))
    got = tppca.variance_adjust(torch.from_numpy(filled), torch.from_numpy(obs),
                                torch.from_numpy(month_idx)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got[obs], filled[obs])
    np.testing.assert_array_equal(got[3], filled[3])
    np.testing.assert_allclose(got[4], filled[4], rtol=0, atol=1e-6)  # ratio 1
    imp = ~obs[:3]
    assert got[:3][imp].std() > 2.0 * filled[:3][imp].std()
