"""Synthetic binned variograms and the fit bar, shared by the CPU tests of
the variogram fit (``tests/test_torch_variogram.py``) and the card tests of
its kernel (``tests/test_torch_cuda_kernels.py``). Imports nothing of the JAX
package; fits are numpy arrays or torch tensors on any device."""

import numpy as np


def _np(a):
    return a.cpu().numpy() if hasattr(a, "cpu") else np.asarray(a)


def synthetic_emp(seed, B, n_bins=15, noise=0.0):
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


def wsse(gamma, h, npairs, nug, ps, rg):
    """Weighted SSE of the fit objective, float64 (``tests/test_variogram.py``)."""
    ok = npairs > 0
    w = np.where(ok, npairs / np.maximum(h, 1e-3) ** 2, 0.0)
    w = w / w.sum(-1, keepdims=True)
    model = nug[:, None] + ps[:, None] * (1 - np.exp(-h / rg[:, None]))
    return np.sum(np.where(ok, w * (gamma - model) ** 2, 0.0), -1)


def _params64(fit):
    return [_np(a).astype(np.float64) for a in (fit.nugget, fit.psill, fit.rng)]


def _curve(p, h):
    return p[0][:, None] + p[1][:, None] * (1 - np.exp(-h / p[2][:, None]))


def fits_apart(got, want, gamma, h, npairs):
    """Per fit, whether the two fits miss ``assert_fits_agree``'s bar: their
    curves at the bin distances more than 1e-3 of ``want``'s sill (+1e-6)
    apart, or their weighted SSEs more than 1 % (+1e-9) apart. Float64
    arrays ``gamma``, ``h``, ``npairs``."""
    g64, w64 = _params64(got), _params64(want)
    sill = w64[0] + w64[1]
    gap = np.abs(_curve(g64, h) - _curve(w64, h)).max(1)
    with np.errstate(invalid="ignore"):  # a fit with every bin empty has no weights
        sg, sw = wsse(gamma, h, npairs, *g64), wsse(gamma, h, npairs, *w64)
    return (gap >= 1e-3 * sill + 1e-6) | (sg > 1.01 * sw + 1e-9) | (sw > 1.01 * sg + 1e-9)


def assert_fits_agree(got, want, gamma, h, npairs):
    """Every ok fit within the bar of ``fits_apart``, ok flags identical,
    each fit's own SSE within 1 % and the parameters within 5 % (+0.02)."""
    ok = _np(want.ok)
    np.testing.assert_array_equal(_np(got.ok), ok)
    g64, w64 = _params64(got), _params64(want)
    sill = w64[0] + w64[1]
    np.testing.assert_array_less(np.abs(_curve(g64, h) - _curve(w64, h))[ok].max(1),
                                 1e-3 * sill[ok] + 1e-6)
    sg, sw = wsse(gamma, h, npairs, *g64), wsse(gamma, h, npairs, *w64)
    assert np.all(sg[ok] <= 1.01 * sw[ok] + 1e-9) and np.all(sw[ok] <= 1.01 * sg[ok] + 1e-9)
    np.testing.assert_allclose(_np(got.sse)[ok], _np(want.sse)[ok], rtol=1e-2, atol=1e-9)
    for a, b in zip(g64, w64):
        np.testing.assert_allclose(a[ok], b[ok], rtol=0.05, atol=0.02)
