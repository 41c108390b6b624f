"""The roofline counts against hand counts at one shape."""

import tiny  # noqa: F401  (paths)

from benchlib import catalog, peaks


def test_krig_normals_counts():
    c = catalog.load_module("counts", "krig_normals")
    k = 4
    # one system: covariance 2 k^2, Cholesky k^3 / 3, two solves 4 k^2, OK 10 k
    assert c.solve_flops(k, xyz=False) == 32 + 64 / 3 + 64 + 40
    # a neighbourhood: weights 10 k, pair distances 6 k^2, 2 fixed columns 16 k,
    # gains: 3 columns 24 k + (4 x 5 / 2 + 4) x 3 k + 200
    per_nbr = 40 + 96 + 64 + 96 + 14 * 12 + 200
    # a system: 1 column 8 k, normal equations (10 + 4) x 3 k, 200, residuals 10 k,
    # variogram 6 k, the solve
    per_sys = 32 + 14 * 12 + 200 + 40 + 24 + c.solve_flops(k, xyz=False)
    assert c.flops(C=10, k=k, S=7, V=2, P=24, N=1) == 10 * (per_nbr + 24 * per_sys)
    # idx 8 + dist 4 + mask 1 a slot; tables (7 x (19 + 96) + 10 x 16) x 4; heads and gains
    assert c.nbytes(C=10, k=k, S=7, V=2, P=24, N=1) == (
        40 * 13 + (7 * 115 + 160) * 4 + (24 * 10 * 8 + 40) * 4)


def test_scatter_daily_packed_counts():
    c = catalog.load_module("counts", "scatter_daily_packed")
    assert c.flops(C=10, k=4, S=7, V=2, ndays=365) == 2 * 4 * 10 * 2 * 365
    assert c.nbytes(C=10, k=4, S=7, V=2, ndays=365, dpm=31) == (
        40 * 9 + 40 * 4 + 2 * 7 * 372 * 4 + 2 * 12 * 10 * 5 + 365 * 4 + 16 + 2 * 365 * 10 * 2)


def test_bound_takes_the_longer():
    assert peaks.bound_s(3.35e12, 0.0) == 1.0
    assert peaks.bound_s(0.0, 67e12) == 1.0
    assert peaks.bound_s(3.35e12, 2 * 67e12) == 2.0
