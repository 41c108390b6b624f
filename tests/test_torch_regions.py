"""The port's climate regions (``topotpu_torch.geo.regions``) against the
JAX package's on ``tests/test_regions.py``'s rasters, degenerate inputs
included. Both run the same numpy k-means, so labels are compared with
``array_equal``."""

import numpy as np
import pytest

from topotpu.geo.regions import make_climate_regions as j_regions
from topotpu.io.rasters import RasterStack as JRasterStack
from topotpu.io.synthetic import make_world as j_make_world
from topotpu_torch.geo import make_climate_regions as t_regions
from topotpu_torch.io.rasters import RasterStack as TRasterStack
from topotpu_torch.io.synthetic import make_world as t_make_world


def _rasters(seed=7, n=64):
    kw = dict(nrows=n, ncols=n, n_stations=30, ndays=31)
    return (JRasterStack.from_world(j_make_world(np.random.default_rng(seed), **kw)),
            TRasterStack.from_world(t_make_world(np.random.default_rng(seed), **kw)))


def _degenerate(jr, tr, kind):
    if kind == "all_ocean":
        jr.landmask[:] = False
        tr.landmask[:] = False
    elif kind == "one_cell":
        jr.landmask[:] = False
        tr.landmask[:] = False
        jr.landmask[5, 7] = tr.landmask[5, 7] = True
    elif kind == "flat":  # constant covariates: zero spread in three features
        for r in (jr, tr):
            r.elev[:] = 1000.0
            r.lst[:] = 10.0


@pytest.mark.parametrize("seed,n", [(7, 64), (3, 48)])
@pytest.mark.parametrize("n_regions,rseed", [(8, 0), (6, 3), (12, 0), (10_000, 0), (1, 0)])
def test_regions_match_jax(seed, n, n_regions, rseed):
    jr, tr = _rasters(seed, n)
    want = j_regions(jr, n_regions=n_regions, seed=rseed)
    got = t_regions(tr, n_regions=n_regions, seed=rseed)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["all_ocean", "one_cell", "flat"])
def test_regions_degenerate_inputs_match_jax(kind):
    jr, tr = _rasters()
    _degenerate(jr, tr, kind)
    want = j_regions(jr, n_regions=4)
    got = t_regions(tr, n_regions=4)
    np.testing.assert_array_equal(got, want)
    assert (got[~tr.landmask] == -1).all()
