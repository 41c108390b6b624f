"""The port's distances and neighbourhood selection against the JAX package.

``torch.topk`` and ``lax.top_k`` break ties differently, so neighbourhoods
are compared as sets over the masked slots, not by raw ``idx``.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from topotpu.geo import distance as jdist
from topotpu.geo import neighbors as jnbr
from topotpu.oracle.numpy_ref import haversine_km
from topotpu_torch.geo import distance as tdist
from topotpu_torch.geo import neighbors as tnbr

torch.set_num_threads(1)


def _points(seed, n, lon=(-106.0, -104.0), lat=(39.0, 41.0)):
    rng = np.random.default_rng(seed)
    return (rng.uniform(*lon, n).astype(np.float32),
            rng.uniform(*lat, n).astype(np.float32))


def test_distances_match_jax():
    alon, alat = _points(0, 50)
    blon, blat = _points(1, 70)
    T = torch.from_numpy
    np.testing.assert_allclose(
        tdist.pairwise_great_circle_km(T(alon), T(alat), T(blon), T(blat)).numpy(),
        np.asarray(jdist.pairwise_great_circle_km(alon, alat, blon, blat)),
        rtol=1e-5, atol=5e-3,
    )
    np.testing.assert_allclose(
        tdist.great_circle_km(T(alon), T(alat), T(blon[:50]), T(blat[:50])).numpy(),
        np.asarray(jdist.great_circle_km(alon, alat, blon[:50], blat[:50])),
        rtol=1e-5, atol=5e-3,
    )
    xyz = tdist.unit_xyz(T(blon), T(blat))
    np.testing.assert_allclose(xyz.numpy(), np.asarray(jdist.unit_xyz(blon, blat)),
                               atol=1e-6)
    np.testing.assert_allclose(
        tdist.pairwise_km_from_xyz(xyz[None, :10], xyz[None, :10]).numpy(),
        np.asarray(jdist.pairwise_km_from_xyz(jdist.unit_xyz(blon, blat)[None, :10],
                                              jdist.unit_xyz(blon, blat)[None, :10])),
        rtol=1e-5, atol=5e-3,
    )


def test_pair_distance_keeps_metre_accuracy():
    """The chord-difference form stays within a few metres of float64
    haversine in float32, down to metre separations."""
    lon = np.array([-105.0, -105.0, -105.00002, -104.9], np.float32)
    lat = np.array([40.0, 40.00001, 40.0, 40.3], np.float32)
    d = tdist.pairwise_great_circle_km(*map(torch.from_numpy, (lon, lat, lon, lat)))
    want = haversine_km(lon[:, None].astype(np.float64), lat[:, None].astype(np.float64),
                        lon[None].astype(np.float64), lat[None].astype(np.float64))
    assert np.all(np.diag(d.numpy()) == 0.0)
    np.testing.assert_allclose(d.numpy(), want, atol=3e-3)


def _assert_same_sets(got, want, tie_km):
    """Same masked slots, same sorted distances, and the same station sets
    apart from near-ties (within ``tie_km``) at the k-th distance: float32
    cosine scores only order stations to ~0.1 km at these separations."""
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    gi, wi = got.idx.numpy(), np.asarray(want.idx)
    gd, wd = got.dist.numpy(), np.asarray(want.dist)
    m = np.asarray(want.mask)
    for c in range(gi.shape[0]):
        edge = wd[c][m[c]].max(initial=0.0) - tie_km
        assert (set(gi[c][m[c] & (gd[c] < edge)])
                == set(wi[c][m[c] & (wd[c] < edge)]))
    np.testing.assert_allclose(np.sort(gd, 1), np.sort(wd, 1), rtol=1e-5, atol=tie_km)


@pytest.mark.parametrize("branch", ["cos", "exact", "exact_self_km", "exclude_idx_cos",
                                    "exclude_idx_exact", "pool_smaller_than_k"])
def test_select_neighbors_matches_jax(branch):
    clon, clat = _points(2, 40)
    slon, slat = _points(3, 60)
    valid = np.ones(60, bool)
    valid[[4, 9, 33]] = False
    k = 12
    kw = {}
    if branch == "pool_smaller_than_k":
        slon, slat, valid, k = slon[:8], slat[:8], valid[:8], 12
    if branch.startswith("exclude_idx"):
        # the queries are pool members: leave each one out by index
        clon, clat = slon[:40], slat[:40]
        kw["exclude_idx"] = np.arange(40)
    if branch == "exact_self_km":
        clon, clat = slon[:40], slat[:40]
        kw["exclude_self_km"] = 0.01
    dm = branch in ("exact", "exclude_idx_exact")
    T = torch.from_numpy
    want = jnbr.select_neighbors(
        jnp.asarray(clon), jnp.asarray(clat), jnp.asarray(slon), jnp.asarray(slat),
        jnp.asarray(valid), k=k,
        dist_matrix=jdist.pairwise_great_circle_km(clon, clat, slon, slat) if dm else None,
        **{n: jnp.asarray(v) if n == "exclude_idx" else v for n, v in kw.items()},
    )
    got = tnbr.select_neighbors(
        T(clon), T(clat), T(slon), T(slat), T(valid), k=k,
        dist_matrix=tdist.pairwise_great_circle_km(T(clon), T(clat), T(slon), T(slat))
        if dm else None,
        **{n: T(v) if n == "exclude_idx" else v for n, v in kw.items()},
    )
    _assert_same_sets(got, want, 1e-2 if dm or "self" in branch else 0.2)
    if branch.startswith("exclude_idx"):
        assert not np.any((got.idx.numpy() == np.arange(40)[:, None]) & got.mask.numpy())
    if branch == "pool_smaller_than_k":
        assert got.mask.numpy().sum(1).max() == 7  # station 4 invalid


@pytest.mark.parametrize("kernel", ["bisquare", "gaussian", "uniform"])
def test_distance_weights_match_jax(kernel):
    rng = np.random.default_rng(4)
    d = rng.uniform(0, 80, (30, 16)).astype(np.float32)
    m = rng.uniform(size=(30, 16)) > 0.2
    got = tnbr.distance_weights(torch.from_numpy(d), torch.from_numpy(m), kernel)
    want = jnbr.distance_weights(jnp.asarray(d), jnp.asarray(m), kernel)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    assert np.all(got.numpy()[~m] == 0.0)
