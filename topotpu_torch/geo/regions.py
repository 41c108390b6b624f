"""Climate-region rasters for neighborhood-size optimization (the port's own
copy of the JAX package's ``geo/regions.py``).

Parity target: the reference optimized its ``nnghs`` tables per US climate
division (SURVEY §2.16, ``mpi_optim_nstns_*``); the division polygons are
external data it rasterized onto the 30-arcsec grid. No such shapefiles
ship in this environment, so this module builds climate-division-LIKE
regions directly from the covariate rasters the run already has: k-means
over standardized (lat, lon·cos(lat), elevation, seasonal LST mean and
range). The geographic features dominate scale-wise, so clusters come out
as spatially coherent blobs with elevation/LST splits inside mountain
terrain — the same role climate divisions play for the optimizer: groups
of cells with similar station-density and climate-texture needs.

A real deployment with actual division polygons uses the ``--regions``
raster path instead (``step_optim_nnghs``); this builder is the principled
default that replaces the coarse 5-degree latitude bands.
"""

from __future__ import annotations

import numpy as np

from topotpu_torch.io.rasters import RasterStack


def make_climate_regions(
    rasters: RasterStack,
    n_regions: int = 12,
    iters: int = 25,
    seed: int = 0,
) -> np.ndarray:
    """(R, C) int32 region raster: labels 0..n_regions-1 on land, -1 on
    ocean. Deterministic (fixed seed, k-means++ style farthest-point
    init on a subsample, Lloyd iterations over all land cells)."""
    land = rasters.landmask
    n_land = int(land.sum())
    if n_land == 0:
        return np.full(rasters.grid.shape, -1, np.int32)
    n_regions = max(1, min(n_regions, n_land))

    rows, cols = np.nonzero(land)
    lon, lat = rasters.grid.cell_lonlat(rows, cols)
    lst_mean = rasters.lst.mean(axis=0)[land]
    lst_rng = rasters.lst.max(axis=0)[land] - rasters.lst.min(axis=0)[land]
    feats = np.stack(
        [
            lat,
            lon * np.cos(np.deg2rad(lat)),  # metric-ish east offsets
            rasters.elev[land],
            lst_mean,
            lst_rng,
        ],
        axis=1,
    ).astype(np.float64)
    mu = feats.mean(axis=0)
    sd = feats.std(axis=0)
    sd[sd == 0] = 1.0
    z = (feats - mu) / sd
    # geography leads (division-like contiguity), physiography refines
    z *= np.array([2.0, 2.0, 1.0, 1.0, 0.5])

    rng = np.random.default_rng(seed)
    sub = z[rng.choice(n_land, size=min(n_land, 50_000), replace=False)]
    # centroids come from the subsample: more regions than subsample
    # points would duplicate centroids (farthest-point init runs dry)
    n_regions = min(n_regions, len(sub))
    # farthest-point init with a running min-distance (one pass per seed,
    # O(n_regions * |sub| * F) total): spread seeds across the domain
    cent = np.empty((n_regions, z.shape[1]))
    cent[0] = sub[int(rng.integers(len(sub)))]
    mind = ((sub - cent[0]) ** 2).sum(1)
    for j in range(1, n_regions):
        cent[j] = sub[int(np.argmax(mind))]
        np.minimum(mind, ((sub - cent[j]) ** 2).sum(1), out=mind)

    def _assign(pts, c):
        # (chunk, k) squared distances via the expansion trick; chunked by
        # a fixed ELEMENT budget (~128 MB of f64) so memory stays bounded
        # for any point count x n_regions combination
        step = max(1, (1 << 24) // len(c))
        out = np.empty(len(pts), np.int64)
        c2 = (c**2).sum(1)[None]
        for i0 in range(0, len(pts), step):
            blk = pts[i0 : i0 + step]
            d2 = (blk**2).sum(1)[:, None] - 2.0 * blk @ c.T + c2
            out[i0 : i0 + step] = np.argmin(d2, axis=1)
        return out

    # Lloyd iterations on the subsample only (50k points regardless of
    # grid size), then ONE chunked assignment of every land cell — keeps
    # the 4096^2 default path seconds-fast and memory-bounded
    for _ in range(iters):
        lab = _assign(sub, cent)
        sums = np.zeros_like(cent)
        np.add.at(sums, lab, sub)
        counts = np.bincount(lab, minlength=n_regions).astype(np.float64)
        new = np.where(
            counts[:, None] > 0, sums / np.maximum(counts, 1)[:, None], cent
        )
        if np.allclose(new, cent):
            cent = new
            break
        cent = new
    lab = _assign(z, cent)

    # compact labels (drop empty clusters) so downstream tables are dense
    uniq, lab = np.unique(lab, return_inverse=True)
    out = np.full(rasters.grid.shape, -1, np.int32)
    out[rows, cols] = lab.astype(np.int32)
    return out
