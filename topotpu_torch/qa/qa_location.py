"""Station location QA (the port's own copy of the JAX package's
``qa/qa_location.py``, on the port's ``RasterStack``).

Parity target: ``twx/qa/qa_location.py`` (SURVEY.md §2.6) — validate a
station's reported elevation against the DEM at its coordinates (the
reference also queried geonames; no network exists here, so the DEM check is
the implemented path and the geonames hook is an injectable callback).
"""

from __future__ import annotations

import numpy as np

from topotpu_torch.io.rasters import RasterStack


def dem_elevation_at(rasters: RasterStack, lon: np.ndarray, lat: np.ndarray) -> np.ndarray:
    """Nearest-cell DEM elevation at station coordinates (NaN off-grid)."""
    g = rasters.grid
    col = np.round((lon - g.lon0) / g.cellsize).astype(int)
    row = np.round((g.lat0 - lat) / g.cellsize).astype(int)
    ok = (row >= 0) & (row < g.nrows) & (col >= 0) & (col < g.ncols)
    out = np.full(len(lon), np.nan)
    out[ok] = rasters.elev[row[ok], col[ok]]
    return out


def check_elevation(
    rasters: RasterStack,
    lon: np.ndarray,
    lat: np.ndarray,
    elev: np.ndarray,
    max_diff_m: float = 200.0,
    lookup=None,
) -> tuple[np.ndarray, np.ndarray]:
    """Flag stations whose reported elevation disagrees with the DEM.

    Returns (bad, dem_elev). ``lookup`` optionally overrides the DEM source
    (the reference's geonames web lookup slot).
    """
    dem = lookup(lon, lat) if lookup is not None else dem_elevation_at(rasters, lon, lat)
    with np.errstate(invalid="ignore"):
        bad = np.abs(dem - elev) > max_diff_m
    return np.nan_to_num(bad.astype(float)).astype(bool), dem


# The coordinate-corruption modes the reference's geonames lookup caught in
# practice: lon/lat transposed, and dropped/flipped signs (western-hemisphere
# longitudes entered positive, etc.). Each probe maps reported -> candidate
# true coordinates.
COORD_PROBES = (
    ("lonlat_swapped", lambda lon, lat: (lat, lon)),
    ("lon_sign", lambda lon, lat: (-lon, lat)),
    ("lat_sign", lambda lon, lat: (lon, -lat)),
    ("both_signs", lambda lon, lat: (-lon, -lat)),
    ("swapped_lon_sign", lambda lon, lat: (-lat, lon)),
    ("swapped_lat_sign", lambda lon, lat: (lat, -lon)),
)


def check_coordinates(
    rasters: RasterStack,
    lon: np.ndarray,
    lat: np.ndarray,
    elev: np.ndarray,
    max_diff_m: float = 200.0,
) -> dict:
    """Offline coordinate-sanity check (the geonames replacement,
    ``twx/qa/qa_location.py`` SURVEY §2.6): a station whose reported
    elevation disagrees with the DEM at its reported coordinates — or whose
    coordinates fall off the grid entirely — is probed against the standard
    corruption modes (transposed lon/lat, sign flips). A probe whose DEM
    elevation matches the reported station elevation identifies both the
    defect and the repair; the reported elevation acts as the independent
    witness the web lookup used to provide.

    Returns {"suspect": (S,) bool, "probe": (S,) object (name or None),
    "fix_lon": (S,), "fix_lat": (S,)} — fix_* are NaN where no probe
    resolved the mismatch.
    """
    dem = dem_elevation_at(rasters, lon, lat)
    with np.errstate(invalid="ignore"):
        agree = np.abs(dem - elev) <= max_diff_m
    suspect = ~np.nan_to_num(agree.astype(float)).astype(bool)

    S = len(lon)
    probe_name = np.full(S, None, object)
    fix_lon = np.full(S, np.nan)
    fix_lat = np.full(S, np.nan)
    unresolved = suspect.copy()
    for name, fn in COORD_PROBES:
        if not unresolved.any():
            break
        plon, plat = fn(np.asarray(lon, float), np.asarray(lat, float))
        pdem = dem_elevation_at(rasters, plon, plat)
        with np.errstate(invalid="ignore"):
            hit = unresolved & (np.abs(pdem - elev) <= max_diff_m)
        hit = np.nan_to_num(hit.astype(float)).astype(bool)
        probe_name[hit] = name
        fix_lon[hit] = plon[hit]
        fix_lat[hit] = plat[hit]
        unresolved &= ~hit
    return {
        "suspect": suspect,
        "probe": probe_name,
        "fix_lon": fix_lon,
        "fix_lat": fix_lat,
    }


def fix_elevation(elev: np.ndarray, bad: np.ndarray, dem: np.ndarray) -> np.ndarray:
    """Replace flagged elevations with the DEM value (the reference's
    resolution for disagreeing stations)."""
    out = np.array(elev, copy=True)
    use = bad & np.isfinite(dem)
    out[use] = dem[use]
    return out
