"""Great-circle distances on torch tensors (port of ``topotpu.geo.distance``).

All inputs in degrees; outputs in kilometres. Pair distances use the
chord-difference form ``d = 2 R asin(||p_a - p_b|| / 2)`` on the unit-sphere
embedding: the coordinate difference is taken directly, never through the
``1 - cos`` dot product, so nearby points keep metre-scale accuracy in f32.
"""

from __future__ import annotations

import torch

EARTH_RADIUS_KM = 6371.0087714  # IUGG mean earth radius


def great_circle_km(lon1, lat1, lon2, lat2):
    """Elementwise haversine distance in km; broadcasts like torch ops."""
    lon1, lat1, lon2, lat2 = (torch.deg2rad(x) for x in (lon1, lat1, lon2, lat2))
    dlon = lon2 - lon1
    dlat = lat2 - lat1
    a = (
        torch.sin(dlat / 2.0) ** 2
        + torch.cos(lat1) * torch.cos(lat2) * torch.sin(dlon / 2.0) ** 2
    )
    a = torch.clamp(a, 0.0, 1.0)
    return 2.0 * EARTH_RADIUS_KM * torch.arcsin(torch.sqrt(a))


def unit_xyz(lon, lat):
    """Unit-sphere embedding (..., 3) of lon/lat degrees."""
    lon = torch.deg2rad(lon)
    lat = torch.deg2rad(lat)
    cl = torch.cos(lat)
    return torch.stack(
        [cl * torch.cos(lon), cl * torch.sin(lon), torch.sin(lat)], dim=-1
    )


def pairwise_km_from_xyz(xyz_a, xyz_b):
    """(..., A, 3) x (..., B, 3) -> (..., A, B) great-circle km."""
    d2 = None
    for i in range(3):
        diff = xyz_a[..., :, None, i] - xyz_b[..., None, :, i]
        d2 = diff * diff if d2 is None else d2 + diff * diff
    half_chord = 0.5 * torch.sqrt(d2)
    return 2.0 * EARTH_RADIUS_KM * torch.arcsin(torch.clamp(half_chord, 0.0, 1.0))


def pairwise_great_circle_km(lon_a, lat_a, lon_b, lat_b):
    """(A,) x (B,) -> (A, B) distance matrix in km (chord-difference form)."""
    return pairwise_km_from_xyz(unit_xyz(lon_a, lat_a), unit_xyz(lon_b, lat_b))
