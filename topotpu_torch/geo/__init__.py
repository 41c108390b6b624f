from topotpu_torch.geo.distance import (  # noqa: F401
    EARTH_RADIUS_KM,
    great_circle_km,
    pairwise_great_circle_km,
    pairwise_km_from_xyz,
    unit_xyz,
)
from topotpu_torch.geo.neighbors import (  # noqa: F401
    Neighborhood,
    distance_weights,
    select_neighbors,
)
from topotpu_torch.geo.regions import make_climate_regions  # noqa: F401
