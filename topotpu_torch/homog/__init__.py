"""Pairwise homogenisation: the C++ SNHT and break-model core and the
network logic around it."""

from topotpu_torch.homog.pha import (  # noqa: F401
    HomogResult,
    homogenize_elements,
    homogenize_network,
    parse_station_history,
)
