"""The production tile engine on one GPU (the port of ``topotpu.dist``)."""

from topotpu_torch.dist.engine import StationSet, TileEngine, TileTask  # noqa: F401
