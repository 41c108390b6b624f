"""The device mesh and the cell-sharded tile step, the production engine, and
jobs over several processes (the port of ``topotpu.dist``)."""

from topotpu_torch.dist.mesh import make_mesh, sharded_interp_tile  # noqa: F401
from topotpu_torch.dist.engine import StationSet, TileEngine, TileTask  # noqa: F401
