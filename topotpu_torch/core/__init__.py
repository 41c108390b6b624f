"""Device/dtype policy, and the port's own copies of the configuration
dataclasses (``config``), dates, grids and constants, exported as
``topotpu.core`` exports them."""

from topotpu_torch.core import config, constants, dates, grid  # noqa: F401
from topotpu_torch.core.config import TopoConfig  # noqa: F401
from topotpu_torch.core.dates import DaysMetadata, get_days_metadata  # noqa: F401
from topotpu_torch.core.device import (  # noqa: F401
    COMPUTE_DTYPE,
    apply_precision_policy,
    cuda_device,
)
from topotpu_torch.core.grid import GridSpec, TileSpec  # noqa: F401
