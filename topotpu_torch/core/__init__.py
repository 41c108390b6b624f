"""Device/dtype policy, and the port's own copies of the configuration
dataclasses (``config``), dates, grids and constants."""

from topotpu_torch.core.device import (  # noqa: F401
    COMPUTE_DTYPE,
    apply_precision_policy,
    cuda_device,
)
