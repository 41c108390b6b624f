"""Device/dtype policy. Configuration types are shared with ``topotpu.core``,
which imports no JAX."""

from topotpu_torch.core.device import (  # noqa: F401
    COMPUTE_DTYPE,
    apply_precision_policy,
    cuda_device,
)
