"""topotpu_torch: the tile interpolation step of topotpu on PyTorch and CUDA.

A second package beside ``topotpu`` (the JAX reference), with the same
subpackage names so that each module's counterpart is easy to find:

=====================  ==============================================
``core``               device and dtype policy (no TF32, explicit device)
``geo``                great-circle distances, kNN neighbourhoods, weights
``kernels``            batched WLS / kriging solves, and the hand-written
                       CUDA kernels ``krig_normals`` and ``scatter_daily``
                       (sources in ``kernels/csrc``) beside their plain
                       torch versions
``interp``             normals, anomaly gains, the tile step, and
                       conversion of the JAX package's tile state
``io``                 tile inputs from a synthetic world
=====================  ==============================================

It imports ``torch`` and never ``jax``. Configuration (``InterpParams``,
``TopoConfig``), dates, grids, the synthetic world and the float64 oracle
are shared with ``topotpu``, whose modules for them import no JAX.
"""

__version__ = "0.1.0"

# importing the device policy turns TF32 off for every user of the port
from topotpu_torch.core import device as _device  # noqa: E402,F401
