"""topotpu_torch: the tile interpolation step and the station-side kriging
stages of topotpu on PyTorch and CUDA.

A second package beside ``topotpu`` (the JAX reference), with the same
subpackage names so that each module's counterpart is easy to find:

=====================  ==============================================
``core``               device and dtype policy (no TF32, explicit device)
``geo``                great-circle distances, kNN neighbourhoods, weights
``kernels``            batched WLS / kriging solves, and the hand-written
                       CUDA kernels ``krig_normals``, ``scatter_daily`` and
                       ``ok_solve`` (sources in ``kernels/csrc``) beside
                       their plain torch versions
``stats``              the exponential variogram: model, empirical
                       estimator, batched Gauss-Newton fit
``interp``             normals, anomaly gains, the tile step, conversion of
                       the JAX package's state, per-station variogram
                       parameters, cross-validation and nnghs optimisation
``io``                 tile inputs and station arrays from a synthetic world
=====================  ==============================================

It imports ``torch`` and never ``jax``. Configuration (``InterpParams``,
``TopoConfig``), dates, grids, the synthetic world and the float64 oracle
are shared with ``topotpu``, whose modules for them import no JAX.
"""

__version__ = "0.1.0"

# importing the device policy turns TF32 off for every user of the port
from topotpu_torch.core import device as _device  # noqa: E402,F401
