"""topotpu_torch: the tile interpolation step, the station-side kriging
stages and the station infill of topotpu on PyTorch and CUDA.

A second package beside ``topotpu`` (the JAX reference), with the same
subpackage names so that each module's counterpart is easy to find:

=====================  ==============================================
``core``               device and dtype policy (no TF32, explicit device),
                       configuration dataclasses, dates, grids
``geo``                great-circle distances, kNN neighbourhoods, weights
``kernels``            batched WLS / kriging solves, and the hand-written
                       CUDA kernels ``krig_normals``, ``scatter_daily`` and
                       ``ok_solve`` (sources in ``kernels/csrc``) beside
                       their plain torch versions
``stats``              the exponential variogram (model, empirical
                       estimator, batched Gauss-Newton fit) and PPCA
``infill``             predictor selection, batched PPCA imputation,
                       post-infill changepoint flags
``homog``              the C++ SNHT changepoint core those flags use
``interp``             anomaly gains, the tile step, conversion of
                       the JAX package's state, per-station variogram
                       parameters, cross-validation and nnghs optimisation
``io``                 the synthetic world; tile inputs and station arrays
                       from it
``oracle``             float64 numpy oracles
=====================  ==============================================

It imports ``torch``, numpy, scipy and the standard library, never ``jax``
and nothing of ``topotpu``: configuration (``InterpParams``, ``TopoConfig``),
dates, grids, the synthetic world, the float64 oracle and the SNHT core are
its own copies, with the JAX package's field names, defaults and results
(``tests/test_torch_core.py``).
"""

__version__ = "0.1.0"

# importing the device policy turns TF32 off for every user of the port
from topotpu_torch.core import device as _device  # noqa: E402,F401
