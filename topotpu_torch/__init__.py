"""topotpu_torch: topotpu on PyTorch and CUDA, from the station database to
the gridded product: station QA and homogenisation, the station infill, the
station-side kriging stages, the tile interpolation step, its cell-sharded
form over several devices and the engine that drives it, jobs over several
processes, and the pipeline CLI that chains the stages.

A second package beside ``topotpu`` (the JAX reference), with the same
subpackage names so that each module's counterpart is easy to find:

=====================  ==============================================
``core``               device and dtype policy (no TF32, explicit device),
                       configuration dataclasses, constants, dates, grids
``io``                 the station database (HDF5; ``h5py`` is imported
                       only where a file is opened), the raw-format readers
                       and DB build, USHCN ingest, download URLs, rasters,
                       NetCDF/HDF5 tile and mosaic writers, the synthetic
                       world
``qa``                 station-observation and location QA (numpy)
``homog``              pairwise homogenisation: the C++ SNHT and break-model
                       core and the network logic around it
``geo``                great-circle distances, kNN neighbourhoods, weights,
                       climate regions
``kernels``            batched WLS / kriging solves, and the hand-written
                       CUDA kernels ``krig_normals``, ``scatter_daily``,
                       ``ok_solve`` and ``variogram_fit`` (sources in
                       ``kernels/csrc``) beside their plain torch versions
``stats``              the exponential variogram (model, empirical
                       estimator, batched Gauss-Newton fit) and PPCA
``infill``             predictor selection, batched PPCA imputation,
                       post-infill changepoint flags
``interp``             anomaly gains, the tile step, conversion of
                       the JAX package's state, per-station variogram
                       parameters, cross-validation and nnghs optimisation,
                       the float64 validation mode
``dist``               the device mesh and the cell-sharded tile step,
                       the production engine (``TileEngine``) and jobs
                       over several processes (``torch.distributed``)
``cli``                the pipeline CLI, ``python -m topotpu_torch.cli``
``utils``              status lines, wall-time scopes, profiler traces
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
