"""Batched solves (plain torch) and the hand-written CUDA kernels, each beside
its plain version in its own module (``kernels.krig_normals`` and
``kernels.scatter_daily`` of the tile step; ``kernels.ok_solve_fused``, the
fused OK solve at its own API; ``kernels.variogram_fit``, the station
variograms' Gauss-Newton fit). Importing this package builds and loads
nothing: a kernel is compiled at its first launch (see ``_build``)."""

from topotpu_torch.kernels.cholesky import (  # noqa: F401
    OKSolution,
    assemble_exp_cov,
    ok_solve,
)
from topotpu_torch.kernels.wls import (  # noqa: F401
    batched_gwr_gain,
    batched_wls,
    center_design,
)
