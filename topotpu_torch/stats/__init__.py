"""Station statistics on torch tensors: the exponential variogram model, its
empirical estimator and the batched Gauss-Newton fit, and batched PPCA
imputation."""

from topotpu_torch.stats.ppca import (  # noqa: F401
    PPCAResult,
    ppca_impute,
    variance_adjust,
)
from topotpu_torch.stats.variogram import (  # noqa: F401
    EmpiricalVariogram,
    VariogramFit,
    empirical_variogram,
    exp_covariance,
    exp_variogram,
    fit_exp_variogram,
)
