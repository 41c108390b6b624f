"""Station-series infilling: predictor selection, batched PPCA imputation
and the post-infill changepoint flags."""

from topotpu_torch.infill.pipeline import (  # noqa: F401
    InfillResult,
    infill_network,
    select_predictors,
)
