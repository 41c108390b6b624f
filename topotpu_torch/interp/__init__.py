"""The tile interpolation step, regression-kriged normals on gathered
neighbourhoods, the anomaly gain rows and the station-side kriging stages
(variogram parameters, cross-validation, nnghs optimisation) on torch
tensors, and the infill cross-validation."""

from topotpu_torch.interp.normals import NormalsResult, krig_normals  # noqa: F401
from topotpu_torch.interp.normals import krig_normals_and_gains  # noqa: F401
from topotpu_torch.interp.anoms import anomaly_gain_rows, scatter_gains  # noqa: F401

from topotpu_torch.interp.point import (  # noqa: F401
    PACK_SENTINEL,
    FlatTileResult,
    MonthLayout,
    PairTileInputs,
    TileInputs,
    TileResult,
    VarFields,
    group_days_by_month,
    interp_points,
    interp_tile,
    interp_tile_flat,
    interp_tile_pair,
    interp_tile_pair_flat,
    month_layout,
    ungroup_days,
)
from topotpu_torch.interp.params import (  # noqa: F401
    KrigParamsResult,
    build_krig_params,
    fill_failed_fits,
    krig_params_to_numpy,
)
from topotpu_torch.interp.xval import (  # noqa: F401
    XvalScores,
    optimize_nnghs,
    optimize_nnghs_anoms,
    xval_infill,
    xval_interp_daily,
    xval_interp_normals,
)
