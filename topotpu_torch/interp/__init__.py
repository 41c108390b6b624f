"""The tile interpolation step on torch tensors."""

from topotpu_torch.interp.normals import (  # noqa: F401
    NormalsResult,
    krig_normals,
    krig_normals_and_gains,
)
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
