"""Tile-level interpolation step (port of ``topotpu.interp.point``).

One call interpolates a whole tile of C cells: per-month neighbourhood
selection, the fused regression-kriging normals and anomaly gains, the daily
anomaly contraction, and (in the flat forms) the int16 packing onto a
run-global lattice in calendar order. Dailies are month-grouped: the host
pads each month to ``dpm`` day slots, so station anomalies arrive as
(12, S, dpm) and one contraction covers a month (or, with month-invariant
validity, the whole year of every variable at once).

Dispatch follows the device of the inputs and nothing else. On CUDA tensors
the normals chain launches ``kernels/csrc/krig_normals.cu`` (all 12 x V
systems of a step in one launch) and the daily step launches
``kernels/csrc/scatter_daily.cu``; on CPU tensors both take their plain
torch versions. ``InterpParams.use_pallas`` is read by nothing
in the port, and there is no other switch.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from topotpu_torch.core.config import InterpParams
from topotpu_torch.core.dates import DaysMetadata
from topotpu_torch.geo.distance import pairwise_great_circle_km, unit_xyz
from topotpu_torch.geo.neighbors import Neighborhood, select_neighbors
from topotpu_torch.interp.anoms import anomaly_gain_rows
from topotpu_torch.kernels.krig_normals import (
    cell_table,
    krig_normals_indexed,
    station_table,
    system_columns,
)
from topotpu_torch.kernels.scatter_daily import scatter_daily

PACK_SENTINEL = -32768  # int16 fill for non-ok cells


class TileInputs(NamedTuple):
    """Inputs for one tile on one device. C cells, S (padded) pool stations."""

    cell_lon: torch.Tensor    # (C,)
    cell_lat: torch.Tensor    # (C,)
    cell_elev: torch.Tensor   # (C,)
    cell_tdi: torch.Tensor    # (C,)
    cell_lst: torch.Tensor    # (C, 12)
    cell_mask: torch.Tensor   # (C,) bool land mask
    stn_lon: torch.Tensor     # (S,)
    stn_lat: torch.Tensor     # (S,)
    stn_elev: torch.Tensor    # (S,)
    stn_tdi: torch.Tensor     # (S,)
    stn_lst: torch.Tensor     # (S, 12)
    stn_norm: torch.Tensor    # (S, 12) monthly normals for the variable
    stn_vario: torch.Tensor   # (S, 12, 3) nugget/psill/range
    stn_valid: torch.Tensor   # (S, 12) bool per-month usability
    stn_anoms: torch.Tensor   # (12, S, dpm) month-grouped daily anomalies


class TileResult(NamedTuple):
    normal: torch.Tensor    # (12, C)
    se: torch.Tensor        # (12, C) kriging standard error
    ok: torch.Tensor        # (12, C)
    daily: torch.Tensor     # (12, C, dpm) month-grouped dailies: float, or
    #                         int16 when pack_daily is set
    vario: torch.Tensor     # (12, C, 3) cell variogram params (diagnostic)
    daily_scale: torch.Tensor | None = None   # () f32, set when daily is int16
    daily_offset: torch.Tensor | None = None  # () f32


class FlatTileResult(NamedTuple):
    """The whole per-tile product as one int16 buffer, one host fetch.

      rows [0, ndays)            daily values, calendar order
      rows [ndays, ndays+12)     monthly normals
      rows [ndays+12, ndays+24)  kriging standard errors

    Non-ok cells carry PACK_SENTINEL in every plane. ``scales`` is
    (daily_scale, daily_offset, norm_scale, norm_offset, se_scale, se_offset).
    """

    buf: torch.Tensor     # (ndays + 24, C) int16
    scales: torch.Tensor  # (6,) float32


class VarFields(NamedTuple):
    """Per-variable station fields; everything else is shared geometry."""

    norm: torch.Tensor    # (S, 12)
    vario: torch.Tensor   # (S, 12, 3)
    anoms: torch.Tensor   # (12, S, dpm)


class PairTileInputs(NamedTuple):
    """Two-variable step: var A is ``geom`` (a full TileInputs); var B shares
    its geometry and validity and supplies only its VarFields."""

    geom: TileInputs
    b: VarFields


def _quantize_plane(x, valid):
    """int16-quantize x over its valid entries with one scale/offset."""
    big = 3.0e38
    mn = torch.amin(torch.where(valid, x, torch.full_like(x, big)))
    mx = torch.amax(torch.where(valid, x, torch.full_like(x, -big)))
    has_any = mx >= mn
    mn = torch.where(has_any, mn, torch.zeros_like(mn))
    mx = torch.where(has_any, mx, torch.ones_like(mx))
    scale = torch.clamp(mx - mn, min=1e-6) / 65500.0
    offset = (mx + mn) / 2.0
    q = torch.round((x - offset) / scale).to(torch.int16)
    q = torch.where(valid, q, torch.full_like(q, PACK_SENTINEL))
    return q, scale.to(torch.float32), offset.to(torch.float32)


def _quantize_plane_fixed(x, valid, scale, offset):
    """int16-quantize x on a caller-chosen (run-global) scale/offset lattice;
    values outside the window clip to its bounds."""
    q = torch.clamp(torch.round((x - offset) / scale), -32767, 32767)
    q = q.to(torch.int16)
    return torch.where(valid, q, torch.full_like(q, PACK_SENTINEL))


def _local_xy_km(lon, lat, ref_lat_deg):
    """Equirectangular local offsets in km (the anomaly-GWR location
    covariates), scaled at the reference latitude."""
    kx = 111.32 * torch.cos(torch.deg2rad(ref_lat_deg))
    return lon * kx, lat * 111.32


def tile_tables(inputs: TileInputs, all_vars) -> tuple[torch.Tensor, torch.Tensor]:
    """The station table (S, 19 + 48 V) and the cell table (C, 16) of one
    tile, as ``krig_normals_indexed`` reads them. x/y are local km offsets
    at the station pool's mean latitude."""
    ref_lat = torch.mean(inputs.stn_lat)
    stn_x, stn_y = _local_xy_km(inputs.stn_lon, inputs.stn_lat, ref_lat)
    cell_x, cell_y = _local_xy_km(inputs.cell_lon, inputs.cell_lat, ref_lat)
    table = station_table(
        inputs.stn_elev, inputs.stn_tdi, stn_x, stn_y,
        unit_xyz(inputs.stn_lon, inputs.stn_lat), inputs.stn_lst,
        [(var.norm, var.vario) for var in all_vars],
    )
    return table, cell_table(inputs.cell_elev, inputs.cell_tdi, cell_x, cell_y,
                             inputs.cell_lst)


def tile_neighborhoods(inputs: TileInputs, k: int, shared_validity: bool) -> list:
    """The tile's k-neighbourhoods from one exact distance matrix: one for
    every month with ``shared_validity``, else one a month."""
    d_all = pairwise_great_circle_km(
        inputs.cell_lon, inputs.cell_lat, inputs.stn_lon, inputs.stn_lat
    )
    return [
        select_neighbors(
            inputs.cell_lon, inputs.cell_lat, inputs.stn_lon, inputs.stn_lat,
            inputs.stn_valid[:, m], k=k, dist_matrix=d_all,
        )
        for m in ((0,) if shared_validity else range(12))
    ]


def _interp_tile_multi(
    inputs: TileInputs,
    extra_vars: tuple,
    params: InterpParams,
    shared_validity: bool,
) -> list:
    """Interpolate 1 + len(extra_vars) variables on one tile geometry.
    Returns one TileResult per variable.

    Shared across variables: the (C, S) distance matrix, per-month top-k
    selection, the station table, the anomaly gains (geometry only) and the
    daily contraction. Per variable: the kriging solve and its slice of the
    daily contraction.

    All kriging systems go through ``krig_normals_indexed``, which reads the
    neighbourhoods as ``select_neighbors`` leaves them and gathers from the
    station table itself. With one neighbourhood size for every variable
    (the usual case) the 12 x V systems take one call; with per-variable
    sizes (``k_per_var`` / ``ka_per_var``) each variable's 12 systems take
    a call of their own, masked beyond that variable's k."""
    S = inputs.stn_lon.shape[0]
    dtype = inputs.cell_lon.dtype
    all_vars = (
        VarFields(inputs.stn_norm, inputs.stn_vario, inputs.stn_anoms),
    ) + tuple(extra_vars)
    V = len(all_vars)
    k_req = params.k_neighbors

    table, cell_tab = tile_tables(inputs, all_vars)
    nbrs = tile_neighborhoods(inputs, k_req, shared_validity)

    # Per-variable neighbourhood sizes: selection happens once at k_req (the
    # max over variables); each variable masks the slots beyond its own k.
    # top-k output is distance-sorted, so masked trailing slots are inert.
    kvs = (
        tuple(int(k) for k in params.k_per_var)
        if params.k_per_var else (k_req,) * V
    )
    ka_base = min(params.k_neighbors_anom, k_req)
    kas = (
        tuple(min(int(a), k_req) for a in params.ka_per_var)
        if params.ka_per_var else (ka_base,) * V
    )
    if len(kvs) != V or len(kas) != V:
        raise ValueError(
            f"k_per_var/ka_per_var need one entry per variable ({V}): "
            f"got {len(kvs)}/{len(kas)}"
        )
    if max(kvs) > k_req:
        raise ValueError("k_per_var entries must be <= k_neighbors")
    uniform = kvs == (k_req,) * V and len(set(kas)) == 1
    solve_kw = dict(
        weight_kernel=params.weight_kernel, ridge=params.ridge,
        jitter_frac=params.chol_jitter, min_neighbors=params.min_neighbors,
    )

    def _prefix(nbr, n):
        return Neighborhood(
            idx=nbr.idx[:, :n], dist=nbr.dist[:, :n], mask=nbr.mask[:, :n]
        )

    anom_cols = system_columns(table, cell_tab, 0, 0)  # month and variable play no part

    def _gains_of(nbr, n):
        """Gain rows of the n-slot prefix of a neighbourhood (plain torch),
        from the three anomaly covariates of its stations."""
        nbr_n = _prefix(nbr, n)
        return anomaly_gain_rows(
            nbr_n.dist, nbr_n.mask, anom_cols["acov"][nbr_n.idx], anom_cols["cell_acov"],
            weight_kernel=params.weight_kernel, ridge=params.ridge,
        ), nbr_n

    normals = [[None] * 12 for _ in range(V)]
    ses = [[None] * 12 for _ in range(V)]
    oks = [[None] * 12 for _ in range(V)]
    varios = [[None] * 12 for _ in range(V)]
    idx, dist, mask = (torch.stack([getattr(n, f) for n in nbrs])
                       for f in ("idx", "dist", "mask"))

    def _solve(pairs, mask):
        """One call for the systems ``pairs``; fills their result slots and
        returns the neighbourhoods' gain rows (at ``mask``)."""
        head, gains = krig_normals_indexed(idx, dist, mask, table, cell_tab, pairs,
                                           shared_validity, **solve_kw)
        se = torch.sqrt(torch.clamp(head[..., 1], min=0.0))
        for p, (m, v) in enumerate(pairs):
            normals[v][m] = head[p, :, 0]
            ses[v][m] = se[p]
            oks[v][m] = (head[p, :, 2] > 0.5) & inputs.cell_mask
            varios[v][m] = head[p, :, 4:7]
        return gains

    if uniform:
        gains = _solve([(m, v) for m in range(12) for v in range(V)], mask)
        gains_by_ka = {kas[0]: [(gains[i], nbr) if kas[0] == k_req else _gains_of(nbr, kas[0])
                                for i, nbr in enumerate(nbrs)]}
    else:
        slots = torch.arange(k_req, device=table.device)
        for v in range(V):
            _solve([(m, v) for m in range(12)], mask & (slots < kvs[v]))
        gains_by_ka = {ka: [_gains_of(nbr, ka) for nbr in nbrs] for ka in sorted(set(kas))}
    # [m] -> [(gains, nbr)] per variable; variables of one ka share the tensors
    gains_by_month = [[gains_by_ka[kas[v]][0 if shared_validity else m] for v in range(V)]
                      for m in range(12)]

    return _finish_tile_multi(
        inputs, all_vars, shared_validity, normals, ses, oks, varios,
        gains_by_month, S, dtype,
    )


def _gain_groups(entries):
    """Group variables that share one gain solve (the same tensor object), so
    each group pays one contraction over its concatenated day axes."""
    groups: list = []
    for v, (g, nb) in enumerate(entries):
        for grp in groups:
            if grp[0] is g:
                grp[2].append(v)
                break
        else:
            groups.append((g, nb, [v]))
    return groups


def _scatter_args(gains, nbr, dtype):
    """(k, C) planes for ``scatter_daily``: int32 idx, gains, 0/1 mask."""
    return (
        nbr.idx.T.to(torch.int32).contiguous(),
        gains.T.contiguous(),
        nbr.mask.T.to(dtype).contiguous(),
    )


def _finish_tile_multi(
    inputs, all_vars, shared_validity, normals, ses, oks, varios,
    gains_by_month, S, dtype,
):
    """Daily anomalies + per-variable TileResult assembly.

    The daily step always goes through ``scatter_daily``: on CUDA tensors
    that is the hand-written kernel, on CPU tensors its plain version. With
    month-invariant validity the gains are the same in every month, so one
    call per gain group covers every month and variable of the group."""
    V = len(all_vars)
    dpm = inputs.stn_anoms.shape[-1]
    dailies = [[] for _ in range(V)]  # [v][m] (C, dpm)

    if shared_validity:
        for g0, nbr0, vs in _gain_groups(gains_by_month[0]):
            Y_cat = torch.cat(
                [all_vars[v].anoms.to(dtype).permute(1, 0, 2).reshape(S, 12 * dpm)
                 for v in vs],
                dim=1,
            ).contiguous()
            anom_all = scatter_daily(*_scatter_args(g0, nbr0, dtype), Y_cat)
            for j, v in enumerate(vs):
                off = j * 12 * dpm
                for m in range(12):
                    dailies[v].append(
                        normals[v][m][:, None]
                        + anom_all[:, off + m * dpm : off + (m + 1) * dpm]
                    )
    else:
        for m in range(12):
            for gains, nbr_a, vs in _gain_groups(gains_by_month[m]):
                Y_m = torch.cat(
                    [all_vars[v].anoms[m].to(dtype) for v in vs], dim=1
                ).contiguous()  # (S, len(vs) * dpm): one call serves the group
                anom = scatter_daily(*_scatter_args(gains, nbr_a, dtype), Y_m)
                for j, v in enumerate(vs):
                    dailies[v].append(
                        normals[v][m][:, None] + anom[:, j * dpm : (j + 1) * dpm]
                    )

    dev = inputs.cell_lon.device
    return [
        TileResult(
            normal=torch.stack(normals[v]),
            se=torch.stack(ses[v]),
            ok=torch.stack(oks[v]),
            daily=torch.stack(dailies[v]).to(dtype),
            vario=torch.stack(varios[v]),
            daily_scale=torch.tensor(1.0, dtype=torch.float32, device=dev),
            daily_offset=torch.tensor(0.0, dtype=torch.float32, device=dev),
        )
        for v in range(V)
    ]


def interp_tile(
    inputs: TileInputs,
    params: InterpParams,
    shared_validity: bool = False,
    pack_daily: bool = False,
) -> TileResult:
    """Interpolate every cell x month x day of one tile.

    ``shared_validity``: the caller knows stn_valid is the same in every
    month, so neighbourhoods are selected once instead of 12 times.
    ``pack_daily``: quantize the dailies to int16 with one tile-wide
    scale/offset; non-ok cells carry PACK_SENTINEL."""
    res = _interp_tile_multi(inputs, (), params, shared_validity)[0]
    if not pack_daily:
        return res
    q, scale, offset = _quantize_plane(res.daily, res.ok[:, :, None])
    return res._replace(daily=q, daily_scale=scale, daily_offset=offset)


def interp_tile_pair(
    pair: PairTileInputs,
    params: InterpParams,
    shared_validity: bool = False,
) -> tuple[TileResult, TileResult]:
    """Two-variable tile step: var B shares var A's neighbourhoods, gains and
    daily contraction, paying only its kriging solve."""
    res = _interp_tile_multi(pair.geom, (pair.b,), params, shared_validity)
    return res[0], res[1]


def _flatten_result(res: TileResult, slot_of_day, fixed_scales=None):
    """Quantize + calendar-reorder one TileResult into flat-buffer planes.

    ``fixed_scales`` (6,) = (d_scale, d_off, n_scale, n_off, se_scale,
    se_off) selects the caller's run-global int16 lattice; the returned
    scales echo it."""
    C = res.normal.shape[1]
    dpm = res.daily.shape[-1]
    valid3 = res.ok[:, :, None]
    if fixed_scales is not None:
        dq = _quantize_plane_fixed(res.daily, valid3, fixed_scales[0], fixed_scales[1])
        nq = _quantize_plane_fixed(res.normal, res.ok, fixed_scales[2], fixed_scales[3])
        sq = _quantize_plane_fixed(res.se, res.ok, fixed_scales[4], fixed_scales[5])
        scales = fixed_scales
    else:
        dq, d_scale, d_off = _quantize_plane(res.daily, valid3)
        nq, n_scale, n_off = _quantize_plane(res.normal, res.ok)
        sq, s_scale, s_off = _quantize_plane(res.se, res.ok)
        scales = torch.stack([d_scale, d_off, n_scale, n_off, s_scale, s_off])
    slot = torch.as_tensor(np.asarray(slot_of_day), dtype=torch.long, device=dq.device)
    cal = dq.permute(0, 2, 1).reshape(12 * dpm, C)[slot]
    return torch.cat([cal, nq, sq], dim=0), scales


def _as_scales(fixed_scales, device):
    if fixed_scales is None:
        return None
    return torch.as_tensor(np.asarray(fixed_scales), dtype=torch.float32, device=device)


def interp_tile_flat(
    inputs: TileInputs,
    slot_of_day,
    params: InterpParams,
    shared_validity: bool = False,
    fixed_scales=None,
) -> FlatTileResult:
    """Production form of ``interp_tile``: one flat int16 buffer (see
    FlatTileResult). ``slot_of_day`` (ndays,) maps calendar day -> flat
    (12 * dpm) month-grouped slot."""
    res = interp_tile(inputs, params, shared_validity=shared_validity)
    buf, scales = _flatten_result(
        res, slot_of_day, _as_scales(fixed_scales, res.normal.device)
    )
    return FlatTileResult(buf=buf, scales=scales)


def interp_tile_pair_flat(
    pair: PairTileInputs,
    slot_of_day,
    params: InterpParams,
    shared_validity: bool = False,
    fixed_scales=None,
    reconcile: bool = False,
) -> FlatTileResult:
    """Production paired step: both variables as ONE flat int16 buffer, var
    A's (ndays + 24, C) block then var B's; ``scales`` is var A's 6 floats
    then var B's (or the caller's (12,) ``fixed_scales``, echoed).

    ``reconcile``: where both cells are ok, collapse daily crossings
    (B < A) to their mean-preserving midpoint, so A <= B holds; with shared
    fixed scales both variables quantize the midpoint to the same int16
    lattice point. Normals are left untouched."""
    res_a, res_b = interp_tile_pair(pair, params, shared_validity)
    if reconcile:
        both = (res_a.ok & res_b.ok)[:, :, None]
        bad = both & (res_b.daily < res_a.daily)
        mid = 0.5 * (res_a.daily + res_b.daily)
        res_a = res_a._replace(daily=torch.where(bad, mid, res_a.daily))
        res_b = res_b._replace(daily=torch.where(bad, mid, res_b.daily))
    fs = _as_scales(fixed_scales, res_a.normal.device)
    buf_a, sc_a = _flatten_result(res_a, slot_of_day, None if fs is None else fs[:6])
    buf_b, sc_b = _flatten_result(res_b, slot_of_day, None if fs is None else fs[6:])
    return FlatTileResult(
        buf=torch.cat([buf_a, buf_b], dim=0), scales=torch.cat([sc_a, sc_b])
    )


def interp_points(
    lon: np.ndarray,
    lat: np.ndarray,
    elev: np.ndarray,
    tdi: np.ndarray,
    lst: np.ndarray,
    stations,
    days: DaysMetadata,
    device: torch.device | str,
    params: InterpParams | None = None,
):
    """Interpolate arbitrary points: the N points are the tile's cells.

    lon/lat/elev/tdi: (N,); lst: (N, 12); ``stations`` carries lon, lat,
    elev, tdi, lst, norm, vario, valid and calendar-order anoms (as
    ``topotpu.dist.engine.StationSet`` does); ``days`` gives the span.
    Returns ``(TileResult, MonthLayout)`` with month-grouped dailies."""
    params = params or InterpParams()
    layout = month_layout(days)
    anoms = group_days_by_month(np.asarray(stations.anoms, np.float32), layout)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)  # noqa: E731
    valid = np.asarray(stations.valid, bool)
    ti = TileInputs(
        cell_lon=f32(lon), cell_lat=f32(lat), cell_elev=f32(elev),
        cell_tdi=f32(tdi), cell_lst=f32(lst),
        cell_mask=torch.ones(len(lon), dtype=torch.bool, device=device),
        stn_lon=f32(stations.lon), stn_lat=f32(stations.lat),
        stn_elev=f32(stations.elev), stn_tdi=f32(stations.tdi),
        stn_lst=f32(stations.lst), stn_norm=f32(stations.norm),
        stn_vario=f32(stations.vario),
        stn_valid=torch.as_tensor(valid, device=device),
        stn_anoms=f32(np.moveaxis(anoms, 1, 0)),
    )
    shared = bool(np.all(valid == valid[:, :1]))
    return interp_tile(ti, params, shared_validity=shared), layout


# ---------------------------------------------------------------------------
# Host-side day-axis (calendar <-> month-grouped) layout helpers, numpy only
# ---------------------------------------------------------------------------


class MonthLayout(NamedTuple):
    """Mapping between a calendar day axis and the (12, dpm) padded layout."""

    dpm: int                 # padded days-per-month slots
    slot_of_day: np.ndarray  # (ndays,) flat index into 12*dpm
    day_valid: np.ndarray    # (12, dpm) bool
    month_idx: np.ndarray    # (ndays,)


def month_layout(days: DaysMetadata) -> MonthLayout:
    slot = np.empty(days.ndays, dtype=np.int64)
    pos = np.zeros(12, dtype=np.int64)  # per-month running position
    for i, m in enumerate(days.month_idx):
        slot[i] = pos[m]
        pos[m] += 1
    dpm = int(pos.max())
    flat = days.month_idx.astype(np.int64) * dpm + slot
    valid = np.zeros((12, dpm), dtype=bool)
    valid.reshape(-1)[flat] = True
    return MonthLayout(
        dpm=dpm, slot_of_day=flat, day_valid=valid, month_idx=days.month_idx
    )


def group_days_by_month(series: np.ndarray, layout: MonthLayout) -> np.ndarray:
    """(..., ndays) calendar -> (..., 12, dpm) padded month-grouped (pads = 0)."""
    lead = series.shape[:-1]
    out = np.zeros(lead + (12 * layout.dpm,), dtype=series.dtype)
    out[..., layout.slot_of_day] = series
    return out.reshape(lead + (12, layout.dpm))


def ungroup_days(grouped: np.ndarray, layout: MonthLayout) -> np.ndarray:
    """(..., 12, dpm) -> (..., ndays) calendar order."""
    lead = grouped.shape[:-2]
    flat = grouped.reshape(lead + (12 * layout.dpm,))
    return flat[..., layout.slot_of_day]
