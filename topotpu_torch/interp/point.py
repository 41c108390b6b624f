"""Tile-level interpolation step (port of ``topotpu.interp.point``).

One call interpolates a whole tile of C cells: per-month neighbourhood
selection, the fused regression-kriging normals and anomaly gains, the daily
anomaly contraction, and (in the flat forms) the int16 packing onto a
run-global lattice in calendar order. Dailies are month-grouped: the host
pads each month to ``dpm`` day slots, so station anomalies arrive as
(12, S, dpm).

Every form runs the same kriging half (``_krig_tile_multi``): tables,
neighbourhoods, and all 12 x V systems with their anomaly gain rows in one
``krig_normals_indexed`` call (one for each distinct pair of per-variable
neighbourhood and anomaly sizes). The daily half has
two forms. The flat forms on a caller's fixed lattice (``fixed_scales``, the
production mode) allocate the step's int16 buffer once and fill its daily
rows with one ``scatter_daily_packed`` call, whatever the validity mode and
the neighbourhood sizes: contraction, + normal, reconcile, quantisation and
calendar order happen there, and no float daily array exists. The float
forms (``interp_tile``, ``interp_tile_pair``, ``interp_points``, and the flat
forms without ``fixed_scales``, whose tile-wide min/max needs the floats
first) call ``scatter_daily``.

Dispatch follows the device of the inputs and nothing else. On CUDA tensors
the wrappers launch ``kernels/csrc/krig_normals.cu`` and
``kernels/csrc/scatter_daily.cu``; on CPU tensors they take their plain
torch versions. ``InterpParams.use_pallas`` is read by nothing in the port,
and there is no other switch.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from topotpu_torch.core.config import InterpParams
from topotpu_torch.core.dates import DaysMetadata
from topotpu_torch.geo.distance import pairwise_great_circle_km, unit_xyz
from topotpu_torch.geo.neighbors import select_neighbors
from topotpu_torch.kernels.krig_normals import (
    cell_table,
    krig_normals_indexed,
    station_table,
)
from topotpu_torch.kernels.scatter_daily import (
    PACK_SENTINEL,
    quantize_plane_fixed as _quantize_plane_fixed,
    scatter_daily,
    scatter_daily_packed,
)
from topotpu_torch.utils.profiling import span


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


def _plane_range(x, valid):
    """(min, max) of x over its valid entries, as 0-d tensors; (3e38, -3e38)
    where no entry is valid."""
    big = 3.0e38
    mn = torch.amin(torch.where(valid, x, torch.full_like(x, big)))
    mx = torch.amax(torch.where(valid, x, torch.full_like(x, -big)))
    return mn, mx


def _quantize_plane(x, valid, value_range=None):
    """int16-quantize x over its valid entries with one scale/offset, set by
    ``value_range`` = (min, max) where given (the range over every shard of
    a mesh: ``dist.mesh`` reduces the shards' ``_plane_range``, as JAX's
    ``pmin`` / ``pmax`` do), else by x's own range."""
    mn, mx = _plane_range(x, valid) if value_range is None else value_range
    has_any = mx >= mn
    mn = torch.where(has_any, mn, torch.zeros_like(mn))
    mx = torch.where(has_any, mx, torch.ones_like(mx))
    scale = torch.clamp(mx - mn, min=1e-6) / 65500.0
    offset = (mx + mn) / 2.0
    q = torch.round((x - offset) / scale).to(torch.int16)
    q = torch.where(valid, q, torch.full_like(q, PACK_SENTINEL))
    return q, scale.to(torch.float32), offset.to(torch.float32)


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
    with span("geo.distance"):
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


class _TileKrig(NamedTuple):
    """What the kriging half of a step hands to the daily half."""

    normal: torch.Tensor  # (V, 12, C)
    se: torch.Tensor      # (V, 12, C)
    ok: torch.Tensor      # (V, 12, C) bool
    vario: torch.Tensor   # (V, 12, C, 3)
    idx: torch.Tensor     # (N, C, k) neighbourhoods, N = 1 (shared validity) or 12
    mask: torch.Tensor    # (N, C, k) bool
    gains: torch.Tensor   # (G, N, C, k): G = 1, every variable reads gains[0], or G = V;
    #                       slots beyond a variable's anomaly neighbourhood size carry 0


def _var_sizes(params: InterpParams, V: int):
    """(kvs, kas): each of the ``V`` variables' neighbourhood and anomaly
    sizes."""
    # Per-variable neighbourhood sizes: selection happens once at k_req (the
    # max over variables); each variable's systems read the slots below its
    # own k. top-k output is distance-sorted, so the slots left out are the
    # farthest.
    k_req = params.k_neighbors
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
    return kvs, kas


def krig_launches(params: InterpParams, n_vars: int) -> int:
    """``krig_normals_indexed`` calls of one tile step for ``n_vars``
    variables under ``params``: one for each distinct pair of neighbourhood
    and anomaly sizes."""
    return len(set(zip(*_var_sizes(params, n_vars))))


def _krig_tile_multi(
    inputs: TileInputs,
    all_vars: tuple,
    params: InterpParams,
    shared_validity: bool,
) -> _TileKrig:
    """The kriging half of a step for the variables ``all_vars`` on one tile
    geometry: normals, standard errors, ok flags, cell variograms, and the
    neighbourhoods with their anomaly gain rows.

    Shared across variables: the (C, S) distance matrix, per-month top-k
    selection, the station table and the anomaly gains (geometry only). Per
    variable: the kriging solve.

    All kriging systems and the gain rows go through
    ``krig_normals_indexed``, which reads the neighbourhoods as
    ``select_neighbors`` leaves them and gathers from the station table
    itself. Variables with the same (k, ka) share a call: with one size pair
    for every variable (the usual case) the 12 x V systems take one call;
    with per-variable sizes (``k_per_var`` / ``ka_per_var``) each distinct
    pair takes a call of its own."""
    V = len(all_vars)
    table, cell_tab = tile_tables(inputs, all_vars)
    nbrs = tile_neighborhoods(inputs, params.k_neighbors, shared_validity)
    kvs, kas = _var_sizes(params, V)
    solve_kw = dict(
        weight_kernel=params.weight_kernel, ridge=params.ridge,
        jitter_frac=params.chol_jitter, min_neighbors=params.min_neighbors,
    )
    idx, dist, mask = (torch.stack([getattr(n, f) for n in nbrs])
                       for f in ("idx", "dist", "mask"))
    groups = {}  # (k, ka) -> the variables that take them
    for v, sizes in enumerate(zip(kvs, kas)):
        groups.setdefault(sizes, []).append(v)
    heads, gains = [None] * V, [None] * V
    for (kn, ka), vs in groups.items():
        pairs = [(m, v) for v in vs for m in range(12)]
        # keyed by the launch's shape: the slots read, the systems' and the
        # gain rows' prefixes, and the systems solved
        with span("step.krig", (idx.shape[-1], kn, ka, len(pairs))):
            head, g = krig_normals_indexed(idx, dist, mask, table, cell_tab, pairs,
                                           shared_validity, k_normal=kn, k_anom=ka,
                                           **solve_kw)
        for j, v in enumerate(vs):
            heads[v], gains[v] = head[12 * j:12 * (j + 1)], g
    head = head.view(V, 12, *head.shape[1:]) if len(groups) == 1 else torch.stack(heads)
    gains = gains[0][None] if len(set(kas)) == 1 else torch.stack(gains)
    return _TileKrig(
        normal=head[..., 0],
        se=torch.sqrt(torch.clamp(head[..., 1], min=0.0)),
        ok=(head[..., 2] > 0.5) & inputs.cell_mask,
        vario=head[..., 4:7],
        idx=idx, mask=mask, gains=gains,
    )


def _all_vars(inputs: TileInputs, extra_vars: tuple) -> tuple:
    return (VarFields(inputs.stn_norm, inputs.stn_vario, inputs.stn_anoms),) + tuple(extra_vars)


def _interp_tile_multi(
    inputs: TileInputs,
    extra_vars: tuple,
    params: InterpParams,
    shared_validity: bool,
) -> list:
    """Interpolate 1 + len(extra_vars) variables on one tile geometry with
    float dailies. Returns one TileResult per variable.

    The daily step goes through ``scatter_daily``: on CUDA tensors that is
    the hand-written kernel, on CPU tensors its plain version. Variables that
    share their gain rows share a call over their concatenated day axes; with
    month-invariant validity that call covers every month as well."""
    all_vars = _all_vars(inputs, extra_vars)
    kr = _krig_tile_multi(inputs, all_vars, params, shared_validity)
    V = len(all_vars)
    S = inputs.stn_lon.shape[0]
    C = inputs.cell_lon.shape[0]
    dtype = inputs.cell_lon.dtype
    dpm = inputs.stn_anoms.shape[-1]
    G = kr.gains.shape[0]
    anoms = [None] * V  # [v] (12, C, dpm)
    for g in range(G):
        vs = list(range(V)) if G == 1 else [g]
        if shared_validity:
            Y = torch.cat(
                [all_vars[v].anoms.to(dtype).permute(1, 0, 2).reshape(S, 12 * dpm) for v in vs],
                dim=1,
            )
            out = scatter_daily(kr.idx[0], kr.gains[g, 0], kr.mask[0], Y)
            out = out.view(C, len(vs), 12, dpm).permute(1, 2, 0, 3)  # (vs, 12, C, dpm)
        else:
            out = torch.stack([
                scatter_daily(
                    kr.idx[m], kr.gains[g, m], kr.mask[m],
                    torch.cat([all_vars[v].anoms[m].to(dtype) for v in vs], dim=1),
                ).view(C, len(vs), dpm)
                for m in range(12)
            ]).permute(2, 0, 1, 3)
        for j, v in enumerate(vs):
            anoms[v] = out[j]

    dev = inputs.cell_lon.device
    return [
        TileResult(
            normal=kr.normal[v],
            se=kr.se[v],
            ok=kr.ok[v],
            daily=(kr.normal[v][:, :, None] + anoms[v]).to(dtype),
            vario=kr.vario[v],
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


def _flat_planes(res: TileResult) -> tuple:
    """The daily, normal and se planes of a TileResult that ``_flatten_result``
    quantizes, each with its validity."""
    return ((res.daily, res.ok[:, :, None]), (res.normal, res.ok), (res.se, res.ok))


def flat_ranges(res: TileResult) -> list:
    """(min, max) over the ok entries of each of ``_flat_planes(res)``: what a
    mesh reduces over its shards before ``_flatten_result``."""
    return [_plane_range(x, valid) for x, valid in _flat_planes(res)]


def _flatten_result(res: TileResult, slot_of_day, ranges=None):
    """Quantize (one tile-wide scale/offset a plane, or the three (min, max)
    ``ranges`` of a mesh) + calendar-reorder one TileResult into flat-buffer
    planes and their six scales."""
    C = res.normal.shape[1]
    dpm = res.daily.shape[-1]
    (dq, d_scale, d_off), (nq, n_scale, n_off), (sq, s_scale, s_off) = (
        _quantize_plane(x, valid, None if ranges is None else ranges[i])
        for i, (x, valid) in enumerate(_flat_planes(res))
    )
    scales = torch.stack([d_scale, d_off, n_scale, n_off, s_scale, s_off])
    if isinstance(slot_of_day, torch.Tensor):
        slot = slot_of_day.to(dq.device, torch.long)
    else:
        slot = torch.as_tensor(np.asarray(slot_of_day), dtype=torch.long, device=dq.device)
    cal = dq.permute(0, 2, 1).reshape(12 * dpm, C)[slot]
    return torch.cat([cal, nq, sq], dim=0), scales


def check_slot_of_day(slot_of_day, dpm: int) -> np.ndarray:
    """``slot_of_day`` as an int32 host array, checked: (ndays,) slots in
    [0, 12 * dpm)."""
    slot = np.asarray(slot_of_day)
    if slot.ndim != 1 or (slot.size and (slot.min() < 0 or slot.max() >= 12 * dpm)):
        raise ValueError(f"slot_of_day must be (ndays,) slots in [0, {12 * dpm})")
    return slot.astype(np.int32)


def _on_device(what, t, dtype, shape, dev):
    """A caller's tensor, used as it is: its dtype, shape and device are
    checked (metadata only, no copy and no wait for the device)."""
    if t.dtype != dtype or t.device != dev or (shape is not None and tuple(t.shape) != shape):
        raise ValueError(f"{what}: a {t.dtype} tensor of shape {tuple(t.shape)} on {t.device}, "
                         f"expected {dtype}{'' if shape is None else f' of shape {shape}'} "
                         f"on {dev}")
    return t


def _flat_fixed(inputs, extra_vars, slot_of_day, params, shared_validity, fixed_scales,
                reconcile) -> FlatTileResult:
    """The flat product of 1 + len(extra_vars) variables on the caller's
    run-global lattice ``fixed_scales`` (6 floats a variable): the kriging
    half, then one ``scatter_daily_packed`` call that fills the daily rows of
    the step's buffer, then the 24 normal and se rows of each variable.

    ``slot_of_day`` and ``fixed_scales`` are host arrays, checked and copied
    to the device on every call, or an int32 and a float32 tensor already on
    the inputs' device, used as they are (a caller that steps many tiles
    checks and uploads them once: a copy from pageable memory waits for the
    stream, so a copy a step would hold each launch until the previous
    step's kernels end)."""
    all_vars = _all_vars(inputs, extra_vars)
    V = len(all_vars)
    S = inputs.stn_lon.shape[0]
    C = inputs.cell_lon.shape[0]
    dev = inputs.cell_lon.device
    dpm = inputs.stn_anoms.shape[-1]
    if isinstance(slot_of_day, torch.Tensor):
        slot = _on_device("slot_of_day", slot_of_day, torch.int32, None, dev)
        if slot.dim() != 1:
            raise ValueError("slot_of_day must be (ndays,)")
    else:
        # host arrays go to the device first: a copy from pageable memory waits
        # for the stream, and after the kriging launch that wait would be the launch
        slot = torch.as_tensor(check_slot_of_day(slot_of_day, dpm), device=dev)
    ndays = slot.shape[0]
    if isinstance(fixed_scales, torch.Tensor):
        fs = _on_device("fixed_scales", fixed_scales, torch.float32, (6 * V,), dev)
    else:
        fs = torch.as_tensor(np.asarray(fixed_scales), dtype=torch.float32, device=dev)
        if fs.shape != (6 * V,):
            raise ValueError(f"fixed_scales needs {6 * V} values, got {tuple(fs.shape)}")
    sc = fs.view(V, 6, 1, 1)
    kr = _krig_tile_multi(inputs, all_vars, params, shared_validity)
    Y = torch.stack([var.anoms for var in all_vars]).to(torch.float32)  # (V, 12, S, dpm)
    Y = Y.permute(0, 2, 1, 3).reshape(V, S, 12 * dpm)
    normal, ok = kr.normal.contiguous(), kr.ok.contiguous()
    buf = torch.empty((V * (ndays + 24), C), dtype=torch.int16, device=dev)
    scatter_daily_packed(
        kr.idx, kr.mask, kr.gains.contiguous(), Y, normal, ok, slot,
        fs.view(V, 6)[:, :2].contiguous(), buf, reconcile=reconcile,
    )
    rows = buf.view(V, ndays + 24, C)
    rows[:, ndays : ndays + 12] = _quantize_plane_fixed(normal, ok, sc[:, 2], sc[:, 3])
    rows[:, ndays + 12 :] = _quantize_plane_fixed(kr.se, ok, sc[:, 4], sc[:, 5])
    return FlatTileResult(buf=buf, scales=fs)


def interp_tile_flat(
    inputs: TileInputs,
    slot_of_day,
    params: InterpParams,
    shared_validity: bool = False,
    fixed_scales=None,
) -> FlatTileResult:
    """Production form of ``interp_tile``: one flat int16 buffer (see
    FlatTileResult). ``slot_of_day`` (ndays,) maps calendar day -> flat
    (12 * dpm) month-grouped slot. ``fixed_scales`` (6,) = (d_scale, d_off,
    n_scale, n_off, se_scale, se_off) selects the caller's run-global int16
    lattice (echoed in ``scales``); without it each plane gets one tile-wide
    scale and offset. Either may be a tensor already on the inputs' device
    (int32, float32), passed on unchecked and uncopied (``_flat_fixed``)."""
    if fixed_scales is not None:
        return _flat_fixed(inputs, (), slot_of_day, params, shared_validity, fixed_scales, False)
    res = interp_tile(inputs, params, shared_validity=shared_validity)
    buf, scales = _flatten_result(res, slot_of_day)
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
    if fixed_scales is not None:
        return _flat_fixed(pair.geom, (pair.b,), slot_of_day, params, shared_validity,
                           fixed_scales, reconcile)
    return pair_flatten(reconciled_pair(pair, params, shared_validity, reconcile),
                        slot_of_day)


def reconciled_pair(pair: PairTileInputs, params: InterpParams, shared_validity: bool,
                    reconcile: bool) -> tuple[TileResult, TileResult]:
    """The float half of the dynamic-lattice ``interp_tile_pair_flat``: both
    variables' TileResults, with the reconcile's midpoints where asked."""
    res_a, res_b = interp_tile_pair(pair, params, shared_validity)
    if reconcile:
        both = (res_a.ok & res_b.ok)[:, :, None]
        bad = both & (res_b.daily < res_a.daily)
        mid = 0.5 * (res_a.daily + res_b.daily)
        res_a = res_a._replace(daily=torch.where(bad, mid, res_a.daily))
        res_b = res_b._replace(daily=torch.where(bad, mid, res_b.daily))
    return res_a, res_b


def pair_flatten(results, slot_of_day, ranges=None) -> FlatTileResult:
    """Both variables' TileResults as one flat buffer, var A's block first;
    ``ranges``: six (min, max), three a variable (``flat_ranges``), or None
    for each plane's own."""
    parts = [
        _flatten_result(res, slot_of_day, None if ranges is None else ranges[3 * v : 3 * v + 3])
        for v, res in enumerate(results)
    ]
    return FlatTileResult(
        buf=torch.cat([buf for buf, _ in parts], dim=0),
        scales=torch.cat([sc for _, sc in parts]),
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
# Day-axis (calendar <-> month-grouped) layout helpers: numpy on the host, and
# the month grouping of a station series on the device
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


def group_days_by_month_device(series, layout: MonthLayout, device) -> torch.Tensor:
    """(S, ndays) calendar series, numpy or a tensor -> (12, S, dpm) float32 on
    ``device``, pads 0: ``np.moveaxis(group_days_by_month(series, layout), 1, 0)``
    bit for bit, grouped on the device. The series goes over in calendar order
    in one copy, from the caller's memory where it is a writeable contiguous
    float32 array (else from one host copy that makes it so), and one index
    write puts each day in its month's slot."""
    if isinstance(series, torch.Tensor):
        raw = series.to(device=device, dtype=torch.float32)
    else:
        raw = torch.from_numpy(np.require(series, np.float32, ("C", "W"))).to(device)
    slot = torch.as_tensor(layout.slot_of_day, dtype=torch.long, device=device)
    out = torch.zeros((12, raw.shape[0], layout.dpm), dtype=torch.float32, device=device)
    out[slot // layout.dpm, :, slot % layout.dpm] = raw.T  # (ndays, S) rows
    return out


def ungroup_days(grouped: np.ndarray, layout: MonthLayout) -> np.ndarray:
    """(..., 12, dpm) -> (..., ndays) calendar order."""
    lead = grouped.shape[:-2]
    flat = grouped.reshape(lead + (12 * layout.dpm,))
    return flat[..., layout.slot_of_day]
