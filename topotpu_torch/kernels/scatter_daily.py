"""Daily-anomaly contraction: the kernel's two wrappers and their plain versions.

``scatter_daily(idx, gains, mask, Y)`` computes the (C, D) float dailies

    out[c, d] = sum_j gains[c, j] * mask[c, j] * Y[idx[c, j], d]

the function of ``topotpu.kernels.pallas_scatter.scatter_daily_matmul``, with
the operands as ``select_neighbors`` and ``krig_normals_indexed`` leave them:
(C, k), a cell's slots contiguous (the TPU kernel takes (k, C) planes).

``scatter_daily_packed`` computes the same sum for every variable, month and
day of a tile step and carries it to the step's product: + the kriged normal,
the tmin <= tmax reconcile, the int16 quantisation on a fixed lattice and the
calendar order, written into the rows of the step's int16 buffer.

On CUDA tensors both launch ``csrc/scatter_daily.cu``; on CPU tensors they run
their plain versions ``scatter_daily_ref`` (the gather-and-contract
formulation of ``topotpu.interp.anoms.predict_daily_gathered``) and
``scatter_daily_packed_ref`` (that, followed by the plain torch operations of
the JAX package's ``_finish_tile_multi``, reconcile and ``_flatten_result``).
An index outside [0, S) contributes nothing, in a masked slot or not, in the
kernel and in the plain versions alike (the TPU kernel's rule).
"""

from __future__ import annotations

import ctypes

import torch

from topotpu_torch.kernels import _build

PACK_SENTINEL = -32768  # int16 fill for non-ok cells

_ARGTYPES = (
    (ctypes.c_void_p, ctypes.c_int) + (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 4
    + (ctypes.c_void_p,)
)
_PACKED_ARGTYPES = (
    (ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
     ctypes.c_int, ctypes.c_void_p, ctypes.c_int) + (ctypes.c_void_p,) * 5
    + (ctypes.c_int,) * 6 + (ctypes.c_void_p,)
)

# Cap on the (cells, k, D) gathered block of the plain version, in elements,
# so that it runs at production shapes within a bounded memory.
_REF_BLOCK_ELEMS = 1 << 27


def quantize_plane_fixed(x, valid, scale, offset):
    """int16-quantize x on a caller-chosen (run-global) scale/offset lattice;
    values outside the window clip to its bounds, entries that are not
    ``valid`` carry PACK_SENTINEL."""
    q = torch.clamp(torch.round((x - offset) / scale), -32767, 32767)
    q = q.to(torch.int16)
    return torch.where(valid, q, torch.full_like(q, PACK_SENTINEL))


def scatter_daily_ref(
    idx: torch.Tensor,    # (C, k) integer station indices
    gains: torch.Tensor,  # (C, k) gains
    mask: torch.Tensor,   # (C, k) bool
    Y: torch.Tensor,      # (S, D) station-day matrix
) -> torch.Tensor:
    """Plain version: gather each neighbourhood's Y rows and contract.
    Cells are processed in blocks so the gathered tensor stays bounded."""
    C, k = idx.shape
    S, D = Y.shape
    idx = idx.long()
    in_range = (idx >= 0) & (idx < S)
    g = gains.to(Y.dtype) * mask.to(Y.dtype) * in_range.to(Y.dtype)
    idx = idx.clamp(0, S - 1)
    out = torch.empty((C, D), dtype=Y.dtype, device=Y.device)
    step = max(1, _REF_BLOCK_ELEMS // max(1, k * D))
    for c0 in range(0, C, step):
        rows = Y[idx[c0 : c0 + step]]      # (n, k, D)
        out[c0 : c0 + step] = torch.einsum("ck,ckd->cd", g[c0 : c0 + step], rows)
    return out


def _idx_flag(what, idx):
    if idx.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"{what}: idx is {idx.dtype}, expected int32 or int64")
    return int(idx.dtype == torch.int64)


def scatter_daily(
    idx: torch.Tensor,    # (C, k) int32 or int64
    gains: torch.Tensor,  # (C, k) float32
    mask: torch.Tensor,   # (C, k) bool
    Y: torch.Tensor,      # (S, D) float32
) -> torch.Tensor:
    """(C, D) float32 daily anomalies. CUDA inputs launch the hand-written
    kernel (all contiguous); CPU inputs take the plain version. Duplicate
    indices accumulate; an index outside [0, S) contributes nothing."""
    what = "scatter_daily"
    dev = _build.common_device(what, idx, gains, mask, Y)
    if dev.type == "cpu":
        return scatter_daily_ref(idx, gains, mask, Y)
    if idx.dim() != 2 or Y.dim() != 2:
        raise ValueError(f"{what}: idx {tuple(idx.shape)} and Y {tuple(Y.shape)} must be 2-D")
    C, k = idx.shape
    S, D = Y.shape
    _build.require(what, "idx", idx, idx.dtype, (C, k))
    idx64 = _idx_flag(what, idx)
    _build.require(what, "gains", gains, torch.float32, (C, k))
    _build.require(what, "mask", mask, torch.bool, (C, k))
    _build.require(what, "Y", Y, torch.float32, (S, D))
    out = torch.empty((C, D), dtype=torch.float32, device=dev)
    fn = _build.load("scatter_daily", "scatter_daily_launch", _ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(
            idx.data_ptr(), idx64, gains.data_ptr(), mask.data_ptr(),
            Y.data_ptr(), out.data_ptr(), C, k, S, D,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(err, what)
    scatter_daily.launches += 1
    return out


scatter_daily.launches = 0


def _packed_args(idx, mask, gains, Y, normal, ok, slot_of_day, scales, out, reconcile):
    """Shapes of the packed entry's arguments, checked: (G, N, C, k, V, S, dpm, ndays)."""
    what = "scatter_daily_packed"
    if idx.dim() != 3 or mask.shape != idx.shape:
        raise ValueError(f"{what}: idx and mask must share one (N, C, k) shape")
    N, C, k = idx.shape
    if N not in (1, 12):
        raise ValueError(f"{what}: {N} neighbourhoods, expected 1 or 12")
    if Y.dim() != 3 or Y.shape[2] % 12:
        raise ValueError(f"{what}: Y of shape {tuple(Y.shape)}, expected (V, S, 12 * dpm)")
    V, S, D = Y.shape
    if V not in (1, 2):
        raise ValueError(f"{what}: {V} variables, expected 1 or 2")
    if gains.dim() != 4 or tuple(gains.shape[1:]) != (N, C, k) or gains.shape[0] not in (1, V):
        raise ValueError(f"{what}: gains of shape {tuple(gains.shape)}, expected "
                         f"(1 or {V}, {N}, {C}, {k})")
    if reconcile and V != 2:
        raise ValueError(f"{what}: reconcile needs two variables")
    ndays = slot_of_day.shape[0]
    for name, t, shape in (("normal", normal, (V, 12, C)), ("ok", ok, (V, 12, C)),
                           ("slot_of_day", slot_of_day, (ndays,)), ("scales", scales, (V, 2)),
                           ("out", out, (V * (ndays + 24), C))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{what}: {name} has shape {tuple(t.shape)}, expected {shape}")
    return gains.shape[0], N, C, k, V, S, D // 12, ndays


def scatter_daily_packed_ref(idx, mask, gains, Y, normal, ok, slot_of_day, scales, out,
                             reconcile: bool = False):
    """Plain version of the packed entry, from the plain torch operations of
    the tile step: gather-contract (``scatter_daily_ref``, one call for all
    months with N = 1, one a month with N = 12), add the normal, reconcile,
    ``quantize_plane_fixed``, calendar gather. Same arguments; fills the same
    rows of ``out`` and returns it."""
    G, N, C, _, V, S, dpm, ndays = _packed_args(
        idx, mask, gains, Y, normal, ok, slot_of_day, scales, out, reconcile)
    dtype = Y.dtype
    dailies = []  # [v] (12, C, dpm)
    for v in range(V):
        g = gains[v if G > 1 else 0]
        if N == 1:
            anom = scatter_daily_ref(idx[0], g[0], mask[0], Y[v]).reshape(C, 12, dpm)
            anom = anom.permute(1, 0, 2)
        else:
            Ym = Y[v].reshape(S, 12, dpm)
            anom = torch.stack([scatter_daily_ref(idx[m], g[m], mask[m], Ym[:, m])
                                for m in range(12)])
        dailies.append(normal[v].to(dtype)[:, :, None] + anom)
    if reconcile:
        both = (ok[0] & ok[1])[:, :, None]
        bad = both & (dailies[1] < dailies[0])
        mid = 0.5 * (dailies[0] + dailies[1])
        dailies = [torch.where(bad, mid, d) for d in dailies]
    slot = slot_of_day.long()
    rows = out.view(V, ndays + 24, C)
    for v in range(V):
        dq = quantize_plane_fixed(dailies[v], ok[v][:, :, None], scales[v, 0], scales[v, 1])
        rows[v, :ndays] = dq.permute(0, 2, 1).reshape(12 * dpm, C)[slot]
    return out


def scatter_daily_packed(
    idx: torch.Tensor,          # (N, C, k) int32 or int64; N = 1 (one neighbourhood for
                                # every month) or 12 (neighbourhood m for month m)
    mask: torch.Tensor,         # (N, C, k) bool
    gains: torch.Tensor,        # (G, N, C, k) float32; G = 1 (the variables share the gain
                                # rows) or V (variable v reads gains[v])
    Y: torch.Tensor,            # (V, S, 12 * dpm) float32 station anomalies, month-grouped
    normal: torch.Tensor,       # (V, 12, C) float32 kriged normals
    ok: torch.Tensor,           # (V, 12, C) bool
    slot_of_day: torch.Tensor,  # (ndays,) int32: calendar day -> slot in [0, 12 * dpm),
                                # month = slot // dpm; no two days share a slot
    scales: torch.Tensor,       # (V, 2) float32: each variable's daily scale and offset
    out: torch.Tensor,          # (V * (ndays + 24), C) int16: the step's product
    reconcile: bool = False,    # V = 2: collapse crossings (x_1 < x_0, both ok) to their mean
) -> torch.Tensor:
    """The daily rows of a tile step's int16 product, in place. For variable
    v, calendar day t in month m and cell c, with n = 0 or m and g = 0 or v:

        x_v = normal[v, m, c] + sum_j gains[g, n, c, j] mask[n, c, j] Y[v, idx[n, c, j], slot_of_day[t]]
        reconcile, both ok, x_1 < x_0:  x_0 = x_1 = (x_0 + x_1) / 2
        out[v (ndays + 24) + t, c] = clamp(rint((x_v - offset_v) / scale_v), +-32767) if ok[v, m, c] else -32768

    Rows t >= ndays of each variable's block (normals, standard errors) are
    not touched. CUDA inputs launch the hand-written kernel once; CPU inputs
    take the plain version. Returns ``out``."""
    what = "scatter_daily_packed"
    args = (idx, mask, gains, Y, normal, ok, slot_of_day, scales, out)
    dev = _build.common_device(what, *args)
    if dev.type == "cpu":
        return scatter_daily_packed_ref(*args, reconcile)
    G, N, C, k, V, S, dpm, ndays = _packed_args(*args, reconcile)
    idx64 = _idx_flag(what, idx)
    f32 = torch.float32
    _build.require(what, "idx", idx, idx.dtype, (N, C, k))
    _build.require(what, "mask", mask, torch.bool, (N, C, k))
    _build.require(what, "gains", gains, f32, (G, N, C, k))
    _build.require(what, "Y", Y, f32, (V, S, 12 * dpm))
    _build.require(what, "normal", normal, f32, (V, 12, C))
    _build.require(what, "ok", ok, torch.bool, (V, 12, C))
    _build.require(what, "slot_of_day", slot_of_day, torch.int32, (ndays,))
    _build.require(what, "scales", scales, f32, (V, 2))
    _build.require(what, "out", out, torch.int16, (V * (ndays + 24), C))
    fn = _build.load("scatter_daily", "scatter_daily_packed_launch", _PACKED_ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(
            idx.data_ptr(), idx64, gains.data_ptr(), G, mask.data_ptr(), N, Y.data_ptr(), V,
            normal.data_ptr(), ok.data_ptr(), slot_of_day.data_ptr(), scales.data_ptr(),
            out.data_ptr(), C, k, S, dpm, ndays, int(bool(reconcile)),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(err, what)
    scatter_daily_packed.launches += 1
    return out


scatter_daily_packed.launches = 0
