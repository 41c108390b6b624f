"""Fused regression-kriging normals: the kernel's wrapper and its plain version.

``krig_normals_indexed`` launches ``csrc/krig_normals.cu`` on CUDA tensors
and runs a plain torch version on CPU tensors. It computes, per (cell,
month, variable), the head values

    [normal, variance, ok, trend, nugget, psill, range, 0]

and, per neighbourhood, the k anomaly-GWR gains of every cell: the chain of
``topotpu.kernels.pallas_krig.krig_normals_fused``, which took one system
from gathered (rows, B) planes. This entry takes the neighbourhoods as
``select_neighbors`` leaves them (``idx``, ``dist``, ``mask``, each
(N, C, k)), the station table and the cell table (see ``station_table`` /
``cell_table``), and the list of (month, variable) systems to solve, and
covers them all in one launch. With ``shared`` there is one neighbourhood
(N = 1) for every system; without, neighbourhood n serves the systems of
month n (N = 12). It returns the heads (P, C, 8) and the gains (N, C, k).

The plain version, ``krig_normals_indexed_ref``, is the port of
``topotpu.interp.normals.krig_normals``: it composes the port's plain
modules (distance weights, centred design, WLS, variogram interpolation,
pair distances, covariance assembly, OK solve, GWR gain). Any C and any
1 <= k <= 64 are taken; no padding.
"""

from __future__ import annotations

import ctypes

import torch

from topotpu_torch.geo.distance import pairwise_km_from_xyz
from topotpu_torch.geo.neighbors import distance_weights
from topotpu_torch.kernels import _build
from topotpu_torch.kernels.cholesky import assemble_exp_cov, ok_solve
from topotpu_torch.kernels.wls import batched_gwr_gain, batched_wls, center_design

WEIGHT_KERNELS = ("bisquare", "gaussian", "uniform")  # kernel's enum order
OUT_EXTRA = 8  # head values of a system (rows before the k gain rows)
MAX_SYSTEMS = 96  # systems one indexed launch takes

# Station table columns: elev, tdi, x_km, y_km, xyz(3), lst(12), then per
# variable norm(12) and vario(12 x 3, month-major). Cell table columns: elev,
# tdi, x_km, y_km, lst(12).
TABLE_BASE = 19
TABLE_VAR_COLS = 48
CELL_COLS = 16

_INDEXED_ARGTYPES = (
    (ctypes.c_void_p, ctypes.c_int) + (ctypes.c_void_p,) * 3
    + (ctypes.c_int, ctypes.c_int) + (ctypes.c_void_p,) * 3
    + (ctypes.c_int, ctypes.c_int) + (ctypes.c_void_p,) * 2
    + (ctypes.c_int,) * 3 + (ctypes.c_float, ctypes.c_float)
    + (ctypes.c_int, ctypes.c_int, ctypes.c_void_p)
)


def station_table(elev, tdi, x_km, y_km, xyz, lst, variables) -> torch.Tensor:
    """The (S, 19 + 48 V) station table of the indexed entry: one row a
    station. ``elev``, ``tdi``, ``x_km``, ``y_km`` (S,); ``xyz`` (S, 3);
    ``lst`` (S, 12); ``variables`` a sequence of (norm (S, 12), vario
    (S, 12, 3)), one per variable."""
    dtype = xyz.dtype
    S = xyz.shape[0]
    cols = [elev.to(dtype)[:, None], tdi.to(dtype)[:, None], x_km.to(dtype)[:, None],
            y_km.to(dtype)[:, None], xyz, lst.to(dtype)]
    for norm, vario in variables:
        cols += [norm.to(dtype), vario.to(dtype).reshape(S, 36)]
    return torch.cat(cols, dim=1)


def cell_table(elev, tdi, x_km, y_km, lst) -> torch.Tensor:
    """The (C, 16) cell table of the indexed entry: elev, tdi, x_km, y_km
    (C,) and lst (C, 12)."""
    return torch.cat([torch.stack([elev, tdi, x_km, y_km], dim=-1), lst], dim=1)


def system_columns(G: torch.Tensor, cell: torch.Tensor, m: int, v: int) -> dict:
    """What system (month m, variable v) reads of gathered station-table rows
    ``G`` (..., F) and of the cell table (C, 16): ``xyz`` (..., 3), the trend
    covariates ``cov`` (..., 3) and ``cell_cov`` (C, 3) (elev, tdi, lst_m),
    ``norm`` (...,), ``vario`` (..., 3), and the anomaly covariates ``acov``
    (..., 3) and ``cell_acov`` (C, 3) (elev, x_km, y_km)."""
    base = TABLE_BASE + TABLE_VAR_COLS * v
    return dict(
        xyz=G[..., 4:7], cov=G[..., [0, 1, 7 + m]], cell_cov=cell[:, [0, 1, 4 + m]],
        norm=G[..., base + m], vario=G[..., base + 12 + 3 * m : base + 15 + 3 * m],
        acov=G[..., [0, 2, 3]], cell_acov=cell[:, [0, 2, 3]],
    )


def _cell_variogram(nbr_vario: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(C, k, 3) station params + (C, k) weights -> (C, 3) cell params
    (``topotpu.interp.normals.interp_cell_variogram``)."""
    wsum = torch.sum(w, dim=-1, keepdim=True) + 1e-30
    v = torch.einsum("ck,ckp->cp", w, nbr_vario) / wsum
    nug = torch.clamp(v[..., 0], min=0.0)
    psill = torch.clamp(v[..., 1], min=1e-6)
    rng = torch.clamp(v[..., 2], min=1e-2)
    return torch.stack([nug, psill, rng], dim=-1)


def _head(dist, mask, w, xyz, cov, cell_cov, nbr_norm, nbr_vario, ridge, jitter_frac,
          min_neighbors) -> torch.Tensor:
    """One system's head values (C, 8) from gathered (C, k, ...) inputs and
    the neighbourhood's weights ``w``."""
    X, x0, _ = center_design(cov, cell_cov, w)
    beta = batched_wls(X, nbr_norm, w, ridge)
    trend = torch.sum(x0 * beta, dim=-1)
    trend_at = torch.einsum("ckp,cp->ck", X, beta)
    resid = torch.where(mask, nbr_norm - trend_at, torch.zeros_like(trend_at))

    vario = _cell_variogram(nbr_vario, w)
    C, c0, sill = assemble_exp_cov(
        pairwise_km_from_xyz(xyz, xyz), dist,
        vario[:, 0], vario[:, 1], vario[:, 2], mask, jitter_frac=jitter_frac,
    )
    sol = ok_solve(C, c0, mask, sill, min_neighbors)
    normal = trend + torch.sum(sol.weights * resid, dim=-1)
    return torch.stack(
        [normal, sol.variance, sol.ok.to(normal.dtype), trend,
         vario[:, 0], vario[:, 1], vario[:, 2], torch.zeros_like(normal)], dim=-1)


def _gains(w, acov, cell_acov, ridge) -> torch.Tensor:
    """The neighbourhood's anomaly-GWR gain rows (C, k)."""
    Xa, xa0, _ = center_design(acov, cell_acov, w)
    return batched_gwr_gain(Xa, w, xa0, ridge)


def _indexed_args(idx, dist, mask, table, cell, pairs, shared):
    """Shapes of the indexed entry's arguments, checked: (N, C, k, V, pairs)."""
    what = "krig_normals_indexed"
    if idx.dim() != 3 or dist.shape != idx.shape or mask.shape != idx.shape:
        raise ValueError(f"{what}: idx, dist and mask must share one (N, C, k) shape")
    N, C, k = idx.shape
    if not 1 <= k <= 64:
        raise ValueError(f"{what}: k={k} outside 1..64")
    if N != (1 if shared else 12):
        raise ValueError(f"{what}: {N} neighbourhoods, expected {1 if shared else 12}")
    if table.dim() != 2 or table.shape[1] < TABLE_BASE or (
            table.shape[1] - TABLE_BASE) % TABLE_VAR_COLS:
        raise ValueError(f"{what}: station table of shape {tuple(table.shape)}")
    if tuple(cell.shape) != (C, CELL_COLS):
        raise ValueError(f"{what}: cell table of shape {tuple(cell.shape)}, expected "
                         f"{(C, CELL_COLS)}")
    V = (table.shape[1] - TABLE_BASE) // TABLE_VAR_COLS
    pairs = [(int(m), int(v)) for m, v in pairs]
    if len(pairs) > MAX_SYSTEMS:
        raise ValueError(f"{what}: {len(pairs)} systems, at most {MAX_SYSTEMS} a call")
    if any(not (0 <= m < 12 and 0 <= v < V) for m, v in pairs):
        raise ValueError(f"{what}: a (month, variable) pair outside 12 x {V}")
    return N, C, k, V, pairs


def krig_normals_indexed_ref(
    idx, dist, mask, table, cell, pairs, shared: bool,
    ridge: float = 1e-6, jitter_frac: float = 1e-5, min_neighbors: int = 3,
    weight_kernel: str = "bisquare",
):
    """Plain version of the indexed entry: the same arguments, heads
    (P, C, 8) and gains (N, C, k), computed with the port's batched torch
    modules in the dtype of the tables. Each neighbourhood's table rows are
    gathered once, with the indices clamped into the table as the kernel
    clamps them."""
    N, C, _, _, pairs = _indexed_args(idx, dist, mask, table, cell, pairs, shared)
    last = table.shape[0] - 1
    heads = [None] * len(pairs)
    gains = []
    for n in range(N):
        G = table[idx[n].long().clamp(0, last)]  # (C, k, F)
        d, msk = dist[n].to(table.dtype), mask[n].bool()
        w = distance_weights(d, msk, weight_kernel)
        c = system_columns(G, cell, 0, 0)
        gains.append(_gains(w, c["acov"], c["cell_acov"], ridge))
        for p, (m, v) in enumerate(pairs):
            if not shared and m != n:
                continue
            c = system_columns(G, cell, m, v)
            heads[p] = _head(d, msk, w, c["xyz"], c["cov"], c["cell_cov"], c["norm"],
                             c["vario"], ridge, jitter_frac, min_neighbors)
    head = (torch.stack(heads) if heads
            else table.new_zeros((0, C, OUT_EXTRA)))
    return head, torch.stack(gains)


def krig_normals_indexed(
    idx: torch.Tensor,    # (N, C, k) int32 or int64 station rows of the table
    dist: torch.Tensor,   # (N, C, k) float32 neighbour distances, km
    mask: torch.Tensor,   # (N, C, k) bool
    table: torch.Tensor,  # (S, 19 + 48 V) float32, see station_table
    cell: torch.Tensor,   # (C, 16) float32, see cell_table
    pairs,                # the (month, variable) systems to solve
    shared: bool,         # one neighbourhood for every system (N = 1), or
                          # neighbourhood n for the systems of month n (N = 12)
    ridge: float = 1e-6,
    jitter_frac: float = 1e-5,
    min_neighbors: int = 3,
    weight_kernel: str = "bisquare",
):
    """Every system of ``pairs`` in one launch -> (head (P, C, 8), gains
    (N, C, k)); head[p] holds system ``pairs[p]``. An entry of ``idx``
    outside the table is clamped to its first or last row, by the kernel and
    by the plain version alike (neither reads ``idx`` back to the host to
    check it; a ``jnp`` gather clamps the same way). In a masked slot the row
    read is inert; in a valid slot the system is solved with that row."""
    what = "krig_normals_indexed"
    args = (idx, dist, mask, table, cell)
    dev = _build.common_device(what, *args)
    if weight_kernel not in WEIGHT_KERNELS:
        raise ValueError(f"unknown weight kernel {weight_kernel!r}")
    kw = dict(ridge=ridge, jitter_frac=jitter_frac, min_neighbors=min_neighbors,
              weight_kernel=weight_kernel)
    if dev.type == "cpu":
        return krig_normals_indexed_ref(*args, pairs, shared, **kw)
    N, C, k, _, pairs = _indexed_args(*args, pairs, shared)
    if idx.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"{what}: idx is {idx.dtype}, expected int32 or int64")
    f32 = torch.float32
    S, F = table.shape
    _build.require(what, "idx", idx, idx.dtype, (N, C, k))
    _build.require(what, "dist", dist, f32, (N, C, k))
    _build.require(what, "mask", mask, torch.bool, (N, C, k))
    _build.require(what, "table", table, f32, (S, F))
    _build.require(what, "cell", cell, f32, (C, CELL_COLS))
    P = len(pairs)
    head = torch.empty((P, C, OUT_EXTRA), dtype=f32, device=dev)
    gains = torch.empty((N, C, k), dtype=f32, device=dev)
    months = (ctypes.c_int * max(P, 1))(*(m for m, _ in pairs))
    variables = (ctypes.c_int * max(P, 1))(*(v for _, v in pairs))
    fn = _build.load("krig_normals", "krig_normals_indexed_launch", _INDEXED_ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(
            idx.data_ptr(), int(idx.dtype == torch.int64), dist.data_ptr(), mask.data_ptr(),
            table.data_ptr(), S, F, cell.data_ptr(),
            ctypes.cast(months, ctypes.c_void_p), ctypes.cast(variables, ctypes.c_void_p),
            P, int(bool(shared)), head.data_ptr(), gains.data_ptr(), N, C, k,
            ridge, jitter_frac, min_neighbors, WEIGHT_KERNELS.index(weight_kernel),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(err, what)
    krig_normals_indexed.launches += 1
    return head, gains


krig_normals_indexed.launches = 0
