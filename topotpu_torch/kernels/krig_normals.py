"""Fused regression-kriging normals: kernel wrapper and its plain version.

``krig_normals_fused`` has the signature and output rows of
``topotpu.kernels.pallas_krig.krig_normals_fused``: inputs are (rows, B)
with the cell index last, and the (8 + k, B) output holds

    [normal, variance, ok, trend, nugget, psill, range, 0]

then the k anomaly-GWR gain rows. On CUDA tensors it launches
``csrc/krig_normals.cu``; on CPU tensors it runs ``krig_normals_fused_ref``,
which composes the port's plain modules (distance weights, centred design,
WLS, variogram interpolation, pair distances, covariance assembly, OK solve,
GWR gain). Any B and any 1 <= k <= 64 are taken; no padding.
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
OUT_EXTRA = 8  # rows before the k gain rows

_ARGTYPES = (
    (ctypes.c_void_p,) * 9
    + (ctypes.c_int,) * 4
    + (ctypes.c_float, ctypes.c_float)
    + (ctypes.c_int, ctypes.c_int, ctypes.c_void_p)
)


def _split_rows(a: torch.Tensor, k: int) -> torch.Tensor:
    """(n k, B) covariate-major rows -> (B, k, n)."""
    n = a.shape[0] // k
    return a.reshape(n, k, a.shape[1]).permute(2, 1, 0)


def _shape_args(dist_t, covs_t, acovs_t):
    k, B = dist_t.shape
    if not 1 <= k <= 64:
        raise ValueError(f"krig_normals: k={k} outside 1..64")
    if covs_t.shape[0] % k or acovs_t.shape[0] % k:
        raise ValueError("krig_normals: covariate rows must be multiples of k")
    q, qa = covs_t.shape[0] // k, acovs_t.shape[0] // k
    if q + qa > OUT_EXTRA or q >= OUT_EXTRA or qa >= OUT_EXTRA:
        raise ValueError(f"krig_normals: q={q}, qa={qa} exceed the 8 cell rows")
    return k, B, q, qa


def krig_normals_fused_ref(
    xyz3k, dist_t, mask_t, covs_t, cell_t, norm_t, vario_t, acovs_t,
    ridge: float = 1e-6, jitter_frac: float = 1e-5, min_neighbors: int = 3,
    weight_kernel: str = "bisquare",
) -> torch.Tensor:
    """Plain version of the kernel: the same (8 + k, B) rows, computed with
    the port's batched torch modules in the dtype of the inputs."""
    from topotpu_torch.interp.normals import interp_cell_variogram

    k, B, q, qa = _shape_args(dist_t, covs_t, acovs_t)
    dist = dist_t.T
    mask = mask_t.T > 0.5
    nbr_norm = norm_t.T
    w = distance_weights(dist, mask, weight_kernel)

    X, x0, _ = center_design(_split_rows(covs_t, k), cell_t[:q].T, w)
    beta = batched_wls(X, nbr_norm, w, ridge)
    trend = torch.sum(x0 * beta, dim=-1)
    trend_at = torch.einsum("ckp,cp->ck", X, beta)
    resid = torch.where(mask, nbr_norm - trend_at, torch.zeros_like(trend_at))

    vario = interp_cell_variogram(_split_rows(vario_t, k), w)
    xyz = _split_rows(xyz3k, k)
    C, c0, sill = assemble_exp_cov(
        pairwise_km_from_xyz(xyz, xyz), dist,
        vario[:, 0], vario[:, 1], vario[:, 2], mask, jitter_frac=jitter_frac,
    )
    sol = ok_solve(C, c0, mask, sill, min_neighbors)
    normal = trend + torch.sum(sol.weights * resid, dim=-1)

    Xa, xa0, _ = center_design(_split_rows(acovs_t, k), cell_t[q : q + qa].T, w)
    gains = batched_gwr_gain(Xa, w, xa0, ridge)

    head = torch.stack(
        [normal, sol.variance, sol.ok.to(normal.dtype), trend,
         vario[:, 0], vario[:, 1], vario[:, 2], torch.zeros_like(normal)]
    )
    return torch.cat([head, gains.T], dim=0)


def krig_normals_fused(
    xyz3k: torch.Tensor,    # (3k, B) unit-sphere coords, coordinate-major
    dist_t: torch.Tensor,   # (k, B) neighbour distances, km
    mask_t: torch.Tensor,   # (k, B) 0/1
    covs_t: torch.Tensor,   # (q k, B) trend covariates, covariate-major
    cell_t: torch.Tensor,   # (8, B) cell covariates: trend rows, then anomaly
    norm_t: torch.Tensor,   # (k, B) station monthly normals
    vario_t: torch.Tensor,  # (3k, B) nugget rows, psill rows, range rows
    acovs_t: torch.Tensor,  # (qa k, B) anomaly-GWR covariates
    ridge: float = 1e-6,
    jitter_frac: float = 1e-5,
    min_neighbors: int = 3,
    weight_kernel: str = "bisquare",
) -> torch.Tensor:
    """Whole regression-kriging chain + anomaly gains -> (8 + k, B)."""
    what = "krig_normals"
    args = (xyz3k, dist_t, mask_t, covs_t, cell_t, norm_t, vario_t, acovs_t)
    dev = _build.common_device(what, *args)
    if weight_kernel not in WEIGHT_KERNELS:
        raise ValueError(f"unknown weight kernel {weight_kernel!r}")
    if dev.type == "cpu":
        return krig_normals_fused_ref(
            *args, ridge=ridge, jitter_frac=jitter_frac,
            min_neighbors=min_neighbors, weight_kernel=weight_kernel,
        )
    k, B, q, qa = _shape_args(dist_t, covs_t, acovs_t)
    if (3 * k + 8) * B >= 2**31:
        raise ValueError(f"krig_normals: B={B} too large for 32-bit offsets")
    f32 = torch.float32
    for name, t, rows in (
        ("xyz3k", xyz3k, 3 * k), ("dist_t", dist_t, k), ("mask_t", mask_t, k),
        ("covs_t", covs_t, q * k), ("cell_t", cell_t, OUT_EXTRA),
        ("norm_t", norm_t, k), ("vario_t", vario_t, 3 * k),
        ("acovs_t", acovs_t, qa * k),
    ):
        _build.require(what, name, t, f32, (rows, B))
    out = torch.empty((OUT_EXTRA + k, B), dtype=f32, device=dev)
    fn = _build.load("krig_normals", "krig_normals_launch", _ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(
            *(t.data_ptr() for t in args), out.data_ptr(), B, k, q, qa,
            ridge, jitter_frac, min_neighbors,
            WEIGHT_KERNELS.index(weight_kernel),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(err, what)
    krig_normals_fused.launches += 1
    return out


krig_normals_fused.launches = 0
