"""Fused ordinary-kriging solve: kernel wrappers and their plain versions.

``ok_solve_fused`` and ``ok_solve_fused_xyz`` have the signatures and outputs
of ``topotpu.kernels.pallas_krig.ok_solve_fused`` / ``ok_solve_fused_xyz``:
batch-last inputs, pair distances (k, k, B) or unit-sphere rows (3k, B), and
(weights (k, B), variance (B,), ok (B,) bool) out. On CUDA tensors they launch
``csrc/ok_solve.cu``; on CPU tensors they run ``ok_solve_fused_ref`` /
``ok_solve_fused_xyz_ref``. Any B and any 1 <= k <= 64 are taken; no padding.

The plain versions assemble the covariance with ``cholesky.assemble_exp_cov``
and then follow the TPU kernel's own factorisation and OK rule, which differ
from ``cholesky.ok_solve`` on singular input: each pivot is
``sqrt(max(d_jj, 1e-20))`` (no NaN factor), and a cell is ok when
``n_valid >= min_neighbors`` and ``1^T u > 1e-12`` (no finiteness test).
"""

from __future__ import annotations

import ctypes

import torch

from topotpu_torch.geo.distance import pairwise_km_from_xyz
from topotpu_torch.kernels import _build
from topotpu_torch.kernels.cholesky import assemble_exp_cov

_ARGTYPES = (ctypes.c_void_p,) * 9 + (
    ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p,
)


def _guarded_cholesky(C: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of (B, k, k) with every pivot taken as
    sqrt(max(d_jj, 1e-20)), column by column as the TPU kernel does."""
    A = C.clone()
    L = torch.zeros_like(C)
    for j in range(C.shape[-1]):
        dj = torch.sqrt(torch.clamp(A[:, j, j], min=1e-20))
        col = A[:, j + 1 :, j] / dj[:, None]
        L[:, j, j] = dj
        L[:, j + 1 :, j] = col
        A[:, j + 1 :, j + 1 :] -= col[:, :, None] * col[:, None, :]
    return L


def _xyz_rows(xyz3k: torch.Tensor, k: int) -> torch.Tensor:
    """(3k, B) coordinate-major rows -> (B, k, 3)."""
    return xyz3k.reshape(3, k, xyz3k.shape[1]).permute(2, 1, 0)


def ok_solve_fused_ref(
    dist_pair_t, dist_point_t, mask_t, nugget, psill, rng,
    jitter_frac: float = 1e-5, min_neighbors: int = 3,
):
    """Plain version of the pair-distance entry, in the dtype of the inputs."""
    mask = mask_t.T > 0.5
    C, c0, sill = assemble_exp_cov(
        dist_pair_t.permute(2, 0, 1), dist_point_t.T, nugget, psill, rng, mask,
        jitter_frac=jitter_frac,
    )
    L = _guarded_cholesky(C)
    m = mask.to(C.dtype)
    rhs = torch.stack([c0, m], dim=-1)  # (B, k, 2)
    z = torch.linalg.solve_triangular(L, rhs, upper=False)
    sol = torch.linalg.solve_triangular(L.transpose(-1, -2), z, upper=True)
    a, u = sol[..., 0] * m, sol[..., 1] * m
    sum_a, sum_u = a.sum(-1), u.sum(-1)
    ok = (m.sum(-1) >= float(min_neighbors)) & (sum_u > 1e-12)
    t = (1.0 - sum_a) / torch.where(ok, sum_u, torch.ones_like(sum_u))
    lam = a + t[:, None] * u
    var = torch.clamp(sill - torch.sum(lam * c0, dim=-1) + t, min=0.0)
    return lam.T, var, ok


def ok_solve_fused_xyz_ref(
    xyz3k, dist_point_t, mask_t, nugget, psill, rng,
    jitter_frac: float = 1e-5, min_neighbors: int = 3,
):
    """Plain version of the xyz entry: exact great-circle pair distances from
    the unit-sphere rows, then ``ok_solve_fused_ref``."""
    xyz = _xyz_rows(xyz3k, dist_point_t.shape[0])
    dp = pairwise_km_from_xyz(xyz, xyz).permute(1, 2, 0)
    return ok_solve_fused_ref(dp, dist_point_t, mask_t, nugget, psill, rng,
                              jitter_frac=jitter_frac, min_neighbors=min_neighbors)


def _launch(what, first, first_shape, dist_point_t, mask_t, nugget, psill, rng,
            jitter_frac, min_neighbors, xyz):
    k, B = dist_point_t.shape
    dev = first.device
    f32 = torch.float32
    for name, t, shape in (
        ("first", first, first_shape), ("dist_point_t", dist_point_t, (k, B)),
        ("mask_t", mask_t, (k, B)), ("nugget", nugget, (B,)),
        ("psill", psill, (B,)), ("rng", rng, (B,)),
    ):
        _build.require(what, name, t, f32, shape)
    weights = torch.empty((k, B), dtype=f32, device=dev)
    variance = torch.empty((B,), dtype=f32, device=dev)
    ok = torch.empty((B,), dtype=torch.bool, device=dev)
    fn = _build.load("ok_solve", "ok_solve_launch", _ARGTYPES)
    args = (first, dist_point_t, mask_t, nugget, psill, rng, weights, variance, ok)
    with torch.cuda.device(dev):
        err = fn(*(t.data_ptr() for t in args), B, k, jitter_frac, min_neighbors,
                 int(xyz), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, what)
    return weights, variance, ok


def _check_k(what, k):
    if not 1 <= k <= 64:
        raise ValueError(f"{what}: k={k} outside 1..64")


def ok_solve_fused(
    dist_pair_t: torch.Tensor,   # (k, k, B) pair distances, km
    dist_point_t: torch.Tensor,  # (k, B) cell-to-neighbour distances, km
    mask_t: torch.Tensor,        # (k, B) 0/1
    nugget: torch.Tensor,        # (B,)
    psill: torch.Tensor,         # (B,)
    rng: torch.Tensor,           # (B,)
    jitter_frac: float = 1e-5,
    min_neighbors: int = 3,
):
    """Covariance assembly + Cholesky + two solves + OK reduction from pair
    distances -> (weights (k, B), variance (B,), ok (B,) bool)."""
    what = "ok_solve"
    args = (dist_pair_t, dist_point_t, mask_t, nugget, psill, rng)
    dev = _build.common_device(what, *args)
    k, B = dist_point_t.shape
    _check_k(what, k)
    if dev.type == "cpu":
        return ok_solve_fused_ref(*args, jitter_frac=jitter_frac,
                                  min_neighbors=min_neighbors)
    out = _launch(what, dist_pair_t, (k, k, B), *args[1:], jitter_frac,
                  min_neighbors, xyz=False)
    ok_solve_fused.launches += 1
    return out


def ok_solve_fused_xyz(
    xyz3k: torch.Tensor,         # (3k, B) unit-sphere x rows, y rows, z rows
    dist_point_t: torch.Tensor,  # (k, B)
    mask_t: torch.Tensor,        # (k, B) 0/1
    nugget: torch.Tensor,        # (B,)
    psill: torch.Tensor,         # (B,)
    rng: torch.Tensor,           # (B,)
    jitter_frac: float = 1e-5,
    min_neighbors: int = 3,
):
    """The same solve with pair distances computed in the kernel from xyz
    (exact great-circle km)."""
    what = "ok_solve_xyz"
    args = (xyz3k, dist_point_t, mask_t, nugget, psill, rng)
    dev = _build.common_device(what, *args)
    k, B = dist_point_t.shape
    _check_k(what, k)
    if dev.type == "cpu":
        return ok_solve_fused_xyz_ref(*args, jitter_frac=jitter_frac,
                                      min_neighbors=min_neighbors)
    out = _launch(what, xyz3k, (3 * k, B), *args[1:], jitter_frac,
                  min_neighbors, xyz=True)
    ok_solve_fused_xyz.launches += 1
    return out


ok_solve_fused.launches = 0
ok_solve_fused_xyz.launches = 0
