"""Moving-window regression kriging of monthly normals on gathered
neighbourhoods (port of ``topotpu.interp.normals``).

Per cell: a GWR trend on the caller's covariates (any q of them: elevation,
TDI, monthly LST, ...) plus ordinary kriging of the trend residuals with
exponential variogram parameters interpolated from the stations to the cell,
giving the kriged normal and its variance; ``krig_normals_and_gains`` adds
the anomaly-GWR gain rows of the same neighbourhood on qa anomaly
covariates. The inputs arrive gathered per neighbourhood, (C, k) / (C, k, q)
with a validity mask, as ``topotpu.interp.normals`` takes them.

Both functions are one call of ``kernels/krig_normals.py::
krig_normals_gathered``: on CUDA tensors one launch of the hand kernel
(``csrc/krig_normals.cu``), on CPU tensors its plain torch version. The
tensors' device decides, as for every kernel wrapper of the port: there is
no ``use_pallas`` switch, and no padding of the cells or of k (the kernel
takes any C and any 1 <= k <= 64). The kernel bounds the covariates at
q + qa <= 8, as the TPU kernel's eight cell-covariate rows do.

The tile step (``interp/point.py``) does not come through here: it gathers
its station rows inside the kernel's indexed entry.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from topotpu_torch.kernels import krig_normals as _kn


class NormalsResult(NamedTuple):
    normal: torch.Tensor    # (C,) kriged monthly normal
    variance: torch.Tensor  # (C,) kriging variance (deg C^2)
    se: torch.Tensor        # (C,) sqrt variance
    trend: torch.Tensor     # (C,) GWR trend component (diagnostic)
    ok: torch.Tensor        # (C,) bool solvable flag
    vario: torch.Tensor     # (C, 3) cell-interpolated nugget/psill/range


def interp_cell_variogram(nbr_vario: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(C, k, 3) station params + (C, k) weights -> (C, 3) cell params."""
    wsum = torch.sum(w, dim=-1, keepdim=True) + 1e-30
    v = torch.einsum("ck,ckp->cp", w, nbr_vario) / wsum
    nug = torch.clamp(v[..., 0], min=0.0)
    psill = torch.clamp(v[..., 1], min=1e-6)
    rng = torch.clamp(v[..., 2], min=1e-2)
    return torch.stack([nug, psill, rng], dim=-1)


def _result(head: torch.Tensor) -> NormalsResult:
    """The (C, 8) head rows [normal, variance, ok, trend, nugget, psill,
    range, 0] as a ``NormalsResult``."""
    var = head[:, 1]
    return NormalsResult(
        normal=head[:, 0], variance=var, se=torch.sqrt(torch.clamp(var, min=0.0)),
        trend=head[:, 3], ok=head[:, 2] > 0.5, vario=head[:, 4:7],
    )


def krig_normals_and_gains(
    dist, mask, nbr_xyz, nbr_cov, cell_cov, nbr_norm, nbr_vario,
    anom_cov, cell_anom_cov,
    weight_kernel: str = "bisquare", ridge: float = 1e-6, jitter_frac: float = 1e-5,
    min_neighbors: int = 3,
):
    """``krig_normals`` + the anomaly-GWR gain rows (C, k) over the same
    neighbourhoods, in one kernel call. ``anom_cov`` (C, k, qa) and
    ``cell_anom_cov`` (C, qa) are the anomaly design's covariates. Returns
    (NormalsResult, gains)."""
    operands = (dist, mask, nbr_xyz, nbr_cov, cell_cov, nbr_norm, nbr_vario, anom_cov,
                cell_anom_cov)
    head, gains = _kn.krig_normals_gathered(
        *(t.contiguous() for t in operands), ridge=ridge, jitter_frac=jitter_frac,
        min_neighbors=min_neighbors, weight_kernel=weight_kernel,
    )
    return _result(head), gains


def krig_normals(
    dist: torch.Tensor,
    mask: torch.Tensor,
    nbr_xyz: torch.Tensor,
    nbr_cov: torch.Tensor,
    cell_cov: torch.Tensor,
    nbr_norm: torch.Tensor,
    nbr_vario: torch.Tensor,
    weight_kernel: str = "bisquare",
    ridge: float = 1e-6,
    jitter_frac: float = 1e-5,
    min_neighbors: int = 3,
) -> NormalsResult:
    """Regression-krige monthly normals for a batch of cells.

    Args:
      dist: (C, k) neighbour distances, km. mask: (C, k) validity (bool).
      nbr_xyz: (C, k, 3) neighbour unit-sphere coords (for pair distances).
      nbr_cov: (C, k, q) neighbour covariates; cell_cov: (C, q) at the cell.
      nbr_norm: (C, k) neighbour station monthly normals.
      nbr_vario: (C, k, 3) per-station (nugget, psill, range).

    The kernel computes gain rows too; as on the JAX package's TPU route,
    the anomaly design is the first trend column and its gains are dropped.
    """
    res, _ = krig_normals_and_gains(
        dist, mask, nbr_xyz, nbr_cov, cell_cov, nbr_norm, nbr_vario,
        nbr_cov[..., :1], cell_cov[..., :1], weight_kernel=weight_kernel, ridge=ridge,
        jitter_frac=jitter_frac, min_neighbors=min_neighbors,
    )
    return res
