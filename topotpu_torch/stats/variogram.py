"""Exponential variogram: model, empirical estimator, batched WLS fit (port of
``topotpu.stats.variogram``).

* empirical estimator: equal-width distance bins up to a cutoff, semivariance
  0.5 * mean (z_i - z_j)^2 per bin, with pair counts and mean bin distance
  (gstat's ``variogram``);
* fit: weighted least squares with gstat's fit.method = 7 weights
  (w_j = N_j / h_j^2), minimised by a damped Gauss-Newton loop whose damping
  adapts per batch element, batched over every station at once.

Plain torch on the tensors' device: the JAX package leaves these to XLA, and
they are a small share of the station stages. Matmuls run at full float32
(TF32 is off, ``core.device``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


def exp_variogram(h, nugget, psill, rng):
    """gamma(h) = nugget + psill * (1 - exp(-h / rng)) for h > 0; 0 at h = 0."""
    rng = torch.clamp(torch.as_tensor(rng, dtype=h.dtype, device=h.device), min=1e-6)
    g = nugget + psill * (1.0 - torch.exp(-h / rng))
    return torch.where(h > 0.0, g, 0.0)


def exp_covariance(h, nugget, psill, rng):
    """C(h) = sill - gamma(h): psill * exp(-h / rng), and nugget + psill at 0."""
    rng = torch.clamp(torch.as_tensor(rng, dtype=h.dtype, device=h.device), min=1e-6)
    c = psill * torch.exp(-h / rng)
    return torch.where(h > 0.0, c, psill + nugget)


class EmpiricalVariogram(NamedTuple):
    gamma: torch.Tensor   # (B, n_bins) binned semivariance (0 where empty)
    h: torch.Tensor       # (B, n_bins) mean pair distance per bin
    npairs: torch.Tensor  # (B, n_bins) pair counts
    cutoff: torch.Tensor  # (B,) distance cutoff used


class VariogramFit(NamedTuple):
    nugget: torch.Tensor  # (B,)
    psill: torch.Tensor   # (B,)
    rng: torch.Tensor     # (B,) exponential range parameter, km
    sse: torch.Tensor     # (B,) weighted SSE at the solution
    ok: torch.Tensor      # (B,) bool: enough non-empty bins to fit


def empirical_variogram(
    dist: torch.Tensor,
    values: torch.Tensor,
    mask: torch.Tensor,
    n_bins: int = 15,
    max_dist_frac: float = 1.0,
) -> EmpiricalVariogram:
    """Binned empirical semivariogram, batched.

    dist (B, k, k) pair distances within each neighbourhood, km; values
    (B, k) detrended residuals; mask (B, k) validity. Pairs are the valid
    i < j with distance > 0; the cutoff is ``max_dist_frac`` times the
    largest such distance. Each pair is added to its bin with one
    ``scatter_add`` (pairs beyond the cutoff go to a discarded extra bin).
    """
    k = dist.shape[-1]
    pair_mask = mask[..., :, None] & mask[..., None, :]
    iu = torch.triu(torch.ones((k, k), dtype=torch.bool, device=dist.device), 1)
    pair_mask = pair_mask & iu & (dist > 0.0)

    zero = torch.zeros((), dtype=dist.dtype, device=dist.device)
    dmax = torch.amax(torch.where(pair_mask, dist, zero), dim=(-2, -1))
    cutoff = torch.clamp(dmax * max_dist_frac, min=1e-3)
    width = cutoff / n_bins

    dv = values[..., :, None] - values[..., None, :]
    sv = 0.5 * dv * dv
    bin_idx = torch.clamp((dist / width[..., None, None]).to(torch.int64), 0, n_bins - 1)
    in_range = pair_mask & (dist <= cutoff[..., None, None])
    bin_idx = torch.where(in_range, bin_idx, torch.full_like(bin_idx, n_bins))

    lead = dist.shape[:-2]
    flat = lambda a: a.reshape(lead + (k * k,))  # noqa: E731
    sums = torch.zeros((3,) + lead + (n_bins + 1,), dtype=dist.dtype, device=dist.device)
    idx = flat(bin_idx)
    for s, a in zip(sums, (sv, dist, in_range.to(dist.dtype))):
        s.scatter_add_(-1, idx, flat(a))
    gsum, hsum, cnt = sums[..., :n_bins]
    safe = torch.clamp(cnt, min=1.0)
    return EmpiricalVariogram(gamma=gsum / safe, h=hsum / safe, npairs=cnt, cutoff=cutoff)


def fit_exp_variogram(
    emp: EmpiricalVariogram,
    n_iters: int = 50,
    min_bins: int = 4,
) -> VariogramFit:
    """Batched damped Gauss-Newton WLS fit of the exponential model.

    Weights follow gstat fit.method = 7 (w_j = N_j / h_j^2), normalised per
    element. Parameters are clamped to their feasible box every step; the
    damping factor halves on improvement and doubles on failure, per element,
    with selects only: no data-dependent control flow and no host sync.
    """
    gamma, h, npairs = emp.gamma, emp.h, emp.npairs
    zero = torch.zeros((), dtype=gamma.dtype, device=gamma.device)
    bin_ok = npairs > 0.0
    w = torch.where(bin_ok, npairs / torch.clamp(h, min=1e-3) ** 2, zero)
    w = w / (torch.sum(w, dim=-1, keepdim=True) + 1e-30)

    fit_ok = torch.sum(bin_ok, dim=-1) >= min_bins

    # initial values: nugget from the first non-empty bin, sill from the
    # high bins, range a third of the cutoff
    first_gamma = _first_valid(gamma, bin_ok)
    tail_gamma = _tail_mean(gamma, bin_ok)
    sill0 = torch.clamp(tail_gamma, min=1e-8)
    nug0 = torch.minimum(torch.clamp(first_gamma * 0.5, min=0.0), 0.9 * sill0)
    psill0 = torch.clamp(sill0 - nug0, min=1e-8)
    rng0 = torch.clamp(emp.cutoff / 3.0, min=1e-2)

    hmax = torch.amax(torch.where(bin_ok, h, zero), dim=-1)
    rng_hi = torch.clamp(hmax * 10.0, min=1.0)
    rng_lo = 1e-2

    def sse_of(nug, ps, rg):
        g = nug[..., None] + ps[..., None] * (
            1.0 - torch.exp(-h / torch.clamp(rg[..., None], min=1e-6))
        )
        r = torch.where(bin_ok, gamma - g, zero)
        return torch.sum(w * r * r, dim=-1)

    eye = torch.eye(3, dtype=gamma.dtype, device=gamma.device)
    nug, ps, rg = nug0, psill0, rng0
    lam_damp = torch.full_like(nug0, 1e-3)
    sse = sse_of(nug0, psill0, rng0)
    for _ in range(n_iters):
        rgc = torch.clamp(rg, min=1e-6)
        e = torch.exp(-h / rgc[..., None])
        model = nug[..., None] + ps[..., None] * (1.0 - e)
        r = torch.where(bin_ok, gamma - model, zero)
        # Jacobian columns: d/dnug = 1, d/dpsill = 1 - e, d/drng = -ps h / r^2 e
        J = torch.stack(
            [torch.ones_like(h), 1.0 - e, -(ps[..., None] * h / rgc[..., None] ** 2) * e],
            dim=-1,
        )  # (B, n_bins, 3)
        Jw = J * w[..., None]
        A = torch.einsum("...ji,...jk->...ik", Jw, J)
        g = torch.einsum("...ji,...j->...i", Jw, r)
        diag_scale = torch.diagonal(A, dim1=-2, dim2=-1).sum(-1)[..., None, None] / 3.0
        A_d = A + (lam_damp[..., None, None] * diag_scale + 1e-30) * eye
        delta = _solve3(A_d, g)
        nug_n = torch.clamp(nug + delta[..., 0], min=0.0)
        ps_n = torch.clamp(ps + delta[..., 1], min=1e-8)
        rg_n = torch.minimum(torch.clamp(rg + delta[..., 2], min=rng_lo), rng_hi)
        sse_n = sse_of(nug_n, ps_n, rg_n)
        improved = sse_n < sse
        nug = torch.where(improved, nug_n, nug)
        ps = torch.where(improved, ps_n, ps)
        rg = torch.where(improved, rg_n, rg)
        sse = torch.where(improved, sse_n, sse)
        lam_damp = torch.clamp(torch.where(improved, lam_damp * 0.5, lam_damp * 2.0),
                               1e-8, 1e8)
    return VariogramFit(nugget=nug, psill=ps, rng=rg, sse=sse, ok=fit_ok)


def _solve3(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve (B, 3, 3) systems by adjugate and determinant (a near-zero
    determinant is replaced by 1e-30)."""
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a10, a11, a12 = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    a20, a21, a22 = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    c00 = a11 * a22 - a12 * a21
    c01 = a02 * a21 - a01 * a22
    c02 = a01 * a12 - a02 * a11
    c10 = a12 * a20 - a10 * a22
    c11 = a00 * a22 - a02 * a20
    c12 = a02 * a10 - a00 * a12
    c20 = a10 * a21 - a11 * a20
    c21 = a01 * a20 - a00 * a21
    c22 = a00 * a11 - a01 * a10
    det = a00 * c00 + a01 * c10 + a02 * c20
    det = torch.where(torch.abs(det) > 1e-30, det, torch.full_like(det, 1e-30))
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    x0 = (c00 * b0 + c01 * b1 + c02 * b2) / det
    x1 = (c10 * b0 + c11 * b1 + c12 * b2) / det
    x2 = (c20 * b0 + c21 * b1 + c22 * b2) / det
    return torch.stack([x0, x1, x2], dim=-1)


def _first_valid(x: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    """x at the first ok bin (bin 0 where none is ok)."""
    n = x.shape[-1]
    pos = torch.arange(n, device=x.device)
    idx = torch.argmin(torch.where(ok, pos, torch.full_like(pos, n)), dim=-1)
    return torch.gather(x, -1, idx[..., None])[..., 0]


def _tail_mean(x: torch.Tensor, ok: torch.Tensor, frac: float = 0.5) -> torch.Tensor:
    """Mean of the ok bins from ``frac`` of the way on; the mean of all ok
    bins where the tail has none."""
    n = x.shape[-1]
    sel = ok & (torch.arange(n, device=x.device) >= int(n * frac))
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    s = torch.sum(torch.where(sel, x, zero), dim=-1)
    c = torch.sum(sel, dim=-1)
    full = torch.sum(torch.where(ok, x, zero), dim=-1) / torch.clamp(torch.sum(ok, dim=-1), min=1)
    return torch.where(c > 0, s / torch.clamp(c, min=1), full)
