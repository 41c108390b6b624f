"""Exponential variogram: model, empirical estimator, batched WLS fit (port of
``topotpu.stats.variogram``).

* empirical estimator: equal-width distance bins up to a cutoff, semivariance
  0.5 * mean (z_i - z_j)^2 per bin, with pair counts and mean bin distance
  (gstat's ``variogram``);
* fit: weighted least squares with gstat's fit.method = 7 weights
  (w_j = N_j / h_j^2), minimised by a damped Gauss-Newton loop whose damping
  adapts per batch element, batched over every station at once.

The model and the estimator are plain torch on the tensors' device (the JAX
package leaves them to XLA). The fit is ``kernels.variogram_fit``: on the
card one launch of a hand-written kernel for the batch and all its steps,
where the plain torch loop launches ~110 small kernels a step and its time
is the host's; on the CPU that plain loop.
"""

from __future__ import annotations

import torch

from topotpu_torch.kernels.variogram_fit import (
    EmpiricalVariogram,
    VariogramFit,
    variogram_fit,
)


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
    damping factor halves on improvement and doubles on failure, per element;
    every element runs all ``n_iters`` steps. On CUDA tensors one launch of
    the hand-written kernel fits the batch (float32; the operands are made
    contiguous first); on CPU tensors the plain loop
    ``kernels.variogram_fit.fit_exp_variogram_ref`` runs.
    """
    return variogram_fit(EmpiricalVariogram(*(t.contiguous() for t in emp)), n_iters, min_bins)
