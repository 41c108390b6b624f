"""Batched probabilistic-PCA imputation (EM) on torch tensors (port of
``topotpu.stats.ppca``).

    model: y_t = W z_t + c + eps,  eps ~ N(0, sigma^2 I)
    E-step:  Z = X W (W^T W + sigma^2 I)^-1
    M-step:  W <- S_xz S_zz^-1 ;  c, sigma^2 updated ;  missing X <- Z W^T + c

B independent target-station problems run at once as (B, T, V) tensors, on
the device of the tensors given. Convergence is decided per target: an
element whose relative change fell to ``tol`` is frozen (its state stops
changing and its iteration count stops), exactly as in the JAX package's
``lax.while_loop``. Here the loop is a Python loop; see ``ppca_impute`` for
how it stops.

Everything runs in float32 at full precision: ``topotpu_torch.core.device``
turns TF32 off (the JAX package pins ``Precision.HIGHEST``). The small
inverses and solves use the ``_ex`` forms, which do not check for singular
matrices: the check would cost a host sync per call, and the JAX package
does not raise either.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

# The stop test (any element still active?) reads one flag back to the host,
# which drains the launch queue; it runs every _CHECK_EVERY iterations. An
# iteration in which no element is active is an exact no-op, so the extra
# iterations change nothing, and the cap stays exact (the loop never runs
# more than max_iters iterations).
_CHECK_EVERY = 8


class PPCAResult(NamedTuple):
    filled: torch.Tensor     # (B, T, V) observed kept, missing imputed
    recon: torch.Tensor      # (B, T, V) full low-rank reconstruction + mean
    W: torch.Tensor          # (B, V, q) loadings
    mu: torch.Tensor         # (B, V) per-variable means
    sigma2: torch.Tensor     # (B,) noise variance
    n_iters: torch.Tensor    # (B,) int32 active EM iterations
    converged: torch.Tensor  # (B,) bool


def _masked_mean(Y, mask):
    n = mask.sum(dim=-2).to(Y.dtype) + 1e-30
    return torch.where(mask, Y, 0.0).sum(dim=-2) / n


def _init(Yc, m, q):
    """Deterministic init (W0 (B, V, q), sigma0^2 (B,)) in Yc's dtype: the
    top-q eigenvectors of the zero-filled covariance of the centred series
    ``Yc``, scaled by the root of their eigenvalues, and the mean of the
    other eigenvalues. ``m`` is the float observation mask.

    The covariance and its eigendecomposition are float64 (the JAX package
    runs them in float32). Daily temperatures keep their seasonal cycle, so
    the largest eigenvalue is ~1e3 times the ones at the q boundary, whose
    gaps can be ~1e-2 relative. In float32 on an H100 at config #3 the
    top-q subspace then lay ~5e-2 from the CPU's, and the EM, which is far
    from converged after 200 iterations, carried that into ~0.5 C of the
    imputed values (the float64 runs of both devices agreed within 2e-10).
    Signs of the eigenvectors are the solver's; the EM is invariant to them."""
    Y64 = Yc.double()
    counts = torch.einsum("btv,btw->bvw", m, m)  # exact: integers below 2^24
    cov = torch.einsum("btv,btw->bvw", Y64, Y64) / torch.clamp(counts.double(), min=1.0)
    evals, evecs = torch.linalg.eigh(cov)        # ascending
    scale = torch.sqrt(torch.clamp(evals[..., -q:], min=1e-6))
    W0 = evecs[..., -q:] * scale[..., None, :]
    sig0 = torch.clamp(evals[..., :-q].mean(dim=-1), min=1e-6)
    return W0.to(Yc.dtype), sig0.to(Yc.dtype)


def _em_step(X, W, c, sig2, T, eyeq):
    """One EM step from state (X, W, c, sig2): (recon, W, c, sig2)."""
    Xc = X - c[:, None, :]
    # E-step
    M = torch.einsum("bvq,bvr->bqr", W, W) + sig2[:, None, None] * eyeq
    Minv = torch.linalg.inv_ex(M).inverse
    Z = torch.einsum("btv,bvq->btq", Xc, W) @ Minv  # (B, T, q)
    # M-step
    Sxz = torch.einsum("btv,btq->bvq", Xc, Z)
    Szz = torch.einsum("btq,btr->bqr", Z, Z) + T * sig2[:, None, None] * Minv
    Wn = _solve_right(Sxz, Szz)
    low = torch.einsum("btq,bvq->btv", Z, Wn)
    cn = c + (Xc - low).mean(dim=-2)
    recon = low + cn[:, None, :]
    sig2n = torch.clamp((X - recon).square().mean(dim=(-2, -1)), min=1e-8)
    return recon, Wn, cn, sig2n


def ppca_impute(
    Y: torch.Tensor,
    obs_mask: torch.Tensor,
    n_components: int,
    max_iters: int = 200,
    tol: float = 1e-5,
) -> PPCAResult:
    """Impute missing entries of (B, T, V) series batches.

    Args:
      Y: observations; entries where ``obs_mask`` is False are ignored.
      obs_mask: (B, T, V) bool, True = observed.
      n_components: latent dimension q (< V).
      max_iters / tol: EM stopping, on the relative change of the imputed
        entries, per batch element.
    """
    B, T, V = Y.shape
    q = n_components
    if q >= V:
        raise ValueError(f"n_components {q} must be < n_variables {V}")
    dtype, dev = Y.dtype, Y.device
    m = obs_mask.to(dtype)

    mu = _masked_mean(Y, obs_mask)                       # (B, V)
    Yc = torch.where(obs_mask, Y - mu[:, None, :], 0.0)  # centred, missing = 0
    W, sig2 = _init(Yc, m, q)

    eyeq = torch.eye(q, dtype=dtype, device=dev)
    X, c = Yc, torch.zeros((B, V), dtype=dtype, device=dev)
    delta = torch.full((B,), float("inf"), dtype=dtype, device=dev)
    n_it = torch.zeros((B,), dtype=torch.int32, device=dev)
    for it in range(max_iters):
        active = delta > tol                              # (B,)
        any_active = active.any()
        if it % _CHECK_EVERY == 0 and not bool(any_active):
            break
        recon, Wn, cn, sig2n = _em_step(X, W, c, sig2, T, eyeq)
        Xn = torch.where(obs_mask, Yc, recon)
        a3 = active[:, None, None]
        Xn = torch.where(a3, Xn, X)
        W = torch.where(a3, Wn, W)
        c = torch.where(active[:, None], cn, c)
        sig2 = torch.where(active, sig2n, sig2)
        num = torch.sqrt((Xn - X).square().mean(dim=(-2, -1)))
        den = torch.sqrt(Xn.square().mean(dim=(-2, -1)) + 1e-12)
        # a frozen element's delta goes to 0 as in the JAX loop, but only in
        # an iteration that loop would have run (some element active)
        delta = torch.where(active, num / den, torch.where(any_active, 0.0, delta))
        n_it = n_it + active.to(torch.int32)
        X = Xn

    recon, W, c, sig2 = _em_step(X, W, c, sig2, T, eyeq)
    recon_full = recon + mu[:, None, :]
    return PPCAResult(
        filled=torch.where(obs_mask, Y, recon_full),
        recon=recon_full,
        W=W,
        mu=mu + c,
        sigma2=sig2,
        n_iters=n_it,
        converged=delta <= tol,
    )


def _solve_right(Sxz, Szz):
    """W = Sxz Szz^-1 for (B, V, q) x (B, q, q)."""
    return torch.linalg.solve_ex(Szz, Sxz.transpose(-1, -2)).result.transpose(-1, -2)


def variance_adjust(
    filled: torch.Tensor,
    obs_mask: torch.Tensor,
    month_idx: torch.Tensor,
    n_months: int = 12,
) -> torch.Tensor:
    """Rescale imputed values so each month's variance matches the observed
    variance (the post-infill variance adjustment of the reference).

    Args:
      filled: (B, T) target-station series (observed + imputed entries).
      obs_mask: (B, T) True where the entry was actually observed.
      month_idx: (T,) 0..11 calendar month of each timestep.
    """
    out = filled
    for mth in range(n_months):
        in_m = month_idx == mth
        sel_obs = in_m[None, :] & obs_mask
        sel_imp = in_m[None, :] & ~obs_mask
        n_obs = sel_obs.sum(dim=1)
        n_imp = sel_imp.sum(dim=1)

        mean_obs = torch.where(sel_obs, filled, 0.0).sum(dim=1) / torch.clamp(n_obs, min=1)
        var_obs = torch.where(sel_obs, (filled - mean_obs[:, None]).square(), 0.0).sum(
            dim=1) / torch.clamp(n_obs - 1, min=1)
        mean_imp = torch.where(sel_imp, filled, 0.0).sum(dim=1) / torch.clamp(n_imp, min=1)
        var_imp = torch.where(sel_imp, (filled - mean_imp[:, None]).square(), 0.0).sum(
            dim=1) / torch.clamp(n_imp - 1, min=1)

        # only rescale when both sides have enough support
        good = (n_obs > 10) & (n_imp > 2) & (var_imp > 1e-8)
        ratio = torch.sqrt(torch.where(good, var_obs / torch.clamp(var_imp, min=1e-8), 1.0))
        ratio = torch.clamp(ratio, 0.25, 4.0)
        adj = mean_imp[:, None] + (filled - mean_imp[:, None]) * ratio[:, None]
        out = torch.where(sel_imp, adj, out)
    return out
