"""Post-infill QA (the port's own copy of the JAX package's
``infill/post_infill.py``; numpy on the host).

After PPCA imputation, (a) imputed segments are variance-adjusted
(``topotpu_torch.stats.ppca.variance_adjust``), and (b) the infilled series
are scanned for changepoints introduced by imputation, with the C++ SNHT
binary-segmentation core of the homogenization stage
(``topotpu_torch.homog.pha``, built with ``g++`` at first use), and stations whose
imputed data manufactures a break are flagged BAD. This runs on the host.
"""

from __future__ import annotations

import numpy as np

from topotpu_torch.homog.pha import detect_breaks, monthly_means


def changepoint_flags(
    filled: np.ndarray,
    obs_mask: np.ndarray,
    year: np.ndarray,
    month: np.ndarray,
    imputed_frac_threshold: float = 0.5,
    minseg: int = 24,
) -> np.ndarray:
    """(S,) bool: True when an infilled series contains a changepoint whose
    adjacent segment is predominantly imputed (an imputation artifact).

    A break inside well-observed data is a climate or station signal (the
    homogenization stage's job); a break bordered by mostly imputed months
    means the imputation shifted the series level.
    """
    S, T = filled.shape
    monthly, keys = monthly_means(filled, year, month, min_days=1)
    M = monthly.shape[1]

    # month-level imputed fraction
    imp_frac = np.zeros((S, M), np.float32)
    mkeys = year * 12 + (month - 1)
    for i, k in enumerate(keys):
        sel = mkeys == k
        imp_frac[:, i] = 1.0 - obs_mask[:, sel].mean(axis=1)

    # de-season: subtract the station's monthly climatology
    cal = (keys % 12).astype(int)
    clim = np.zeros((S, 12), np.float32)
    for m in range(12):
        sel = cal == m
        clim[:, m] = np.nanmean(monthly[:, sel], axis=1)
    anom = monthly - clim[:, cal]

    breaks, _ = detect_breaks(anom, minseg=minseg)
    bad = np.zeros(S, bool)
    for s in range(S):
        for b in breaks[s]:
            if b < 0:
                continue
            lo = max(0, b - minseg)
            hi = min(M, b + minseg)
            before = imp_frac[s, lo:b].mean() if b > lo else 0.0
            after = imp_frac[s, b:hi].mean() if hi > b else 0.0
            if max(before, after) > imputed_frac_threshold:
                bad[s] = True
                break
    return bad
