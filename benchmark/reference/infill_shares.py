"""What the plain reference of the share cell (``network.infill-span``) adds
to ``reference/infill.py``, whose scores, selection rule and EM it uses as
they are: the targets of a share are scored against every station of the
network, so a predictor set confined to a part of it shows as a shortfall.

* ``shortfall``: how far the predictors chosen fall below the n-th best
  float64 score of their target, the reading that a selection's tie margin
  is set from (0 where every chosen station is among the n best).
"""

from __future__ import annotations

import numpy as np


def shortfall(score: np.ndarray, chosen: np.ndarray) -> float:
    """The largest amount by which a ``chosen`` predictor's ``score`` (B, S)
    lies below the n-th best score of its row (n = ``chosen.shape[1]``), or
    0.0."""
    nth = -np.sort(-score, axis=1)[:, chosen.shape[1] - 1]
    worst = np.take_along_axis(score, chosen.astype(np.int64), axis=1).min(axis=1)
    return float(max(0.0, (nth - worst).max()))
