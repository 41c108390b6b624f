"""``select_predictors``' device branch on the card with target rows: a share
of the stations ranked against the whole network, against float64 scores
computed on the host, at S = 2,400 stations and T = 2,200 days of seasonal
series. Marked ``cuda``: it skips without a CUDA device. Run it on a
machine with the card with
``python -m pytest tests/test_torch_cuda_infill.py -m cuda --noconftest``.

Tolerance: a chosen station that the float64 ranking would not choose must
score within 1e-4 (score units, |corr| + 1) of the n-th best float64 score;
the float32 grams' rounding parts near-ties by ~1e-6 at these lengths.
"""

import numpy as np
import pytest
import torch

from topotpu_torch.infill import pipeline

pytestmark = pytest.mark.cuda

TIE_MARGIN = 1e-4
S, T, N = 2400, 2200, 24


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def network():
    """Seasonal series with spatially loaded modes over a 10 x 10 degree
    box, 20 % missing at random, and 40 stations whose long outage leaves
    pairs under 30 joint days (the proximity fallback)."""
    rng = np.random.default_rng(11)
    lon = rng.uniform(-110.0, -100.0, S)
    lat = rng.uniform(35.0, 45.0, S)
    clon, clat = rng.uniform(-110.0, -100.0, 12), rng.uniform(35.0, 45.0, 12)
    load = np.exp(-np.hypot(lon[:, None] - clon, lat[:, None] - clat) / 3.0)
    modes = rng.standard_normal((12, T))
    season = 12.0 * np.cos(2 * np.pi * np.arange(T) / 365.25)[None, :]
    obs = season + load @ modes + 0.3 * rng.standard_normal((S, T))
    obs[rng.uniform(size=obs.shape) < 0.2] = np.nan
    obs[-40:, : T - 20] = np.nan
    return obs.astype(np.float32), lon, lat


def _standardised(obs, mask):
    mu = np.nanmean(np.where(mask, obs, np.nan), axis=1)
    sd = np.nanstd(np.where(mask, obs, np.nan), axis=1) + 1e-6
    return np.where(mask, (obs - mu[:, None]) / sd[:, None], 0.0).astype(np.float32)


def _scores64(xs, mask, lon, lat, t):
    """The targets' rows of the selection score in float64: |corr| + 1 over
    >= 30 jointly observed days, else 1e-4 / (1 + km); the target itself -1."""
    x, m = xs.astype(np.float64), mask.astype(np.float64)
    n = m[t] @ m.T
    sx, sy = x[t] @ m.T, m[t] @ x.T
    sxx, syy, sxy = (x[t] ** 2) @ m.T, m[t] @ (x ** 2).T, x[t] @ x.T
    sn = np.maximum(n, 1.0)
    cov = sxy / sn - (sx / sn) * (sy / sn)
    vx = np.maximum(sxx / sn - (sx / sn) ** 2, 1e-12)
    vy = np.maximum(syy / sn - (sy / sn) ** 2, 1e-12)
    score = np.abs(np.where(n < 30, 0.0, cov / np.sqrt(vx * vy)))
    p = np.deg2rad
    a = (np.sin((p(lat[None]) - p(lat[t][:, None])) / 2) ** 2 + np.cos(p(lat[t][:, None]))
         * np.cos(p(lat[None])) * np.sin((p(lon[None]) - p(lon[t][:, None])) / 2) ** 2)
    km = 2 * 6371.0087714 * np.arcsin(np.sqrt(np.clip(a, 0, 1)))
    score = np.where(score > 0, score + 1.0, 1e-4 / (1.0 + km))
    score[np.arange(len(t)), t] = -1.0
    return score


def _worst_outside(got, score):
    """The largest shortfall below the n-th best score of a chosen station."""
    nth = -np.sort(-score, axis=1)[:, got.shape[1] - 1]
    return float(max(0.0, (nth - np.take_along_axis(score, got.astype(np.int64), 1).min(1)).max()))


def test_device_select_predictors_target_rows_card(dev, network):
    obs, lon, lat = network
    mask = np.isfinite(obs)
    xs = _standardised(obs, mask)
    t = np.concatenate([np.arange(3, S - 40, 8), np.arange(S - 40, S, 4)])  # outages too
    lon32, lat32 = lon.astype(np.float32), lat.astype(np.float32)
    calls = pipeline._device_select_predictors.calls
    got = pipeline._device_select_predictors(xs, mask, lon32, lat32, True, N, dev, targets=t)
    whole = pipeline._device_select_predictors(xs, mask, lon32, lat32, True, N, dev)
    assert pipeline._device_select_predictors.calls == calls + 2
    assert got.shape == (len(t), N) and got.dtype == np.int32
    assert not (got == t[:, None]).any()
    assert all(len(set(r)) == N for r in got.tolist())
    score = _scores64(xs, mask, lon, lat, t)
    assert _worst_outside(got, score) < TIE_MARGIN
    assert _worst_outside(whole[t], score) < TIE_MARGIN
    # the outage stations fall back to proximity for most of their slots
    assert (np.take_along_axis(score[-10:], got[-10:].astype(np.int64), 1) < 1.0).any()
