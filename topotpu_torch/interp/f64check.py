"""float64 end-to-end validation mode (port of ``topotpu.interp.f64check``).

The production path is float32 with nugget+jitter conditioning; kriging
systems go ill-conditioned when the fitted nugget approaches zero and the
correlation range dwarfs the neighborhood window (all neighbors nearly
perfectly correlated -> covariance matrix nearly singular). Per-kernel f64
parity lives in the numpy oracles (``topotpu_torch/oracle/``); this module
closes the loop END-TO-END: run the complete tile path (neighbor selection
-> GWR trend -> variogram-param interpolation -> kriging solve -> daily GWR)
in float64 and quantify the float32 error against it.

The float64 side runs on the CPU, where the kernel wrappers take their plain
torch versions: the CUDA kernels are float32 only, and no float64 tensor
reaches them. The float32 side runs on the caller's ``device``; on a GPU
that is the production path, one ``krig_normals_indexed`` launch and one
``scatter_daily`` launch a call.

Parity framing: the reference did everything in float64 (numpy/R defaults),
so "f32 vs f64 end-to-end" IS "rebuild vs reference numerics" for the solve
chain; the BASELINE bar is 0.05 C RMSE.
"""

from __future__ import annotations

import numpy as np
import torch

from topotpu_torch.core.config import InterpParams
from topotpu_torch.interp.convert import tile_inputs_from_numpy
from topotpu_torch.interp.point import TileInputs, TileResult, interp_tile


def _shared_validity(ti: TileInputs) -> bool:
    """Every station usable in every month or in none: one neighbourhood
    serves all 12 months (as ``TileEngine`` decides it)."""
    valid = np.asarray(ti.stn_valid.cpu() if isinstance(ti.stn_valid, torch.Tensor)
                       else ti.stn_valid)
    return bool(np.all(valid == valid[:, :1]))


def run_tile_f64(ti: TileInputs, params: InterpParams) -> TileResult:
    """The full tile interpolation in float64 on the CPU, returned as numpy.

    ``ti``'s fields may be tensors on any device or numpy arrays; the float
    fields are cast to float64 on the CPU, where every kernel wrapper runs
    its plain version. Everything else — including neighbor selection and
    the kriging solve — is the same code the device runs.
    """
    ti64 = tile_inputs_from_numpy(ti, torch.device("cpu"), torch.float64)
    res = interp_tile(ti64, params, shared_validity=_shared_validity(ti))
    return TileResult(*(v.numpy() for v in res))


def compare_f32_f64(
    ti: TileInputs, params: InterpParams, day_valid=None, *, device: torch.device | str
) -> dict:
    """Run the tile path at f32 on ``device`` and at f64 on the CPU and
    report error statistics.

    Only cells both paths mark ok are compared (conditioning differences can
    legitimately flip min_neighbors/solve-failure flags on the boundary; the
    flip rate is reported separately).

    ``day_valid``: the MonthLayout's (12, dpm) real-day mask. Padded month
    slots carry daily = normal + zero anomaly on BOTH paths, so including
    them (the default when the layout is unknown) dilutes the daily RMSE
    toward the smaller normals error — pass the mask whenever the calendar
    is available so the 0.05 C parity bar judges real days only."""
    shared = _shared_validity(ti)
    f32 = interp_tile(tile_inputs_from_numpy(ti, device, torch.float32), params,
                      shared_validity=shared)
    f32 = TileResult(*(v.cpu().numpy() for v in f32))
    f64 = run_tile_f64(ti, params)

    ok32 = f32.ok
    ok64 = f64.ok
    both = ok32 & ok64

    def stats(a, b, mask):
        a = np.asarray(a, np.float64)
        b = np.asarray(b, np.float64)
        d = (a - b)[mask]
        if d.size == 0:
            return {"rmse": 0.0, "max": 0.0}
        return {
            "rmse": float(np.sqrt((d**2).mean())),
            "max": float(np.abs(d).max()),
        }

    dshape = f32.daily.shape  # (12, C, dpm)
    if day_valid is not None:
        dmask = both[:, :, None] & np.asarray(day_valid)[:, None, :]
    else:
        dmask = both[:, :, None] & np.ones(dshape, bool)
    return {
        "normal": stats(f32.normal, f64.normal, both),
        "se": stats(f32.se, f64.se, both),
        "daily": stats(f32.daily, f64.daily, dmask),
        "ok_flip_rate": float((ok32 != ok64).mean()),
        "n_compared": int(both.sum()),
    }
