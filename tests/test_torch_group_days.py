"""The month grouping of a station series on the device
(``topotpu_torch.interp.point.group_days_by_month_device``) against the
numpy grouping it stands in for, and the daily leave-one-out sweep that
groups with it against the same sweep grouping in numpy.

Both hold bit for bit: the grouping only moves values, and the pads are
zeros either way. The cases marked ``cuda`` skip without a CUDA device; this
file imports nothing of the JAX package, so on a machine with the card run
``python -m pytest tests/test_torch_group_days.py -m cuda --noconftest``.
"""

import types

import numpy as np
import pytest
import torch

from topotpu_torch.core.config import InterpParams
from topotpu_torch.interp import xval as txval
from topotpu_torch.interp.convert import to_tensor
from topotpu_torch.interp.point import (
    group_days_by_month,
    group_days_by_month_device,
    month_layout,
)
from topotpu_torch.io.synthetic import make_world, station_arrays_from_world


def _device(name):
    if name == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device(name)


def _layout():
    # 14 months from a leap-year January: two Januaries fill the 62 slots of
    # a month, so every other month has pad slots
    month_idx = (np.arange("2000-01-01", "2001-03-01", dtype="datetime64[D]")
                 .astype("datetime64[M]").astype(int) % 12)
    return month_layout(types.SimpleNamespace(month_idx=month_idx, ndays=len(month_idx)))


@pytest.mark.parametrize("case", [
    "float32", "read_only", "float64", "fortran_order", "tensor",
    pytest.param("cuda", marks=pytest.mark.cuda),
])
def test_device_grouping_equals_the_numpy_grouping(case):
    """(S, T) anomalies of each kind the callers hand over give, bit for bit,
    ``np.moveaxis(group_days_by_month(a, layout), 1, 0)`` of the float32
    series: a contiguous (12, S, dpm) float32 tensor on the device asked
    for, zeros in every pad slot, the caller's array left as it was."""
    device = _device("cuda" if case == "cuda" else "cpu")
    layout = _layout()
    S, T = 37, len(layout.month_idx)
    a = np.random.default_rng(3).normal(0.0, 3.0, (S, T))
    a = a if case == "float64" else a.astype(np.float32)
    if case == "read_only":
        a.flags.writeable = False  # as arrays handed over from JAX are
    elif case == "fortran_order":
        a = np.asfortranarray(a)
    before = a.copy()
    src = torch.from_numpy(a) if case == "tensor" else a

    got = group_days_by_month_device(src, layout, device)

    want = np.moveaxis(group_days_by_month(np.asarray(a, np.float32), layout), 1, 0)
    assert got.device.type == device.type and got.dtype == torch.float32
    assert got.shape == (12, S, layout.dpm) and got.is_contiguous()
    assert (~layout.day_valid).any()
    host = got.cpu().numpy()
    np.testing.assert_array_equal(host, want)
    assert not np.moveaxis(host, 1, 0)[:, ~layout.day_valid].any()  # (S, pads)
    np.testing.assert_array_equal(a, before)


@pytest.fixture(scope="module")
def st():
    world = make_world(np.random.default_rng(17), nrows=40, ncols=40, n_stations=90,
                       ndays=366, cellsize=1.0 / 30.0, vario=(0.05, 1.0, 160.0))
    return station_arrays_from_world(world, start="2016-01-01")


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_nnghs_anoms_sweep_equals_the_sweep_grouped_in_numpy(st, monkeypatch, device):
    """The anomaly sweep, grouping on the device, gives the MAEs, per-station
    MAEs and choices of the same sweep with the anomalies grouped in numpy
    and uploaded, bit for bit."""
    device = _device(device)
    regions = (st.lat > st.lat.mean()).astype(int)

    def sweep():
        return txval.optimize_nnghs_anoms(
            *st.krig(), st.anoms, st.month_idx, candidates=(8, 12, 16), region_labels=regions,
            base_params=InterpParams(k_neighbors=16), device=device)

    got = sweep()
    monkeypatch.setattr(txval, "group_days_by_month_device", lambda a, layout, dev: to_tensor(
        np.moveaxis(group_days_by_month(np.asarray(a, np.float32), layout), 1, 0), dev))
    want = sweep()
    assert got["best"] == want["best"]
    assert got["mae"] == want["mae"] and all(np.isfinite(list(want["mae"].values())))
    for ka, v in want["per_station_mae"].items():
        np.testing.assert_array_equal(got["per_station_mae"][ka], v)
