"""The hand-written CUDA kernels against their plain torch versions on the
card. Marked ``cuda``: they skip without a CUDA device (a CUDA kernel has no
CPU mode). Run them on a machine with the card with
``python -m pytest tests/test_torch_cuda_kernels.py -m cuda``.

Tolerances are those of the CPU parity tests: normal and trend rtol 1e-4,
atol 1e-3 (2e-3 above k = 32), variance rtol 1e-3 atol 1e-4, variogram and
gains rtol 1e-4 atol 1e-5, identical ok flags; the daily contraction rtol
and atol 1e-5; the OK solve's weights rtol 2e-4 atol 2e-5 (5e-5 above
k = 32), variance rtol 2e-3 atol 1e-4, identical ok flags and masked
weights exactly 0 (``tests/test_pallas_krig.py``'s).
"""

import numpy as np
import pytest
import torch

from topotpu.io.synthetic import make_world
from topotpu_torch.io.synthetic import krig_rows_from_world
from topotpu_torch.kernels.krig_normals import krig_normals_fused, krig_normals_fused_ref
from topotpu_torch.kernels.ok_solve_fused import (
    ok_solve_fused,
    ok_solve_fused_ref,
    ok_solve_fused_xyz,
    ok_solve_fused_xyz_ref,
)
from topotpu_torch.kernels.scatter_daily import scatter_daily, scatter_daily_ref

pytestmark = pytest.mark.cuda

ROW_NAMES = ("xyz3k", "dist_t", "mask_t", "covs_t", "cell_t", "norm_t",
             "vario_t", "acovs_t")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rows(dev, C, k, qa=3, seed=0):
    rng = np.random.default_rng(seed)
    world = make_world(rng, nrows=30, ncols=30, n_stations=80, ndays=30)
    rows, cols = rng.integers(0, 30, C), rng.integers(0, 30, C)
    r = krig_rows_from_world(world, rows, cols, min(k, 80), month=3)
    r["mask_t"][-1, ::5] = 0.0
    r["dist_t"] *= r["mask_t"]
    r["acovs_t"] = r["acovs_t"][: qa * k]
    return [torch.from_numpy(r[n]).to(dev) for n in ROW_NAMES]


@pytest.mark.parametrize("k, C, weight_kernel, qa", [
    (1, 37, "bisquare", 3), (16, 200, "gaussian", 2), (32, 1000, "uniform", 3),
    (33, 129, "bisquare", 0), (64, 513, "bisquare", 3),
])
def test_krig_normals_kernel_matches_plain(dev, k, C, weight_kernel, qa):
    rows = _rows(dev, C, k, qa)
    n0 = krig_normals_fused.launches
    got = krig_normals_fused(*rows, weight_kernel=weight_kernel)
    assert krig_normals_fused.launches == n0 + 1
    want = krig_normals_fused_ref(*rows, weight_kernel=weight_kernel)
    torch.cuda.synchronize()
    got, want = got.cpu().numpy(), want.cpu().numpy()
    np.testing.assert_array_equal(got[2], want[2])
    ok = want[2] > 0.5
    atol_n = 2e-3 if k > 32 else 1e-3
    for row in (0, 3):
        np.testing.assert_allclose(got[row, ok], want[row, ok], rtol=1e-4, atol=atol_n)
    np.testing.assert_allclose(got[1, ok], want[1, ok], rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(got[4:7], want[4:7], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got[8:, ok], want[8:, ok], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("C, S, k, D", [(1, 5, 1, 1), (1000, 96, 12, 31), (777, 512, 32, 2977)])
def test_scatter_daily_kernel_matches_plain(dev, C, S, k, D):
    rng = np.random.default_rng(1)
    idx = rng.integers(0, S, (k, C)).astype(np.int32)
    idx[min(1, k - 1)] = idx[0]
    planes = [
        torch.from_numpy(idx).to(dev),
        torch.from_numpy(rng.normal(size=(k, C)).astype(np.float32)).to(dev),
        torch.from_numpy((rng.uniform(size=(k, C)) > 0.1).astype(np.float32)).to(dev),
        torch.from_numpy(rng.normal(size=(S, D)).astype(np.float32)).to(dev),
    ]
    got = scatter_daily(*planes)
    want = scatter_daily_ref(*planes)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-5, atol=1e-5)


def _ok_inputs(dev, B, k, seed=2):
    """Batch-last OK-solve inputs from a synthetic world's neighbourhoods:
    (k, k, B) pair distances, (3k, B) xyz rows, (k, B) point distances and
    mask (the last slot of every 5th cell and all but two slots of cell 3
    masked), per-cell nugget, psill and range."""
    from topotpu_torch.geo.distance import pairwise_km_from_xyz

    rng = np.random.default_rng(seed)
    rows = _rows(dev, B, k, seed=seed)
    xyz3k, dist_t, mask_t = rows[0], rows[1], rows[2].clone()
    mask_t[2:, 3] = 0.0
    xyz = xyz3k.reshape(3, k, B).permute(2, 1, 0)
    dp = pairwise_km_from_xyz(xyz, xyz).permute(1, 2, 0).contiguous()
    par = [torch.from_numpy(rng.uniform(lo, hi, B).astype(np.float32)).to(dev)
           for lo, hi in ((0.01, 0.1), (0.5, 2.0), (30.0, 150.0))]
    return dp, xyz3k, (dist_t * mask_t).contiguous(), mask_t, par


@pytest.mark.parametrize("k, B", [(1, 37), (8, 300), (32, 1000), (33, 129), (64, 513)])
@pytest.mark.parametrize("xyz", [False, True], ids=["pair", "xyz"])
def test_ok_solve_kernel_matches_plain(dev, k, B, xyz):
    dp, xyz3k, dist_t, mask_t, par = _ok_inputs(dev, B, k)
    kern, plain = (ok_solve_fused_xyz, ok_solve_fused_xyz_ref) if xyz else \
        (ok_solve_fused, ok_solve_fused_ref)
    first = xyz3k if xyz else dp
    n0 = kern.launches
    w, var, ok = kern(first, dist_t, mask_t, *par)
    assert kern.launches == n0 + 1
    pw, pvar, pok = plain(first, dist_t, mask_t, *par)
    torch.cuda.synchronize()
    assert ok.dtype == torch.bool and w.shape == (k, B) and var.shape == (B,)
    np.testing.assert_array_equal(ok.cpu().numpy(), pok.cpu().numpy())
    np.testing.assert_allclose(w.cpu().numpy(), pw.cpu().numpy(), rtol=2e-4,
                               atol=5e-5 if k > 32 else 2e-5)
    np.testing.assert_allclose(var.cpu().numpy(), pvar.cpu().numpy(), rtol=2e-3, atol=1e-4)
    assert torch.all(w[mask_t < 0.5] == 0.0)


def test_wrappers_refuse_bad_inputs(dev):
    rows = _rows(dev, 64, 8)
    with pytest.raises(TypeError):
        krig_normals_fused(*(r.double() for r in rows))
    with pytest.raises(ValueError, match="contiguous"):
        bad = list(rows)
        bad[1] = rows[1].T.contiguous().T
        krig_normals_fused(*bad)
    with pytest.raises(ValueError, match="outside"):
        krig_normals_fused(*_rows(dev, 8, 65))
    dp, xyz3k, dist_t, mask_t, par = _ok_inputs(dev, 64, 8)
    with pytest.raises(TypeError):
        ok_solve_fused(dp, dist_t, mask_t.bool(), *par)
    with pytest.raises(ValueError, match="shape"):
        ok_solve_fused_xyz(dp, dist_t, mask_t, *par)
