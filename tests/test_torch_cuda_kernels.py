"""The hand-written CUDA kernels against their plain torch versions on the
card. Marked ``cuda``: they skip without a CUDA device (a CUDA kernel has no
CPU mode). Run them on a machine with the card with
``python -m pytest tests/test_torch_cuda_kernels.py -m cuda --noconftest``.
This file imports nothing of the JAX package.

Tolerances are those of the CPU parity tests: normal and trend rtol 1e-4,
atol 1e-3 (2e-3 above k = 32), variance rtol 1e-3 atol 1e-4, variogram and
gains rtol 1e-4 atol 1e-5, identical ok flags; the daily contraction rtol
and atol 1e-5, its packed entry by the integer rule (identical sentinels, at
most one int16 count apart, under 1 % of counts differing); the OK solve's weights rtol 2e-4 atol 2e-5 (5e-5 above
k = 32), variance rtol 2e-3 atol 1e-4, identical ok flags and masked
weights exactly 0 (``tests/test_pallas_krig.py``'s).
"""

import numpy as np
import pytest
import torch

from topotpu_torch.core.dates import get_days_metadata
from topotpu_torch.interp.point import VarFields, tile_neighborhoods, tile_tables
from topotpu_torch.io.synthetic import krig_rows_from_world, make_world, tile_inputs_from_world
from topotpu_torch.kernels.krig_normals import krig_normals_indexed, krig_normals_indexed_ref
from topotpu_torch.kernels.ok_solve_fused import (
    ok_solve_fused,
    ok_solve_fused_ref,
    ok_solve_fused_xyz,
    ok_solve_fused_xyz_ref,
)
from topotpu_torch.kernels.scatter_daily import (
    scatter_daily,
    scatter_daily_packed,
    scatter_daily_packed_ref,
    scatter_daily_ref,
)

pytestmark = pytest.mark.cuda

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rows(dev, C, k, seed=0):
    """xyz3k (3k, C), dist_t and mask_t (k, C) of C cells of a synthetic
    world; the last slot of every 5th cell is masked."""
    rng = np.random.default_rng(seed)
    world = make_world(rng, nrows=30, ncols=30, n_stations=80, ndays=30)
    rows, cols = rng.integers(0, 30, C), rng.integers(0, 30, C)
    r = krig_rows_from_world(world, rows, cols, min(k, 80))
    r["mask_t"][-1, ::5] = 0.0
    r["dist_t"] *= r["mask_t"]
    return [torch.from_numpy(r[n]).to(dev) for n in ("xyz3k", "dist_t", "mask_t")]


def _indexed(dev, C, k, per_month, seed=0):
    """Indexed-entry arguments for C cells of a synthetic world with two
    variables, from the tile step's own functions; the last slot of every 5th
    cell is masked and cell 3 keeps two valid slots."""
    rng = np.random.default_rng(seed)
    world = make_world(rng, nrows=30, ncols=30, n_stations=80, ndays=31)
    days = get_days_metadata("2015-01-01", "2015-01-31")
    rows, cols = rng.integers(0, 30, C), rng.integers(0, 30, C)
    ti, _ = tile_inputs_from_world(world, days.month_idx, rows, cols, dev)
    if per_month:
        valid = ti.stn_valid.clone()
        for m in range(12):
            valid[5 + m, m] = False
        ti = ti._replace(stn_valid=valid)
    b = VarFields(ti.stn_norm + 9.0, ti.stn_vario * 1.1, ti.stn_anoms)
    table, cell = tile_tables(ti, (VarFields(ti.stn_norm, ti.stn_vario, ti.stn_anoms), b))
    nbrs = tile_neighborhoods(ti, k, not per_month)
    idx, dist, mask = (torch.stack([getattr(n, f) for n in nbrs])
                       for f in ("idx", "dist", "mask"))
    mask[:, ::5, -1] = False
    if C > 3:
        mask[:, 3, 2:] = False
    return idx, dist * mask, mask, table, cell


@pytest.mark.parametrize("k, C, per_month, weight_kernel", [
    (1, 37, False, "bisquare"), (8, 300, True, "gaussian"), (32, 1000, False, "bisquare"),
    (32, 513, True, "uniform"), (33, 129, False, "bisquare"), (64, 257, True, "bisquare"),
])
def test_krig_normals_indexed_kernel_matches_plain(dev, k, C, per_month, weight_kernel):
    args = _indexed(dev, C, k, per_month)
    pairs = [(m, v) for m in range(12) for v in range(2)]
    n0 = krig_normals_indexed.launches
    head, gains = krig_normals_indexed(*args, pairs, not per_month, weight_kernel=weight_kernel)
    assert krig_normals_indexed.launches == n0 + 1  # one launch for the 24 systems
    whead, wgains = krig_normals_indexed_ref(*args, pairs, not per_month,
                                             weight_kernel=weight_kernel)
    torch.cuda.synchronize()
    assert head.shape == (24, C, 8) and gains.shape == (12 if per_month else 1, C, k)
    idx, dist, mask, table, cell = args
    h64, g64 = krig_normals_indexed_ref(idx, dist.double(), mask, table.double(), cell.double(),
                                        pairs, not per_month, weight_kernel=weight_kernel)
    head, gains, whead, wgains, h64, g64 = (
        t.cpu().numpy() for t in (head, gains, whead, wgains, h64, g64))
    np.testing.assert_array_equal(head[..., 2], whead[..., 2])
    ok = whead[..., 2] > 0.5
    cell_ok = ok.reshape(12, 2, C).all(1) if per_month else ok.all(0)[None]
    atol_n = 2e-3 if k > 32 else 1e-3

    def close(got, want, ref, rtol, atol):
        """Within the parity tolerance; below k = 16, where the float32 trend
        design is too ill-conditioned for that (two float32 runs part by up
        to 0.1 C), a float64 run of the plain version decides instead: the
        kernel's mean and 95th-percentile distance from it are at most twice
        the plain version's plus the parity atol, and no value parts from the
        plain version by more than 0.1."""
        if k >= 16 or got.size == 0:
            np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)
            return
        d_kern, d_plain = np.abs(got - ref), np.abs(want - ref)
        for stat in (np.mean, lambda a: np.quantile(a, 0.95)):
            assert stat(d_kern) <= 2 * stat(d_plain) + atol, (stat(d_kern), stat(d_plain))
        assert np.abs(got - want).max() <= 0.1

    for col in (0, 3):
        close(head[..., col][ok], whead[..., col][ok], h64[..., col][ok], 1e-4, atol_n)
    np.testing.assert_allclose(head[..., 1][ok], whead[..., 1][ok], rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(head[..., 4:7], whead[..., 4:7], rtol=1e-4, atol=1e-5)
    close(gains[cell_ok], wgains[cell_ok], g64[cell_ok], 1e-4, 1e-5)
    assert (gains[~mask.cpu().numpy()] == 0.0).all()
    # int32 indices and a single system give the same bits
    head32, _ = krig_normals_indexed(args[0].int(), *args[1:], pairs[5:6], not per_month,
                                     weight_kernel=weight_kernel)
    np.testing.assert_array_equal(head32.cpu().numpy()[0], head[5])


@pytest.mark.parametrize("k, C, weight_kernel", [
    (1, 37, "bisquare"), (16, 200, "gaussian"), (32, 1000, "uniform"),
    (33, 129, "bisquare"), (64, 513, "bisquare"),
])
def test_krig_normals_kernel_matches_plain(dev, k, C, weight_kernel):
    """One system in a launch of its own (a single call's case)."""
    args = _indexed(dev, C, k, False, seed=1)
    n0 = krig_normals_indexed.launches
    head, gains = krig_normals_indexed(*args, [(3, 1)], True, weight_kernel=weight_kernel)
    assert krig_normals_indexed.launches == n0 + 1
    whead, wgains = krig_normals_indexed_ref(*args, [(3, 1)], True, weight_kernel=weight_kernel)
    torch.cuda.synchronize()
    head, gains, whead, wgains = (t[0].cpu().numpy() for t in (head, gains, whead, wgains))
    np.testing.assert_array_equal(head[:, 2], whead[:, 2])
    ok = whead[:, 2] > 0.5
    atol_n = 2e-3 if k > 32 else 1e-3
    for col in (0, 3):
        np.testing.assert_allclose(head[ok, col], whead[ok, col], rtol=1e-4, atol=atol_n)
    np.testing.assert_allclose(head[ok, 1], whead[ok, 1], rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(head[:, 4:7], whead[:, 4:7], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(gains[ok], wgains[ok], rtol=1e-4, atol=1e-5)


def test_krig_normals_indexed_masked_stray_index_is_inert(dev):
    """The kernel clamps an index outside the table instead of reading
    there. In a masked slot the clamped row is inert: the same bits as with
    any valid index in that slot. In a valid slot the system is solved with
    the first or last row, as the plain version solves it."""
    idx, dist, mask, table, cell = _indexed(dev, 200, 16, False)
    pairs = [(0, 0), (6, 1)]
    want = krig_normals_indexed(idx, dist, mask, table, cell, pairs, True)
    stray = idx.clone()
    stray[~mask] = table.shape[0] + 7
    stray[0, 3, 2:] = -1  # cell 3 keeps two valid slots
    got = krig_normals_indexed(stray, dist, mask, table, cell, pairs, True)
    assert int((~mask).sum()) > 0
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)

    S = table.shape[0]
    stray[0, ::4, 1] = -1  # unmasked slots
    stray[0, 1::4, 5] = S
    stray[0, 2::4, 9] = S + 7
    assert int((((stray < 0) | (stray >= S)) & mask).sum()) > 100
    head, gains = krig_normals_indexed(stray, dist, mask, table, cell, pairs, True)
    for s_idx in (stray, stray.clamp(0, S - 1)):
        whead, wgains = krig_normals_indexed_ref(s_idx, dist, mask, table, cell, pairs, True)
        torch.testing.assert_close(head[..., 2], whead[..., 2], rtol=0, atol=0)
        ok = whead[..., 2] > 0.5
        for col, rtol, atol in ((0, 1e-4, 1e-3), (3, 1e-4, 1e-3), (1, 1e-3, 1e-4)):
            torch.testing.assert_close(head[..., col][ok], whead[..., col][ok],
                                       rtol=rtol, atol=atol)
        torch.testing.assert_close(gains[0][ok.all(0)], wgains[0][ok.all(0)],
                                   rtol=1e-4, atol=1e-5)
    assert not torch.equal(torch.nan_to_num(head), torch.nan_to_num(want[0]))


def _scatter_case(dev, C, S, k, D, i64, seed=1):
    """(idx, gains, mask, Y) on the card with duplicate and stray indices."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, S, (C, k)).astype(np.int64 if i64 else np.int32)
    idx[:, min(1, k - 1)] = idx[:, 0]
    idx[::5, 0] = -1
    idx[1::7, k - 1] = S
    idx[2::9, k // 2] = S + 7
    return [
        torch.from_numpy(idx).to(dev),
        torch.from_numpy(rng.normal(size=(C, k)).astype(np.float32)).to(dev),
        torch.from_numpy(rng.uniform(size=(C, k)) > 0.1).to(dev),
        torch.from_numpy(rng.normal(size=(S, D)).astype(np.float32)).to(dev),
    ]


@pytest.mark.parametrize("C, S, k, D, i64", [
    (1, 5, 1, 1, False), (1000, 96, 12, 31, True), (777, 512, 32, 2977, False),
    (777, 512, 32, 2976, True), (130, 5, 64, 744, False), (65, 9, 3, 6, True),
])
def test_scatter_daily_kernel_matches_plain(dev, C, S, k, D, i64):
    args = _scatter_case(dev, C, S, k, D, i64)
    n0 = scatter_daily.launches
    got = scatter_daily(*args)
    assert scatter_daily.launches == n0 + 1
    want = scatter_daily_ref(*args)
    torch.cuda.synchronize()
    assert got.shape == (C, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-5, atol=1e-5)
    # a stray index adds nothing: the same bits as with that slot masked
    idx, gains, mask, Y = args
    stray = (idx < 0) | (idx >= S)
    masked = scatter_daily(idx.clamp(0, S - 1), gains, mask & ~stray, Y)
    assert torch.equal(got, masked)


def _packed_case(dev, C, S, k, dpm, ndays, N, G, V, i64, seed=2):
    """Packed-entry arguments on the card: duplicate and stray indices, masked
    slots, not-ok cells, pad slots, a second variable that crosses the first,
    one lattice for both (so a reconciled pair lands on one point)."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, S, (N, C, k)).astype(np.int64 if i64 else np.int32)
    idx[..., min(1, k - 1)] = idx[..., 0]
    idx[:, ::5, 0] = -1
    idx[:, 1::7, k - 1] = S + 3
    gains = (rng.normal(size=(G, N, C, k)) * 0.3).astype(np.float32)
    mask = rng.uniform(size=(N, C, k)) > 0.1
    Y = (rng.normal(size=(V, S, 12 * dpm)) * 3.0).astype(np.float32)
    normal = (rng.normal(size=(V, 12, C)) * 5.0 + 10.0).astype(np.float32)
    if V == 2:
        normal[1] = normal[0] + 0.3
    normal[0, :, 0] = 1.0e4  # clips
    ok = rng.uniform(size=(V, 12, C)) > 0.15
    ok[0, :, 0] = True
    month = np.arange(ndays) * 12 // ndays  # months of unequal length, none over dpm
    pos = np.zeros(12, int)
    slot = np.empty(ndays, np.int32)
    for t, m in enumerate(month):
        slot[t] = m * dpm + pos[m]
        pos[m] += 1
    scales = np.tile(np.array([[160.0 / 65500.0, 10.0]], np.float32), (V, 1))
    return [torch.from_numpy(a).to(dev)
            for a in (idx, mask, gains, Y, normal, ok, slot, scales)]


@pytest.mark.parametrize("C, S, k, dpm, ndays, N, G, V, i64", [
    (1, 5, 1, 1, 12, 1, 1, 1, False), (777, 512, 32, 31, 365, 1, 1, 2, True),
    (777, 512, 32, 28, 300, 12, 2, 2, False), (130, 5, 7, 124, 1461, 12, 1, 2, True),
    (64, 40, 16, 31, 365, 1, 2, 2, False), (999, 96, 12, 124, 1461, 1, 1, 1, True),
    (333, 96, 64, 29, 340, 12, 1, 1, False),
])
def test_scatter_daily_packed_kernel_matches_plain(dev, C, S, k, dpm, ndays, N, G, V, i64):
    args = _packed_case(dev, C, S, k, dpm, ndays, N, G, V, i64)
    for reconcile in ((False, True) if V == 2 else (False,)):
        fill = 12345
        got = torch.full((V * (ndays + 24), C), fill, dtype=torch.int16, device=dev)
        want = got.clone()
        n0 = scatter_daily_packed.launches
        assert scatter_daily_packed(*args, got, reconcile=reconcile) is got
        assert scatter_daily_packed.launches == n0 + 1
        scatter_daily_packed_ref(*args, want, reconcile=reconcile)
        torch.cuda.synchronize()
        g = got.cpu().numpy().astype(np.int64).reshape(V, ndays + 24, C)
        w = want.cpu().numpy().astype(np.int64).reshape(V, ndays + 24, C)
        assert (g[:, ndays:] == fill).all()  # normal and se rows are not touched
        g, w = g[:, :ndays], w[:, :ndays]
        assert not (w == fill).any()
        np.testing.assert_array_equal(g == -32768, w == -32768)
        assert (w == 32767).any() and (C == 1 or (w == -32768).any())
        assert np.abs(g - w).max() <= 1
        assert np.mean(g != w) < 0.01
        if reconcile:
            both = (g[0] != -32768) & (g[1] != -32768)
            assert both.any() and not np.any(both & (g[1] < g[0]))


def test_scatter_wrappers_refuse_bad_inputs(dev):
    idx, gains, mask, Y = _scatter_case(dev, 64, 20, 8, 31, False)
    with pytest.raises(TypeError):
        scatter_daily(idx, gains, mask.float(), Y)
    with pytest.raises(TypeError):
        scatter_daily(idx.short(), gains, mask, Y)
    with pytest.raises(TypeError):
        scatter_daily(idx, gains.double(), mask, Y)
    with pytest.raises(ValueError, match="shape"):
        scatter_daily(idx, gains[:, :7], mask, Y)
    with pytest.raises(ValueError, match="contiguous"):
        scatter_daily(idx, gains, mask, Y.T.contiguous().T)
    with pytest.raises(ValueError, match="devices"):
        scatter_daily(idx, gains, mask, Y.cpu())
    names = ("idx", "mask", "gains", "Y", "normal", "ok", "slot_of_day", "scales")
    a = dict(zip(names, _packed_case(dev, 64, 20, 8, 31, 365, 1, 1, 2, False)))
    out = torch.empty((2 * (365 + 24), 64), dtype=torch.int16, device=dev)

    def call(out=out, **swap):
        return scatter_daily_packed(*({**a, **swap}[n] for n in names), out)

    with pytest.raises(TypeError):
        call(slot_of_day=a["slot_of_day"].long())
    with pytest.raises(TypeError):
        call(ok=a["ok"].float())
    with pytest.raises(TypeError):
        call(out=out.int())
    with pytest.raises(TypeError):
        call(mask=a["mask"].to(torch.uint8))
    with pytest.raises(ValueError, match="shape"):
        call(out=out[:-1])
    with pytest.raises(ValueError, match="contiguous"):
        call(normal=a["normal"].transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(ValueError, match="devices"):
        call(scales=a["scales"].cpu())


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
    idx, dist, mask, table, cell = _indexed(dev, 64, 8, False)
    with pytest.raises(TypeError):
        krig_normals_indexed(idx, dist.double(), mask, table, cell, [(0, 0)], True)
    with pytest.raises(ValueError, match="outside"):
        krig_normals_indexed(*(a.repeat(1, 1, 9)[..., :65].contiguous()
                               for a in (idx, dist, mask)), table, cell, [(0, 0)], True)
    with pytest.raises(TypeError):
        krig_normals_indexed(idx, dist, mask.float(), table, cell, [(0, 0)], True)
    with pytest.raises(TypeError):
        krig_normals_indexed(idx.short(), dist, mask, table, cell, [(0, 0)], True)
    with pytest.raises(ValueError, match="contiguous"):
        krig_normals_indexed(idx, dist, mask, table.T.contiguous().T, cell, [(0, 0)], True)
    with pytest.raises(ValueError, match="devices"):
        krig_normals_indexed(idx, dist, mask, table.cpu(), cell, [(0, 0)], True)
    dp, xyz3k, dist_t, mask_t, par = _ok_inputs(dev, 64, 8)
    with pytest.raises(TypeError):
        ok_solve_fused(dp, dist_t, mask_t.bool(), *par)
    with pytest.raises(ValueError, match="shape"):
        ok_solve_fused_xyz(dp, dist_t, mask_t, *par)
