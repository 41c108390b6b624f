"""The hand-written CUDA kernels against their plain torch versions on the
card. Marked ``cuda``: they skip without a CUDA device (a CUDA kernel has no
CPU mode). Run them on a machine with the card with
``python -m pytest tests/test_torch_cuda_kernels.py -m cuda --noconftest``.
This file imports nothing of the JAX package.

Tolerances are those of the CPU parity tests: normal and trend rtol 1e-4,
atol 1e-3 (2e-3 above k = 32), variance rtol 1e-3 atol 1e-4, variogram and
gains rtol 1e-4 atol 1e-5, identical ok flags (below k = 16, and for the
gathered entry's trend on five LST months, a float64 run of the plain
version decides); the daily contraction rtol
and atol 1e-5, its packed entry by the integer rule (identical sentinels, at
most one int16 count apart, under 1 % of counts differing); the OK solve's weights rtol 2e-4 atol 2e-5 (5e-5 above
k = 32), variance rtol 2e-3 atol 1e-4, identical ok flags and masked
weights exactly 0 (``tests/test_pallas_krig.py``'s).

The variogram fit: identical ok flags; after 0 or 1 Gauss-Newton steps the
nugget and psill within 1e-5 of the sill, the range within rtol 1e-5 and the
SSE within 1e-5 of the squared sill (the scale of each; a small nugget's own
relative error after one step is the solve's conditioning times float32
rounding). After 50 steps ``tests/test_torch_variogram.py``'s bar (curves
within 1e-3 of the sill, weighted SSEs within 1 %), held by count against a
float64 run of the plain version: a step accepted or rejected on near-equal
SSEs sends a fit elsewhere along a flat valley of the SSE, so sums taken in
another order part a few fits in a thousand from the plain version's, as
float64 arithmetic parts them (see ``test_variogram_fit_kernel_matches_plain``).
"""

import numpy as np
import pytest
import torch

from topotpu_torch.core.config import InterpParams, VariogramParams
from topotpu_torch.core.dates import get_days_metadata
from topotpu_torch.interp import params as tparams
from topotpu_torch.interp.point import VarFields, tile_neighborhoods, tile_tables
from topotpu_torch.io.synthetic import (
    krig_rows_from_world,
    make_world,
    station_arrays_from_world,
    tile_inputs_from_world,
)
from topotpu_torch.kernels import _build
from topotpu_torch.kernels import krig_normals as kn
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
from topotpu_torch.kernels.variogram_fit import fit_exp_variogram_ref, variogram_fit
from topotpu_torch.stats.variogram import EmpiricalVariogram
from variogram_cases import fits_apart, synthetic_emp

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


@pytest.mark.parametrize("k, C, per_month, weight_kernel, k_normal, k_anom", [
    (1, 37, False, "bisquare", None, None), (8, 300, True, "gaussian", None, None),
    (32, 1000, False, "bisquare", None, None), (32, 513, True, "uniform", None, None),
    (33, 129, False, "bisquare", None, None), (64, 257, True, "bisquare", None, None),
    (32, 513, True, "uniform", 24, 24), (32, 513, True, "gaussian", 32, 8),
    (16, 300, True, "bisquare", 12, 16), (32, 1000, False, "bisquare", 12, 16),
])
def test_krig_normals_indexed_kernel_matches_plain(dev, k, C, per_month, weight_kernel,
                                                   k_normal, k_anom):
    """Kernel against plain version, the systems on the first ``k_normal``
    slots and the gain rows on the first ``k_anom``; and the two sizes give
    the bits of a call at the full sizes on the mask cut at each."""
    args = _indexed(dev, C, k, per_month)
    pairs = [(m, v) for m in range(12) for v in range(2)]
    kw = dict(weight_kernel=weight_kernel, k_normal=k_normal, k_anom=k_anom)
    n0 = krig_normals_indexed.launches
    head, gains = krig_normals_indexed(*args, pairs, not per_month, **kw)
    assert krig_normals_indexed.launches == n0 + 1  # one launch for the 24 systems
    whead, wgains = krig_normals_indexed_ref(*args, pairs, not per_month, **kw)
    torch.cuda.synchronize()
    assert head.shape == (24, C, 8) and gains.shape == (12 if per_month else 1, C, k)
    idx, dist, mask, table, cell = args
    kn_, ka = k_normal or k, k_anom or k
    slots = torch.arange(k, device=dev)
    cut = lambda size: krig_normals_indexed(  # noqa: E731
        idx, dist, mask & (slots < size), table, cell, pairs, not per_month,
        weight_kernel=weight_kernel)
    torch.testing.assert_close(head, cut(kn_)[0], rtol=0, atol=0, equal_nan=True)
    torch.testing.assert_close(gains, cut(ka)[1], rtol=0, atol=0, equal_nan=True)
    h64, g64 = krig_normals_indexed_ref(idx, dist.double(), mask, table.double(), cell.double(),
                                        pairs, not per_month, **kw)
    head, gains, whead, wgains, h64, g64 = (
        t.cpu().numpy() for t in (head, gains, whead, wgains, h64, g64))
    np.testing.assert_array_equal(head[..., 2], whead[..., 2])
    ok = whead[..., 2] > 0.5
    cell_ok = ok.reshape(12, 2, C).all(1) if per_month else ok.all(0)[None]
    atol_n = 2e-3 if k > 32 else 1e-3

    def close(got, want, ref, rtol, atol, size):
        """Within the parity tolerance; below ``size`` = 16 slots, where the
        float32 trend design is too ill-conditioned for that (two float32
        runs part by up to 0.1 C), a float64 run of the plain version decides
        instead: the kernel's mean and 95th-percentile distance from it are
        at most twice the plain version's plus the parity atol, and no value
        parts from the plain version by more than 0.1."""
        if size >= 16 or got.size == 0:
            np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)
            return
        d_kern, d_plain = np.abs(got - ref), np.abs(want - ref)
        for stat in (np.mean, lambda a: np.quantile(a, 0.95)):
            assert stat(d_kern) <= 2 * stat(d_plain) + atol, (stat(d_kern), stat(d_plain))
        assert np.abs(got - want).max() <= 0.1

    for col in (0, 3):
        close(head[..., col][ok], whead[..., col][ok], h64[..., col][ok], 1e-4, atol_n, kn_)
    np.testing.assert_allclose(head[..., 1][ok], whead[..., 1][ok], rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(head[..., 4:7], whead[..., 4:7], rtol=1e-4, atol=1e-5)
    close(gains[cell_ok], wgains[cell_ok], g64[cell_ok], 1e-4, 1e-5, ka)
    assert (gains[~mask.cpu().numpy()] == 0.0).all() and (gains[..., ka:] == 0.0).all()
    # int32 indices and a single system give the same bits
    head32, _ = krig_normals_indexed(args[0].int(), *args[1:], pairs[5:6], not per_month, **kw)
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


TABLE_COL = dict(elev=0, tdi=1, x=2, y=3, **{f"lst{m}": 7 + m for m in range(12)})
CELL_COL = dict(elev=0, tdi=1, x=2, y=3, **{f"lst{m}": 4 + m for m in range(12)})
T3, A2 = ("elev", "tdi", "lst6"), ("elev", "tdi")
LST5 = ("elev", "tdi", "lst0", "lst1", "lst2", "lst3", "lst4")  # five months share elevation


def _gathered(dev, C, k, cov, acov, m=6, seed=0):
    """The gathered entry's operands for C cells of ``_indexed``'s world,
    one shared neighbourhood, variable 0 in month m: the trend covariates
    ``cov`` and anomaly covariates ``acov`` named as in ``TABLE_COL``."""
    idx, dist, mask, table, cell = _indexed(dev, C, k, False, seed)
    G = table[idx[0].long()]
    base = kn.TABLE_BASE
    cols = lambda names: G[..., [TABLE_COL[n] for n in names]].contiguous()  # noqa: E731
    cells = lambda names: cell[:, [CELL_COL[n] for n in names]].contiguous()  # noqa: E731
    return (dist[0].contiguous(), mask[0].contiguous(), G[..., 4:7].contiguous(), cols(cov),
            cells(cov), G[..., base + m].contiguous(),
            G[..., base + 12 + 3 * m: base + 15 + 3 * m].contiguous(), cols(acov),
            cells(acov))


@pytest.mark.parametrize("k, C, cov, acov, weight_kernel", [
    (1, 37, T3, A2, "bisquare"), (8, 300, T3, A2, "gaussian"), (16, 200, ("elev",), ("elev",),
    "bisquare"), (16, 200, T3, A2, "gaussian"), (16, 200, T3, A2, "uniform"),
    (24, 129, ("elev", "tdi", "lst6", "x", "y"), ("elev", "x", "y"), "bisquare"),
    (32, 1000, LST5, ("elev",), "bisquare"), (32, 1000, T3, A2, "bisquare"),
    (33, 129, ("elev", "tdi", "lst6", "x", "y", "lst0", "lst3"), ("elev",), "bisquare"),
    (48, 257, T3, A2, "bisquare"), (64, 513, T3, A2, "bisquare"),
    (64, 513, ("elev", "tdi", "x", "y"), ("elev", "tdi", "x", "y"), "uniform"),
])
def test_krig_normals_gathered_kernel_matches_plain(dev, k, C, cov, acov, weight_kernel):
    """The gathered entry against its plain version, q / qa from 1 / 1 to
    7 / 1 and 4 / 4 (both instantiations of the covariate bound), k = 1 to
    64, each weight kernel. Float64 decides below k = 16 and for the trend
    on five LST months (``tests/test_torch_normals.py``'s rule)."""
    operands = _gathered(dev, C, k, cov, acov)
    kw = dict(weight_kernel=weight_kernel)
    n0 = kn.krig_normals_gathered.launches
    head, gains = kn.krig_normals_gathered(*operands, **kw)
    assert kn.krig_normals_gathered.launches == n0 + 1
    whead, wgains = kn.krig_normals_gathered_ref(*operands, **kw)
    wide = [t.double() if t.is_floating_point() else t for t in operands]
    h64, g64 = kn.krig_normals_gathered_ref(*wide, **kw)
    torch.cuda.synchronize()
    assert head.shape == (C, 8) and gains.shape == (C, k)
    head, gains, whead, wgains, h64, g64 = (
        t.cpu().numpy() for t in (head, gains, whead, wgains, h64, g64))
    mask = operands[1].cpu().numpy()
    np.testing.assert_array_equal(head[:, 2], whead[:, 2])
    ok = whead[:, 2] > 0.5
    atol_n = 2e-3 if k > 32 else 1e-3
    by_f64 = k < 16 or cov == LST5
    for col in (0, 3):
        got, want, ref = head[ok, col], whead[ok, col], h64[ok, col]
        if not by_f64 or got.size == 0:
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=atol_n)
            continue
        d_kern, d_plain = np.abs(got - ref), np.abs(want - ref)
        for stat in (np.mean, lambda a: np.quantile(a, 0.95)):
            assert stat(d_kern) <= 2 * stat(d_plain) + atol_n, (stat(d_kern), stat(d_plain))
        assert np.abs(got - want).max() <= 0.1
    np.testing.assert_allclose(head[ok, 1], whead[ok, 1], rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(head[:, 4:7], whead[:, 4:7], rtol=1e-4, atol=1e-5)
    if k >= 16:
        np.testing.assert_allclose(gains[ok], wgains[ok], rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(gains[ok].sum(-1), 1.0, atol=2e-3)
    elif ok.any():
        d_kern, d_plain = np.abs(gains[ok] - g64[ok]), np.abs(wgains[ok] - g64[ok])
        assert d_kern.mean() <= 2 * d_plain.mean() + 1e-5, (d_kern.mean(), d_plain.mean())
    assert (gains[~mask] == 0.0).all()
    if C > 3 and k >= 3:
        assert not ok[3]  # two valid slots, fewer than min_neighbors


@pytest.mark.parametrize("k, C", [(16, 200), (32, 1000), (64, 513)])
def test_krig_normals_gathered_kernel_matches_indexed_kernel(dev, k, C):
    """On the indexed entry's design (trend elev, tdi, lst_m; anomalies
    elev, x_km, y_km) the gathered kernel gives the indexed kernel's head and
    gains for the same system, within the parity tolerance."""
    idx, dist, mask, table, cell = _indexed(dev, C, k, False)
    m, v = 6, 1
    head, gains = krig_normals_indexed(idx, dist, mask, table, cell, [(m, v)], True)
    c = kn.system_columns(table[idx[0].long()], cell, m, v)
    g_head, g_gains = kn.krig_normals_gathered(
        dist[0].contiguous(), mask[0].contiguous(),
        *(c[n].contiguous() for n in ("xyz", "cov", "cell_cov", "norm", "vario", "acov",
                                      "cell_acov")))
    torch.cuda.synchronize()
    head, gains, g_head, g_gains = (t.cpu().numpy() for t in (head[0], gains[0], g_head, g_gains))
    np.testing.assert_array_equal(g_head[:, 2], head[:, 2])
    ok = head[:, 2] > 0.5
    atol_n = 2e-3 if k > 32 else 1e-3
    for col, rtol, atol in ((0, 1e-4, atol_n), (3, 1e-4, atol_n), (1, 1e-3, 1e-4)):
        np.testing.assert_allclose(g_head[ok, col], head[ok, col], rtol=rtol, atol=atol)
    np.testing.assert_allclose(g_head[:, 4:7], head[:, 4:7], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(g_gains[ok], gains[ok], rtol=1e-4, atol=1e-5)


def test_krig_normals_gathered_refuses_bad_arguments(dev):
    operands = _gathered(dev, 64, 8, T3, A2)
    dist, mask, xyz, cov, ccov, norm, vario, acov, cacov = operands
    with pytest.raises(ValueError, match="q=6 trend and qa=3"):
        kn.krig_normals_gathered(dist, mask, xyz, cov.repeat(1, 1, 2), ccov.repeat(1, 2),
                                 norm, vario, cov, ccov)
    with pytest.raises(ValueError, match="qa=0"):
        kn.krig_normals_gathered(*operands[:7], acov[..., :0], cacov[:, :0])
    with pytest.raises(ValueError, match="k=65"):
        kn.krig_normals_gathered(*(t.repeat(1, 9, 1)[:, :65].contiguous() if t.dim() == 3
                                   else t.repeat(1, 9)[:, :65].contiguous() if t.shape[-1] == 8
                                   else t for t in operands))
    with pytest.raises(TypeError):
        kn.krig_normals_gathered(dist.double(), *operands[1:])
    with pytest.raises(TypeError):
        kn.krig_normals_gathered(dist, mask.float(), *operands[2:])
    with pytest.raises(ValueError, match="contiguous"):
        kn.krig_normals_gathered(*operands[:3], cov.transpose(1, 2).contiguous().transpose(1, 2),
                                 *operands[4:])
    with pytest.raises(ValueError, match="devices"):
        kn.krig_normals_gathered(dist.cpu(), *operands[1:])
    # the C entry checks k, q, qa and the weight kernel itself, before it
    # reads a pointer
    fn = _build.load("krig_normals", "krig_normals_gathered_launch", kn._GATHERED_ARGTYPES)
    for C, k, q, qa, wk in ((1, 65, 3, 2, 0), (1, 0, 3, 2, 0), (1, 8, 0, 2, 0), (1, 8, 3, 0, 0),
                            (1, 8, 7, 2, 0), (1, 8, 3, 2, 3), (-1, 8, 3, 2, 0)):
        assert fn(*(0,) * 11, C, k, q, qa, 1e-6, 1e-5, 3, wk, 0) != 0, (C, k, q, qa, wk)
    assert fn(*(0,) * 11, 0, 8, 3, 2, 1e-6, 1e-5, 3, 0, 0) == 0  # no cells: nothing to do


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
    if B > 3:
        mask_t[2:, 3] = 0.0
    xyz = xyz3k.reshape(3, k, B).permute(2, 1, 0)
    dp = pairwise_km_from_xyz(xyz, xyz).permute(1, 2, 0).contiguous()
    par = [torch.from_numpy(rng.uniform(lo, hi, B).astype(np.float32)).to(dev)
           for lo, hi in ((0.01, 0.1), (0.5, 2.0), (30.0, 150.0))]
    return dp, xyz3k, (dist_t * mask_t).contiguous(), mask_t, par


def _ok_tile(k):
    """Cells one block of csrc/ok_solve.cu takes at k: 8 warps of 8, 4 or 1
    systems (G = 4, 8, 32 lanes a system for k <= 16, 32, 64)."""
    return 64 if k <= 16 else 32 if k <= 32 else 8


_OK_EDGE_B = {"1": lambda k: 1, "tile-1": lambda k: _ok_tile(k) - 1,
              "tile": _ok_tile, "tile+1": lambda k: _ok_tile(k) + 1,
              "65536": lambda k: 65536}


@pytest.mark.parametrize("k, B", [(1, 37), (8, 300), (32, 1000), (33, 129), (64, 513)] + [
    (k, b) for k in (1, 2, 15, 16, 17, 31, 32, 33, 63, 64) for b in _OK_EDGE_B])
@pytest.mark.parametrize("xyz", [False, True], ids=["pair", "xyz"])
def test_ok_solve_kernel_matches_plain(dev, k, B, xyz):
    """Kernel vs plain version, with an all-masked cell (1), a range below
    1e-3 (2) and a NaN range (4) where B has them: the NaN cell's weights
    and variance are NaN in both and it is not ok; masked weights of every
    other cell are exactly 0."""
    B = _OK_EDGE_B[B](k) if isinstance(B, str) else B
    dp, xyz3k, dist_t, mask_t, par = _ok_inputs(dev, B, k)
    if B > 1:
        mask_t[:, 1] = 0.0
        dist_t[:, 1] = 0.0
    if B > 2:
        par[2][2] = 1e-5
    if B > 4:
        par[2][4] = float("nan")
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
    finite = torch.isfinite(par[2])
    assert torch.all(w[:, finite][mask_t[:, finite] < 0.5] == 0.0)
    if B > 4:
        assert torch.isnan(var[4]) and torch.isnan(w[:, 4]).all() and not ok[4]
    if B > 1:
        assert not ok[1] and torch.all(w[:, 1] == 0.0)


@pytest.mark.parametrize("k", [16, 32, 64])
def test_ok_solve_pair_kernel_reads_lower_triangle(dev, k):
    """The pair entry reads the diagonal and the strict lower triangle only:
    NaN above the diagonal changes nothing."""
    dp, _, dist_t, mask_t, par = _ok_inputs(dev, 300, k)
    upper = torch.triu(torch.ones(k, k, dtype=torch.bool, device=dev), 1)
    nan_up = dp.masked_fill(upper[:, :, None], float("nan"))
    for a, b in zip(ok_solve_fused(dp, dist_t, mask_t, *par),
                    ok_solve_fused(nan_up, dist_t, mask_t, *par)):
        assert torch.equal(a, b)


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


def _vfit_case(dev, B, n_bins, seed=4):
    """B synthetic variograms (``variogram_cases.synthetic_emp``, 5 % noise,
    some bins empty) as float64 numpy arrays and as float32 operands on
    ``dev``; every 11th fit from the 3rd keeps 3 non-empty bins (fewer than
    min_bins = 4), every 13th from the 6th none."""
    gamma, h, npairs, cutoff = synthetic_emp(seed, B, n_bins, noise=0.05)
    npairs[2::11, 3:] = 0.0
    npairs[5::13] = 0.0
    gamma[npairs == 0] = 0.0
    h[npairs == 0] = 0.0
    arrays = [a.astype(np.float64) for a in (gamma, h, npairs)]
    return arrays, EmpiricalVariogram(*(torch.from_numpy(a).to(dev)
                                        for a in (gamma, h, npairs, cutoff)))


@pytest.mark.parametrize("n_iters", [0, 1, 50])
@pytest.mark.parametrize("n_bins", [15, 20])  # 20: lanes 0-3 take two bins
@pytest.mark.parametrize("B", [1, 37, 10_000])
def test_variogram_fit_kernel_matches_plain(dev, B, n_bins, n_iters):
    """The kernel against the plain loop on the card. After 50 steps the
    fits that miss the bar are counted, and may be no more than twice those
    where the plain loop in float64 misses it against itself in float32, + 2:
    on these curves the float64 run parts 0.1-0.3 % of the fits (CPU runs)."""
    (gamma, h, npairs), emp = _vfit_case(dev, B, n_bins)
    variogram_fit.launches = 0
    got = variogram_fit(emp, n_iters)
    torch.cuda.synchronize()
    assert variogram_fit.launches == 1
    want = fit_exp_variogram_ref(emp, n_iters)
    g = {f: getattr(got, f).cpu().numpy() for f in got._fields}
    w = {f: getattr(want, f).cpu().numpy() for f in want._fields}
    assert g["ok"].dtype == bool and g["nugget"].dtype == np.float32
    np.testing.assert_array_equal(g["ok"], w["ok"])
    np.testing.assert_array_equal(g["ok"], (npairs > 0).sum(1) >= 4)
    for f in ("nugget", "psill", "rng", "sse"):
        assert np.isfinite(g[f]).all(), f
    if n_iters <= 1:
        sill = w["nugget"].astype(np.float64) + w["psill"]
        for f, scale in (("nugget", sill), ("psill", sill), ("rng", w["rng"]),
                         ("sse", sill**2)):
            np.testing.assert_array_less(np.abs(g[f].astype(np.float64) - w[f]),
                                         1e-5 * scale + 1e-30, err_msg=f)
        return
    ok = w["ok"]
    apart = fits_apart(got, want, gamma, h, npairs)[ok]
    want64 = fit_exp_variogram_ref(EmpiricalVariogram(*(t.double() for t in emp)), n_iters)
    apart64 = fits_apart(want64, want, gamma, h, npairs)[ok]
    assert apart.sum() <= 2 * apart64.sum() + 2, (apart.sum(), apart64.sum(), ok.sum())


def test_variogram_fit_refuses_bad_inputs(dev):
    _, emp = _vfit_case(dev, 16, 15)
    variogram_fit.launches = 0
    with pytest.raises(TypeError):
        variogram_fit(EmpiricalVariogram(*(t.double() for t in emp)))
    with pytest.raises(ValueError, match="contiguous"):
        variogram_fit(emp._replace(h=emp.h.T.contiguous().T))
    with pytest.raises(ValueError, match="shape"):
        variogram_fit(emp._replace(npairs=emp.npairs[:, :-1].contiguous()))
    with pytest.raises(ValueError, match="shape"):
        variogram_fit(emp._replace(cutoff=emp.cutoff[:, None]))
    with pytest.raises(ValueError, match="shape"):
        variogram_fit(emp._replace(gamma=emp.gamma[0]))
    with pytest.raises(ValueError, match="devices"):
        variogram_fit(emp._replace(cutoff=emp.cutoff.cpu()))
    assert variogram_fit.launches == 0


def test_build_krig_params_launches_the_fit_kernel_a_month(dev, monkeypatch):
    """``build_krig_params`` on ``tests/test_torch_krig_params.py``'s world
    (the port's ``make_world``) launches the fit once a month and matches a
    run through the plain loop on the card, by that file's bar: ok flags
    identical; on at least 97 % of station-months the curves within 1 % of
    the sill and the SSEs within 1 % (these nearly flat variograms part
    fits along their valleys, as float32 against the JAX package does); the
    network's median sill and range within 1 %."""
    world = make_world(np.random.default_rng(11), nrows=60, ncols=60, n_stations=150,
                       ndays=30, cellsize=1.0 / 30.0, vario=(0.05, 1.0, 160.0))
    st = station_arrays_from_world(world)
    valid = st.valid.copy()
    valid[5, 3] = False
    valid[:, 9][::50] = False
    args = (st.lon, st.lat, st.elev, st.tdi, st.lst, st.norm, valid,
            VariogramParams(k_fit_neighbors=32), InterpParams(), dev)
    variogram_fit.launches = 0
    got = tparams.krig_params_to_numpy(tparams.build_krig_params(*args))
    assert variogram_fit.launches == 12
    monkeypatch.setattr(tparams, "fit_exp_variogram", fit_exp_variogram_ref)
    want = tparams.krig_params_to_numpy(tparams.build_krig_params(*args))
    assert variogram_fit.launches == 12
    np.testing.assert_array_equal(got.ok, want.ok)
    assert not got.ok[5, 3] and got.ok.mean() > 0.95
    gv, wv = got.vario.astype(np.float64), want.vario.astype(np.float64)
    sill = wv[..., 0] + wv[..., 1]
    h = np.linspace(0.0, 3.0 * np.median(wv[..., 2]), 31)
    curve = lambda v: v[..., 0, None] + v[..., 1, None] * (1 - np.exp(-h / v[..., 2, None]))  # noqa: E731
    rel_curve = np.abs(curve(gv) - curve(wv)).max(-1) / sill
    rel_sse = np.abs(got.sse / np.maximum(want.sse, 1e-12) - 1.0)
    ok = want.ok
    assert np.mean(rel_curve[ok] <= 1e-2) >= 0.97, np.mean(rel_curve[ok] <= 1e-2)
    assert np.mean(rel_sse[ok] <= 1e-2) >= 0.97, np.mean(rel_sse[ok] <= 1e-2)
    np.testing.assert_allclose(np.median((gv[..., 0] + gv[..., 1])[ok]), np.median(sill[ok]),
                               rtol=1e-2)
    np.testing.assert_allclose(np.median(gv[..., 2][ok]), np.median(wv[..., 2][ok]), rtol=1e-2)
