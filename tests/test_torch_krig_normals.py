"""The port's fused regression-kriging normals against the JAX package.

Identical float32 inputs (a synthetic world with two variables,
neighbourhoods chosen in float64 numpy) go through the JAX functions and the
port's ``krig_normals_indexed`` on the CPU, where the wrapper runs its plain
version. The JAX side is the Pallas kernel ``krig_normals_fused`` in
interpret mode, system by system on planes laid out here in numpy from the
same neighbourhoods and tables, and the jnp path ``krig_normals`` +
``anomaly_gain_rows``. Tolerances: normal and trend rtol 1e-4, atol 1e-3
(2e-3 at k > 32; below 16 slots, k = 8 or k_normal = 12, a float64 run of the
port's plain version decides, with a 0.1 C cap, see ``_assert_rows``); variance rtol 1e-3, atol 1e-4;
variogram and gains rtol 1e-4, atol 1e-5; ok flags identical. The JAX
kernel's Taylor asin differs from the exact asin by under 1e-6 relative,
which is inert here.

The indexed entry's two sizes: systems on the first ``k_normal`` slots
against the JAX kernel on the mask cut there, gain rows on the first
``k_anom`` against JAX ``anomaly_gain_rows`` on that prefix. And the tile
step with per-variable neighbourhood sizes (one call of the indexed entry
for each (k, ka) pair) against the JAX package's step with
``tests/test_torch_point.py``'s tolerances.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from topotpu.core.config import InterpParams
from topotpu.core.dates import get_days_metadata
from topotpu.interp import point as jpoint
from topotpu.interp.anoms import anomaly_gain_rows as jax_gain_rows
from topotpu.interp.normals import krig_normals as jax_krig_normals
from topotpu.io.synthetic import make_world
from topotpu.io.synthetic import tile_inputs_from_world as jax_tile_inputs_from_world
from topotpu.oracle.numpy_ref import haversine_km
from topotpu.kernels.pallas_krig import krig_normals_fused as jax_krig_fused
from topotpu_torch.interp import point as tpoint
from topotpu_torch.interp.convert import pair_inputs_from_numpy
from topotpu_torch.kernels import krig_normals as kn

torch.set_num_threads(1)

def _assert_rows(got, want, k, f64=None):
    """Values are compared on the cells both flag ok: a cell with fewer
    valid neighbours than WLS parameters has an undetermined trend, and the
    tile step packs it as a sentinel. ``f64``: the same rows from a float64
    run of the port's plain version, the arbiter below k = 16."""
    np.testing.assert_array_equal(got[2], want[2])
    ok = want[2] > 0.5
    atol_n = 2e-3 if k > 32 else 1e-3
    for row in (0, 3):  # normal, trend
        if k < 16:
            # a 4-column trend design on 8 neighbours leaves 4 degrees of
            # freedom: its float32 normal equations amplify rounding, in both
            # packages alike (ROADMAP.md Queue 3). Read on these inputs (an
            # AMD EPYC host), distance from the float64 run over the ok cells
            # of a system: the JAX kernel mean 1.5e-4 to 1.7e-3 C, 95th
            # percentile 4e-4 to 2.4e-3 C, max 5e-3 to 0.16 C; the port mean
            # 1.6e-4 to 1.8e-3 C, 95th percentile 5e-4 to 4.0e-3 C, max 4e-3
            # to 0.17 C; the two up to 3.5e-2 C apart. So float64 decides: the
            # port's mean and 95th-percentile distance from it are at most
            # twice the JAX kernel's plus the parity atol, and no cell parts
            # from the JAX kernel by more than 0.1 C.
            d_port = np.abs(got[row, ok] - f64[row, ok])
            d_jax = np.abs(want[row, ok] - f64[row, ok])
            for stat in (np.mean, lambda a: np.quantile(a, 0.95)):
                assert stat(d_port) <= 2 * stat(d_jax) + atol_n, (stat(d_port), stat(d_jax))
            assert np.abs(got[row, ok] - want[row, ok]).max() <= 0.1
            continue
        np.testing.assert_allclose(got[row, ok], want[row, ok], rtol=1e-4, atol=atol_n)
    np.testing.assert_allclose(got[1, ok], want[1, ok], rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(got[4:7], want[4:7], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got[8:, ok], want[8:, ok], rtol=1e-4, atol=1e-5)


def _indexed_case(seed, C, k, per_month, holes=True):
    """Indexed-entry inputs from a synthetic world with two variables, as
    float32 numpy: idx, dist, mask (N, C, k) chosen in float64, the station
    table and the cell table. With ``holes``: station 5 is invalid (with
    ``per_month``, month n also drops station 6 + n), the last slot of every
    7th cell is masked, and cell 3 is left with two valid slots."""
    rng = np.random.default_rng(seed)
    world = make_world(rng, nrows=30, ncols=30, n_stations=80, ndays=30)
    S = world.n_stations
    rows, cols = rng.integers(0, 30, C), rng.integers(0, 30, C)
    lon, lat = world.grid.cell_lonlat(rows, cols)
    d = haversine_km(lon[:, None], lat[:, None], world.stn_lon[None], world.stn_lat[None])
    idx, dist, mask = [], [], []
    for n in range(12 if per_month else 1):
        valid = np.ones(S, bool)
        valid[5] = not holes
        if per_month:
            valid[6 + n] = False
        dn = np.where(valid[None, :], d, np.inf)
        i = np.argsort(dn, axis=1, kind="stable")[:, :k]
        di = np.take_along_axis(dn, i, axis=1)
        mk = np.isfinite(di)
        if holes:
            mk[::7, -1] = False
            mk[3, 2:] = False
        idx.append(i)
        dist.append(np.where(mk, di, 0.0))
        mask.append(mk)
    kx = 111.32 * np.cos(np.deg2rad(world.stn_lat.mean()))
    lonr, latr = np.deg2rad(world.stn_lon), np.deg2rad(world.stn_lat)
    xyz = np.stack([np.cos(latr) * np.cos(lonr), np.cos(latr) * np.sin(lonr), np.sin(latr)], -1)
    vario_a = np.tile(np.asarray(world.true_vario), (S, 12, 1))
    vario_b = vario_a * rng.uniform(0.8, 1.25, (S, 12, 3))
    table = np.concatenate(
        [world.stn_elev[:, None], world.stn_tdi[:, None], (world.stn_lon * kx)[:, None],
         (world.stn_lat * 111.32)[:, None], xyz, world.stn_lst,
         world.stn_norm, vario_a.reshape(S, 36),
         world.stn_norm + 9.0, vario_b.reshape(S, 36)], axis=1)
    cell = np.concatenate(
        [np.stack([world.elev[rows, cols], world.tdi[rows, cols], lon * kx, lat * 111.32], 1),
         world.lst[:, rows, cols].T], axis=1)
    return (np.stack(idx), np.stack(dist).astype(np.float32), np.stack(mask),
            table.astype(np.float32), cell.astype(np.float32))


def _planes(idx, dist, mask, table, cell, m, v):
    """The JAX kernel's eight (rows, C) planes for system (month m, variable
    v) of one neighbourhood (C, k): what the indexed entry gathers itself."""
    G = table[idx]  # (C, k, F)
    rows = lambda a: np.ascontiguousarray(  # noqa: E731
        a.transpose(2, 1, 0).reshape(-1, a.shape[0]))
    base = 19 + 48 * v
    cell8 = np.zeros((8, idx.shape[0]), np.float32)
    cell8[:3] = cell[:, [0, 1, 4 + m]].T
    cell8[3:6] = cell[:, [0, 2, 3]].T
    return [rows(G[..., 4:7]), np.ascontiguousarray(dist.T),
            np.ascontiguousarray(mask.T.astype(np.float32)), rows(G[..., [0, 1, 7 + m]]), cell8,
            np.ascontiguousarray(G[..., base + m].T),
            rows(G[..., base + 12 + 3 * m : base + 15 + 3 * m]), rows(G[..., [0, 2, 3]])]


@pytest.mark.parametrize("per_month", [False, True], ids=["shared", "per_month"])
@pytest.mark.parametrize("k, k_normal, k_anom", [
    pytest.param(8, None, None, id="8"), pytest.param(32, None, None, id="32"),
    pytest.param(40, None, None, id="40"), pytest.param(32, 24, 24, id="32-n24-a24"),
    pytest.param(32, 32, 8, id="32-n32-a8"), pytest.param(16, 12, 16, id="16-n12-a16"),
    pytest.param(32, 12, 16, id="32-n12-a16"),
])
def test_indexed_matches_pallas_kernel_interpret(k, k_normal, k_anom, per_month):
    """Heads against the JAX kernel on the mask cut at ``k_normal``; gains
    against the JAX kernel's at the full sizes and against JAX
    ``anomaly_gain_rows`` on the ``k_anom``-slot prefix otherwise, 0 beyond."""
    C = 128  # the JAX kernel takes batches in multiples of 128
    idx, dist, mask, table, cell = _indexed_case(4, C, k, per_month)
    pairs = [(0, 0), (5, 1), (11, 0), (11, 1), (5, 0)]
    sizes = dict(k_normal=k_normal, k_anom=k_anom)
    head, gains = kn.krig_normals_indexed(
        torch.from_numpy(idx), torch.from_numpy(dist), torch.from_numpy(mask),
        torch.from_numpy(table), torch.from_numpy(cell), pairs, not per_month, **sizes)
    assert head.shape == (len(pairs), C, 8) and gains.shape == (idx.shape[0], C, k)
    h64, g64 = kn.krig_normals_indexed(
        torch.from_numpy(idx), torch.from_numpy(dist).double(), torch.from_numpy(mask),
        torch.from_numpy(table).double(), torch.from_numpy(cell).double(), pairs, not per_month,
        **sizes)
    assert kn.krig_normals_indexed.launches == 0  # CPU tensors: the plain version
    assert not (head[:, 3, 2] > 0.5).any()  # too few neighbours: not ok
    kn_, ka = k_normal or k, k_anom or k
    mask_n = mask & (np.arange(k) < kn_)
    for p, (m, v) in enumerate(pairs):
        n = m if per_month else 0
        want = np.array(jax_krig_fused(
            *map(jnp.asarray, _planes(idx[n], dist[n], mask_n[n], table, cell, m, v)),
            interpret=True))
        if (kn_, ka) != (k, k):
            want[8:] = 0.0
            want[8:8 + ka] = np.asarray(jax_gain_rows(
                jnp.asarray(dist[n][:, :ka]), jnp.asarray(mask[n][:, :ka]),
                jnp.asarray(table[idx[n][:, :ka]][..., [0, 2, 3]]),
                jnp.asarray(cell[:, [0, 2, 3]]))).T
        got = np.concatenate([head[p].numpy().T, gains[n].numpy().T])
        _assert_rows(got, want, kn_, np.concatenate([h64[p].numpy().T, g64[n].numpy().T]))
        assert (got[8:][~mask[n].T] == 0.0).all()  # masked slots carry no gain
        assert (got[8 + ka:] == 0.0).all()  # nor slots beyond the anomaly prefix


def _tensors(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _got_rows(head, gains, p, n):
    """System p's (8 + k, C) rows, as the Pallas kernel lays them out."""
    return np.concatenate([head[p].numpy().T, gains[n].numpy().T])


@pytest.mark.parametrize(
    "k, weight_kernel",
    [(16, "bisquare"), (16, "gaussian"), (16, "uniform"), (64, "bisquare")],
)
def test_ref_matches_pallas_kernel_interpret(k, weight_kernel):
    """One system alone, under each weight kernel and at the largest k."""
    C = 128
    idx, dist, mask, table, cell = _indexed_case(1, C, k, False)
    head, gains = kn.krig_normals_indexed(*_tensors(idx, dist, mask, table, cell), [(0, 0)],
                                          True, weight_kernel=weight_kernel)
    want = np.asarray(jax_krig_fused(
        *map(jnp.asarray, _planes(idx[0], dist[0], mask[0], table, cell, 0, 0)),
        weight_kernel=weight_kernel, interpret=True,
    ))
    got = _got_rows(head, gains, 0, 0)
    assert got.shape == (8 + k, C)
    assert got[2, 3] == 0.0  # too few neighbours: not ok
    _assert_rows(got, want, k)


@pytest.mark.parametrize("k", [32, 48])
def test_krig_normals_and_gains_match_jax(k):
    """The port's chain against the JAX jnp path (``krig_normals`` with
    use_pallas="off", ``anomaly_gain_rows``) on the gathered inputs of one
    system, at k = 32 and 48."""
    C, m, v = 96, 4, 1
    idx, dist, mask, table, cell = _indexed_case(2, C, k, False)
    G, base = table[idx[0]], 19 + 48 * v
    args = dict(
        dist=dist[0], mask=mask[0], nbr_xyz=G[..., 4:7], nbr_cov=G[..., [0, 1, 7 + m]],
        cell_cov=cell[:, [0, 1, 4 + m]], nbr_norm=G[..., base + m],
        nbr_vario=G[..., base + 12 + 3 * m : base + 15 + 3 * m],
    )
    ref = jax_krig_normals(**{n: jnp.asarray(a) for n, a in args.items()}, use_pallas="off")
    ref_g = jax_gain_rows(jnp.asarray(dist[0]), jnp.asarray(mask[0]),
                          jnp.asarray(G[..., [0, 2, 3]]), jnp.asarray(cell[:, [0, 2, 3]]))
    head, gains = kn.krig_normals_indexed(*_tensors(idx, dist, mask, table, cell), [(m, v)],
                                          True)
    head, got_g = head[0].numpy(), gains[0].numpy()
    atol_n = 2e-3 if k > 32 else 1e-3
    ok = np.asarray(ref.ok)  # values compared where solvable (see _assert_rows)
    assert not ok[3] and ok.sum() == C - 1
    np.testing.assert_array_equal(head[:, 2] > 0.5, ok)
    se = np.sqrt(np.maximum(head[:, 1], 0.0))
    for got, name, rtol, atol in ((head[:, 0], "normal", 1e-4, atol_n),
                                  (head[:, 3], "trend", 1e-4, atol_n),
                                  (head[:, 1], "variance", 1e-3, 1e-4), (se, "se", 1e-3, 1e-4)):
        np.testing.assert_allclose(got[ok], np.asarray(getattr(ref, name))[ok], rtol=rtol,
                                   atol=atol, err_msg=name)
    np.testing.assert_allclose(head[:, 4:7], np.asarray(ref.vario), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got_g[ok], np.asarray(ref_g)[ok], rtol=1e-4, atol=1e-5)
    # gains reproduce constants where the design is solvable
    np.testing.assert_allclose(got_g[ok].sum(-1), 1.0, atol=2e-3)


def test_masked_slots_are_inert():
    """Masking a slot equals removing the station: the masked slots carry
    zero gain, and heads and gains equal a run on the unmasked prefix. Run
    in float64: in float32 the sums over 16 slots and over 12 round
    differently, which the trend design amplifies to ~1e-3 C."""
    k, cut = 16, 4
    idx, dist, mask, table, cell = _tensors(*_indexed_case(3, 64, k, False, holes=False))
    dist, table, cell = dist.double(), table.double(), cell.double()
    pairs = [(0, 0), (7, 1)]
    masked = mask.clone()
    masked[..., -cut:] = False
    head, gains = kn.krig_normals_indexed(idx, dist * masked, masked, table, cell, pairs, True)
    assert torch.all(gains[..., -cut:] == 0.0)
    want_h, want_g = kn.krig_normals_indexed(
        *(a[..., : k - cut].contiguous() for a in (idx, dist, mask)), table, cell, pairs, True)
    assert bool((want_h[..., 2] > 0.5).all())
    torch.testing.assert_close(head, want_h, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(gains[..., : k - cut], want_g, rtol=1e-5, atol=1e-6)


def test_stray_indices_are_clamped_into_the_table():
    """An index outside the table reads its first or last row, as the CUDA
    kernel clamps it (and as a ``jnp`` gather does): the plain version on
    stray indices, masked and unmasked, equals itself on the clamped copy."""
    idx, dist, mask, table, cell = map(torch.from_numpy, _indexed_case(6, 48, 16, False))
    S = table.shape[0]
    stray = idx.clone()
    stray[0, ::4, 1] = -1       # valid slots
    stray[0, 1::4, 5] = S
    stray[0, 2::4, 9] = S + 7
    stray[~mask] = -3           # masked slots
    assert int((((stray < 0) | (stray >= S)) & mask).sum()) > 20 and int((~mask).sum()) > 0
    pairs = [(0, 0), (6, 1)]
    got = kn.krig_normals_indexed(stray, dist, mask, table, cell, pairs, True)
    want = kn.krig_normals_indexed(stray.clamp(0, S - 1), dist, mask, table, cell, pairs, True)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)
    # and the clamp is not a no-op: the systems differ from the unstrayed ones
    base = kn.krig_normals_indexed(idx, dist, mask, table, cell, pairs, True)
    assert not torch.equal(torch.nan_to_num(got[0]), torch.nan_to_num(base[0]))


def test_indexed_int32_and_single_system():
    """int32 indices answer as int64, one system alone as in a list, and a
    system's place in the list does not matter."""
    idx, dist, mask, table, cell = map(torch.from_numpy, _indexed_case(5, 40, 16, False))
    pairs = [(3, 1), (7, 0)]
    head, gains = kn.krig_normals_indexed(idx, dist, mask, table, cell, pairs, True)
    head32, gains32 = kn.krig_normals_indexed(idx.int(), dist, mask, table, cell, pairs, True)
    torch.testing.assert_close(head32, head, rtol=0, atol=0, equal_nan=True)
    torch.testing.assert_close(gains32, gains, rtol=0, atol=0, equal_nan=True)
    one, g1 = kn.krig_normals_indexed(idx, dist, mask, table, cell, [(7, 0)], True)
    torch.testing.assert_close(one[0], head[1], rtol=0, atol=0, equal_nan=True)
    torch.testing.assert_close(g1, gains, rtol=0, atol=0, equal_nan=True)
    none, g0 = kn.krig_normals_indexed(idx, dist, mask, table, cell, [], True)
    assert none.shape == (0, 40, 8) and g0.shape == gains.shape


def test_indexed_refuses_bad_arguments():
    idx, dist, mask, table, cell = map(torch.from_numpy, _indexed_case(5, 16, 8, False))
    ok = (idx, dist, mask, table, cell)
    with pytest.raises(ValueError, match="neighbourhoods"):
        kn.krig_normals_indexed(*ok, [(0, 0)], False)  # 1 neighbourhood, not 12
    with pytest.raises(ValueError, match="pair"):
        kn.krig_normals_indexed(*ok, [(12, 0)], True)
    with pytest.raises(ValueError, match="pair"):
        kn.krig_normals_indexed(*ok, [(0, 2)], True)  # the table holds two variables
    with pytest.raises(ValueError, match="cell table"):
        kn.krig_normals_indexed(idx, dist, mask, table, cell[:, :15], [(0, 0)], True)
    with pytest.raises(ValueError, match="station table"):
        kn.krig_normals_indexed(idx, dist, mask, table[:, :-1], cell, [(0, 0)], True)
    with pytest.raises(ValueError, match="shape"):
        kn.krig_normals_indexed(idx, dist[:, :, :7], mask, table, cell, [(0, 0)], True)
    with pytest.raises(ValueError, match="weight kernel"):
        kn.krig_normals_indexed(*ok, [(0, 0)], True, weight_kernel="tricube")
    with pytest.raises(ValueError, match="systems"):
        kn.krig_normals_indexed(*ok, [(0, 0)] * 97, True)
    for sizes in (dict(k_normal=0), dict(k_normal=9), dict(k_anom=0), dict(k_anom=9),
                  dict(k_normal=9, k_anom=9)):
        with pytest.raises(ValueError, match="must lie in 1..8"):
            kn.krig_normals_indexed(*ok, [(0, 0)], True, **sizes)


@pytest.mark.parametrize("shared_validity", [True, False])
def test_tile_step_with_per_variable_k_matches_jax(shared_validity):
    """``k_per_var`` / ``ka_per_var``: each (month, variable) system reads
    the slots below its own k, and each variable's gain rows its own ka
    slots, one call of the indexed entry for each (k, ka) pair. Against the JAX
    package's step: normals within 2e-3 C on 99 % and 1e-2 C on all, dailies
    5e-3 C / 1e-2 C, se within 2e-3 C (``tests/test_torch_point.py``'s)."""
    world = make_world(np.random.default_rng(7), nrows=40, ncols=40, n_stations=110, ndays=59)
    days = get_days_metadata("2015-01-01", "2015-02-28")
    cells = np.random.default_rng(3).choice(1600, 96, replace=False)
    ti, _ = jax_tile_inputs_from_world(world, days.month_idx, *np.unravel_index(cells, (40, 40)))
    ti = ti._replace(**{f: np.asarray(getattr(ti, f)) for f in ti._fields})
    if not shared_validity:
        valid = ti.stn_valid.copy()
        valid[11, 1] = False
        ti = ti._replace(stn_valid=valid)
    pair = jpoint.PairTileInputs(
        geom=ti, b=jpoint.VarFields(norm=ti.stn_norm + np.float32(9.0), vario=ti.stn_vario,
                                    anoms=ti.stn_anoms * np.float32(0.85)))
    params = InterpParams(k_neighbors=16, k_per_var=(16, 12), ka_per_var=(8, 16))
    want = jpoint.interp_tile_pair(pair, params, shared_validity)
    got = tpoint.interp_tile_pair(pair_inputs_from_numpy(pair, "cpu"), params, shared_validity)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.ok.numpy(), np.asarray(w.ok))
        for name, bulk in (("normal", 2e-3), ("daily", 5e-3)):
            err = np.abs(getattr(g, name).numpy().astype(np.float64) - np.asarray(getattr(w, name)))
            assert np.quantile(err, 0.99) <= bulk and err.max() <= 1e-2, (name, err.max())
        np.testing.assert_allclose(g.se.numpy(), np.asarray(w.se), rtol=0, atol=2e-3)
