"""The port's paired tile step against the JAX package, on the CPU.

One synthetic world (40 x 40 cells, 110 stations, 365 days), 256 cells,
k = 16, the run-global pack lattice and the tmin <= tmax reconcile. Var B is
var A's normals + 0.2 C with anomalies x 0.5, so dailies cross and the
reconcile has work to do. Both packages get the same numpy inputs.

Tolerances. The trend design (elev, tdi, lst_month) is nearly collinear on
this world (lst follows elevation), and its normal equations square that
condition number, so a float32 run of the same algorithm lands up to 4e-3 C
from a float64 run (measured on this world, for the JAX and the port alike),
and two float32 implementations that round differently differ by up to
twice that. So normals and dailies must agree within 2e-3 C (normals) and
5e-3 C (dailies) on 99 % of values and within 1e-2 C on all; se within
2e-3 C everywhere. The int16 buffers must agree up to those tolerances on
their lattices plus one step, with identical sentinel positions.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from topotpu.core.config import InterpParams, TopoConfig
from topotpu.core.dates import get_days_metadata
from topotpu.interp import point as jpoint
from topotpu.io.synthetic import make_world, tile_inputs_from_world
from topotpu_torch.interp import point as tpoint
from topotpu_torch.interp.convert import (
    fixed_scales_from_config,
    pair_inputs_from_numpy,
    tile_inputs_from_numpy,
)

torch.set_num_threads(1)

K = 16
NDAYS = 365


@pytest.fixture(scope="module")
def case():
    world = make_world(np.random.default_rng(7), nrows=40, ncols=40,
                       n_stations=110, ndays=NDAYS)
    days = get_days_metadata("2015-01-01", "2015-12-31")
    cells = np.random.default_rng(3).choice(1600, 256, replace=False)
    rows, cols = np.unravel_index(cells, (40, 40))
    ti, layout = tile_inputs_from_world(world, days.month_idx, rows, cols)
    ti = jax.tree_util.tree_map(np.asarray, ti)
    pair = jpoint.PairTileInputs(
        geom=ti,
        b=jpoint.VarFields(norm=ti.stn_norm + np.float32(0.2), vario=ti.stn_vario,
                           anoms=ti.stn_anoms * np.float32(0.5)),
    )
    return pair, layout


def _close_bulk(got, want, bulk_atol, what):
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert np.quantile(err, 0.99) <= bulk_atol, (what, np.quantile(err, 0.99))
    assert err.max() <= 1e-2, (what, err.max())


def _check_buffers(got_flat, want_flat, scales):
    a = want_flat.astype(np.int32)
    b = got_flat.astype(np.int32)
    assert a.shape == b.shape == (2 * (NDAYS + 24), 256)
    np.testing.assert_array_equal(a == -32768, b == -32768)
    for v in range(2):
        o = v * (NDAYS + 24)
        sc = scales[6 * v : 6 * v + 6]
        for sl, step, tol in (
            (slice(o, o + NDAYS), sc[0], 1e-2),
            (slice(o + NDAYS, o + NDAYS + 12), sc[2], 1e-2),
            (slice(o + NDAYS + 12, o + NDAYS + 24), sc[4], 2e-3),
        ):
            assert np.abs(a[sl] - b[sl]).max() <= 1 + int(tol / step)


@pytest.mark.parametrize("shared_validity", [True, False])
def test_pair_flat_matches_jax(case, shared_validity):
    pair, layout = case
    if not shared_validity:  # one station invalid in one month
        valid = pair.geom.stn_valid.copy()
        valid[17, 4] = False
        pair = pair._replace(geom=pair.geom._replace(stn_valid=valid))
    params = InterpParams(k_neighbors=K)
    fs = fixed_scales_from_config(TopoConfig(), 2)

    want_res = jpoint.interp_tile_pair(pair, params, shared_validity)
    want = jpoint.interp_tile_pair_flat(
        pair, jnp.asarray(layout.slot_of_day), params,
        shared_validity=shared_validity, fixed_scales=jnp.asarray(fs),
        reconcile=True,
    )
    tpair = pair_inputs_from_numpy(pair, "cpu")
    got_res = tpoint.interp_tile_pair(tpair, params, shared_validity)
    got = tpoint.interp_tile_pair_flat(
        tpair, layout.slot_of_day, params, shared_validity=shared_validity,
        fixed_scales=fs, reconcile=True,
    )

    for g, w in zip(got_res, want_res):
        np.testing.assert_array_equal(g.ok.numpy(), np.asarray(w.ok))
        np.testing.assert_allclose(g.se.numpy(), np.asarray(w.se), atol=2e-3)
        _close_bulk(g.normal.numpy(), w.normal, 2e-3, "normal")
        _close_bulk(g.daily.numpy(), w.daily, 5e-3, "daily")
    # var B crosses var A before the reconcile
    assert (got_res[1].daily < got_res[0].daily).sum() > 0

    buf = got.buf.numpy()
    assert buf.dtype == np.int16
    np.testing.assert_array_equal(got.scales.numpy(), np.asarray(want.scales))
    _check_buffers(buf, np.asarray(want.buf), fs)
    # after the reconcile no cell has tmax < tmin on the lattice
    a, b = buf[:NDAYS].astype(np.int32), buf[NDAYS + 24 : 2 * NDAYS + 24].astype(np.int32)
    both = (a != -32768) & (b != -32768)
    assert not np.any(both & (b < a))


@pytest.mark.parametrize("shared_validity", [True, False])
def test_pair_flat_with_per_variable_k_matches_jax(case, shared_validity):
    """``k_per_var`` / ``ka_per_var`` on the fixed-lattice flat form: each
    variable's kriging systems read the slots below its own k and its gain
    rows those below its own ka (one indexed call for each (k, ka) pair), and
    one packed daily call serves both. Against the
    JAX package's flat step: identical sentinels; dailies and normals within
    one step + 5e-3 C on 99 % of values and one step + 2e-2 C on all (below
    k = 16 the float32 trend design parts two implementations by more than
    at k = 16: 7e-3 C here at k = 14, 2.7e-2 C at k = 12, on an AMD EPYC
    host), se within one step + 2e-3 C."""
    pair, layout = case
    if not shared_validity:
        valid = pair.geom.stn_valid.copy()
        valid[17, 4] = False
        pair = pair._replace(geom=pair.geom._replace(stn_valid=valid))
    params = InterpParams(k_neighbors=K, k_per_var=(K, 14), ka_per_var=(8, K))
    fs = fixed_scales_from_config(TopoConfig(), 2)
    want = jpoint.interp_tile_pair_flat(
        pair, jnp.asarray(layout.slot_of_day), params, shared_validity=shared_validity,
        fixed_scales=jnp.asarray(fs), reconcile=True,
    )
    got = tpoint.interp_tile_pair_flat(
        pair_inputs_from_numpy(pair, "cpu"), layout.slot_of_day, params,
        shared_validity=shared_validity, fixed_scales=fs, reconcile=True,
    )
    buf = got.buf.numpy()
    np.testing.assert_array_equal(got.scales.numpy(), np.asarray(want.scales))
    w = np.asarray(want.buf).astype(np.int32)
    g = buf.astype(np.int32)
    assert g.shape == w.shape == (2 * (NDAYS + 24), 256)
    np.testing.assert_array_equal(g == -32768, w == -32768)
    d = np.abs(g - w).reshape(2, NDAYS + 24, 256)
    for v in range(2):
        step, se_step = fs[6 * v], fs[6 * v + 4]
        for rows in (d[v, :NDAYS], d[v, NDAYS : NDAYS + 12]):
            assert np.quantile(rows, 0.99) <= 1 + int(5e-3 / step)
            assert rows.max() <= 1 + int(2e-2 / step)
        assert d[v, NDAYS + 12 :].max() <= 1 + int(2e-3 / se_step)
    a, b = g[:NDAYS], g[NDAYS + 24 : 2 * NDAYS + 24]
    both = (a != -32768) & (b != -32768)
    assert both.any() and not np.any(both & (b < a))
    # the per-variable sizes are in effect: the uniform step gives other dailies
    uniform = tpoint.interp_tile_pair_flat(
        pair_inputs_from_numpy(pair, "cpu"), layout.slot_of_day, InterpParams(k_neighbors=K),
        shared_validity=shared_validity, fixed_scales=fs, reconcile=True,
    ).buf.numpy()
    assert np.mean(uniform[:NDAYS] != buf[:NDAYS]) > 0.5


def test_pair_at_per_variable_sizes_matches_each_variable_alone(case):
    """A tile-pair at tmin (k, ka) = (48, 16) and tmax (16, 32), as a tile
    of the benchmark's ``grid.optim-k`` runs: neighbours selected once at
    48, each variable's systems and gain rows on its own prefixes, against
    each variable run alone at its own sizes (tmax selected at 32). The
    same stations in the same order, so only the rounding of the padded
    slots' zeros parts them: within 1e-4 C, se within 1e-5 C. The step
    records one ``step.krig`` span a launch, keyed (slots read, k_normal,
    k_anom, systems): two here, one on a one-size tile."""
    from topotpu_torch.core.config import InterpParams as TInterp
    from topotpu_torch.utils.profiling import recording

    pair, _ = case
    tpair = pair_inputs_from_numpy(pair, "cpu")
    params = TInterp(k_neighbors=48, k_neighbors_anom=32, k_per_var=(48, 16),
                     ka_per_var=(16, 32))
    with recording() as recs:
        got = tpoint.interp_tile_pair(tpair, params, True)
    assert [r.key for r in recs if r.name == "step.krig"] == [(48, 48, 16, 12),
                                                              (48, 16, 32, 12)]
    geom = tpair.geom
    alone = [
        tpoint.interp_tile(geom, TInterp(k_neighbors=48, k_neighbors_anom=16), True),
        tpoint.interp_tile(
            geom._replace(stn_norm=tpair.b.norm, stn_vario=tpair.b.vario,
                          stn_anoms=tpair.b.anoms),
            TInterp(k_neighbors=32, k_per_var=(16,), ka_per_var=(32,)), True),
    ]
    for g, w in zip(got, alone):
        np.testing.assert_array_equal(g.ok.numpy(), w.ok.numpy())
        np.testing.assert_allclose(g.normal.numpy(), w.normal.numpy(), atol=1e-4)
        np.testing.assert_allclose(g.se.numpy(), w.se.numpy(), atol=1e-5)
        np.testing.assert_allclose(g.daily.numpy(), w.daily.numpy(), atol=1e-4)
    # the sizes reach the result: tmax at k = 16 is not tmax at k = 48
    assert np.abs(got[1].normal.numpy() - tpoint.interp_tile_pair(
        tpair, TInterp(k_neighbors=48, k_neighbors_anom=32), True)[1].normal.numpy()).max() > 0.05

    with recording() as recs:
        tpoint.interp_tile_pair(tpair, TInterp(k_neighbors=16), True)
    assert [r.key for r in recs if r.name == "step.krig"] == [(16, 16, 16, 24)]


def test_zero_month_validity_flags_that_month(case):
    """No valid station in one month: that month is not ok (sentinels in
    its normals and days); the other months stay finite."""
    pair, layout = case
    valid = pair.geom.stn_valid.copy()
    valid[:, 6] = False
    geom = tile_inputs_from_numpy(pair.geom._replace(stn_valid=valid), "cpu")
    res = tpoint.interp_tile(geom, InterpParams(k_neighbors=K))
    ok = res.ok.numpy()
    assert not ok[6].any()
    assert ok[np.arange(12) != 6].all()
    others = np.arange(12) != 6
    assert np.isfinite(res.normal.numpy()[others]).all()
    assert np.isfinite(res.daily.numpy()[others]).all()

    flat = tpoint.interp_tile_flat(
        geom, layout.slot_of_day, InterpParams(k_neighbors=K),
        fixed_scales=fixed_scales_from_config(TopoConfig(), 1),
    ).buf.numpy()
    # a day slot outside the month-grouped axis is refused before any work
    bad = layout.slot_of_day.copy()
    bad[5] = 12 * layout.dpm
    with pytest.raises(ValueError, match="slot_of_day"):
        tpoint.interp_tile_flat(geom, bad, InterpParams(k_neighbors=K),
                                fixed_scales=fixed_scales_from_config(TopoConfig(), 1))
    july = layout.month_idx == 6
    assert (flat[:NDAYS][july] == -32768).all()
    assert (flat[:NDAYS][~july] != -32768).all()
    assert (flat[NDAYS + 6] == -32768).all() and (flat[NDAYS + 12 + 6] == -32768).all()


@pytest.mark.parametrize("reconcile", [True, False])
def test_flat_fixed_takes_slot_and_scales_as_device_tensors(case, reconcile):
    """``slot_of_day`` (int32) and ``fixed_scales`` (float32) given as tensors
    on the inputs' device are used as they are: the product is exactly the
    one the host arrays give, both variables and one. The host path still
    refuses an out-of-range slot; a tensor of another dtype is refused."""
    pair, layout = case
    params = InterpParams(k_neighbors=K)
    tpair = pair_inputs_from_numpy(pair, "cpu")
    fs = fixed_scales_from_config(TopoConfig(), 2)
    slot_t = torch.as_tensor(layout.slot_of_day.astype(np.int32))
    host = tpoint.interp_tile_pair_flat(tpair, layout.slot_of_day, params, True,
                                        fixed_scales=fs, reconcile=reconcile)
    dev = tpoint.interp_tile_pair_flat(tpair, slot_t, params, True,
                                       fixed_scales=torch.as_tensor(fs), reconcile=reconcile)
    assert torch.equal(host.buf, dev.buf) and torch.equal(host.scales, dev.scales)
    one = [tpoint.interp_tile_flat(tpair.geom, s, params, True, fixed_scales=f).buf
           for s, f in ((layout.slot_of_day, fs[:6]), (slot_t, torch.as_tensor(fs[:6])))]
    assert torch.equal(*one)

    bad = layout.slot_of_day.copy()
    bad[3] = -1
    with pytest.raises(ValueError, match="slot_of_day"):
        tpoint.interp_tile_pair_flat(tpair, bad, params, True, fixed_scales=fs)
    with pytest.raises(ValueError, match="slot_of_day"):
        tpoint.interp_tile_pair_flat(tpair, slot_t.long(), params, True, fixed_scales=fs)
    with pytest.raises(ValueError, match="fixed_scales"):
        tpoint.interp_tile_pair_flat(tpair, slot_t, params, True,
                                     fixed_scales=torch.as_tensor(fs[:6]))
