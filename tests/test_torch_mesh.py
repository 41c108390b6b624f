"""The port's cell-sharded tile step (``topotpu_torch.dist.mesh``) against its
single-device step and against ``topotpu.dist.mesh``, on the CPU.

``tests/test_torch_point.py``'s world and cells (40 x 40 cells, 110
stations, 365 days, 256 cells drawn from a seed, k = 16), with one station
out in one month; var B is var A's normals + 0.2 C with anomalies x 0.5, so
the reconcile has work to do. Meshes of 1, 2, 4 and 8 shards list the CPU that
many times. Every sharded fn must equal the port's single-device step bit for
bit: the cells of a tile are independent, and the dynamic scales are the
min and max over the shards, which are exact. Against the JAX package's
sharded step on the conftest's 8-device CPU mesh, the tolerances are
``tests/test_torch_point.py``'s: identical ok flags and sentinels; normals
and dailies within one lattice step + 2e-3 C (normals) and 5e-3 C (dailies)
on 99 % of values and one step + 1e-2 C on all; se within one step +
2e-3 C.
"""

import jax
import numpy as np
import pytest
import torch

from topotpu.core.config import InterpParams, TopoConfig
from topotpu.core.dates import get_days_metadata
from topotpu.dist import mesh as jmesh
from topotpu.interp import point as jpoint
from topotpu.io.synthetic import make_world, tile_inputs_from_world
from topotpu_torch.dist import mesh as tmesh
from topotpu_torch.dist import multihost
from topotpu_torch.interp import point as tpoint
from topotpu_torch.interp.convert import fixed_scales_from_config, pair_inputs_from_numpy

torch.set_num_threads(1)

CPU = torch.device("cpu")
K = 16
NDAYS = 365
C = 256
SIZES = (1, 2, 4, 8)


@pytest.fixture(scope="module")
def case():
    world = make_world(np.random.default_rng(7), nrows=40, ncols=40, n_stations=110,
                       ndays=NDAYS)
    days = get_days_metadata("2015-01-01", "2015-12-31")
    cells = np.random.default_rng(3).choice(1600, C, replace=False)
    rows, cols = np.unravel_index(cells, (40, 40))
    ti, layout = tile_inputs_from_world(world, days.month_idx, rows, cols)
    ti = jax.tree_util.tree_map(np.asarray, ti)
    valid = ti.stn_valid.copy()
    valid[17, 4] = False  # one station out in one month: neighbourhoods a month
    ti = ti._replace(stn_valid=valid)
    pair = jpoint.PairTileInputs(
        geom=ti,
        b=jpoint.VarFields(norm=ti.stn_norm + np.float32(0.2), vario=ti.stn_vario,
                           anoms=ti.stn_anoms * np.float32(0.5)),
    )
    return pair, layout


def _mesh(n):
    return tmesh.make_mesh(devices=[CPU] * n)


def _equal(got, want):
    for name, g, w in zip(type(want)._fields, got, want):
        if w is None:
            assert g is None, name
        else:
            assert torch.equal(g, w), name


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("pack_daily", [False, True])
def test_sharded_tile_equals_single_device(case, n, pack_daily):
    pair, _ = case
    params = InterpParams(k_neighbors=K)
    geom = pair_inputs_from_numpy(pair, CPU).geom
    mesh = _mesh(n)
    got = tmesh.sharded_interp_tile(mesh, params, pack_daily=pack_daily)(
        tmesh.shard_tile_inputs(mesh, geom))
    want = tpoint.interp_tile(geom, params, pack_daily=pack_daily)
    _equal(got, want)
    assert got.daily.dtype == (torch.int16 if pack_daily else torch.float32)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("fixed", [False, True])
def test_sharded_flat_equals_single_device(case, n, fixed):
    pair, layout = case
    params = InterpParams(k_neighbors=K)
    geom = pair_inputs_from_numpy(pair, CPU).geom
    mesh = _mesh(n)
    fn = tmesh.sharded_interp_tile_flat(mesh, params, fixed=fixed)
    shards = tmesh.shard_tile_inputs(mesh, geom)
    if fixed:
        fs = fixed_scales_from_config(TopoConfig(), 1)
        got = fn(shards, layout.slot_of_day, fs)
        want = tpoint.interp_tile_flat(geom, layout.slot_of_day, params, fixed_scales=fs)
    else:
        got = fn(shards, layout.slot_of_day)
        want = tpoint.interp_tile_flat(geom, layout.slot_of_day, params)
    _equal(got, want)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("fixed", [False, True])
@pytest.mark.parametrize("shared_validity", [False, True])
def test_sharded_pair_flat_equals_single_device(case, n, fixed, shared_validity):
    """Both lattices with the reconcile, and the device tensors the engine
    passes (slot int32, fixed scales float32) as well as host arrays."""
    pair, layout = case
    if shared_validity:
        pair = pair._replace(geom=pair.geom._replace(stn_valid=np.ones_like(pair.geom.stn_valid)))
    params = InterpParams(k_neighbors=K)
    tpair = pair_inputs_from_numpy(pair, CPU)
    mesh = _mesh(n)
    fn = tmesh.sharded_interp_tile_pair_flat(mesh, params, shared_validity, fixed=fixed,
                                             reconcile=True)
    shards = tmesh.shard_pair_inputs(mesh, tpair)
    fs = fixed_scales_from_config(TopoConfig(), 2) if fixed else None
    want = tpoint.interp_tile_pair_flat(tpair, layout.slot_of_day, params, shared_validity,
                                        fixed_scales=fs, reconcile=True)
    slot_t = torch.as_tensor(layout.slot_of_day.astype(np.int32))
    for slot, scales in ((layout.slot_of_day, fs),
                         (slot_t, None if fs is None else torch.as_tensor(fs))):
        got = fn(shards, slot, scales) if fixed else fn(shards, slot)
        _equal(got, want)


def test_fixed_lattice_makes_no_cross_shard_reduction(case):
    """The dynamic scales reduce once a step over the shards; the fixed
    lattice never (the JAX package asserts the same of its compiled
    program's collectives)."""
    pair, layout = case
    params = InterpParams(k_neighbors=K)
    tpair = pair_inputs_from_numpy(pair, CPU)
    mesh = _mesh(4)
    shards = tmesh.shard_pair_inputs(mesh, tpair)
    fs = fixed_scales_from_config(TopoConfig(), 2)
    before = tmesh._pmin_pmax.calls
    tmesh.sharded_interp_tile_pair_flat(mesh, params, fixed=True, reconcile=True)(
        shards, layout.slot_of_day, fs)
    tmesh.sharded_interp_tile_flat(mesh, params, fixed=True)(
        tuple(s.geom for s in shards), layout.slot_of_day, fs[:6])
    tmesh.sharded_interp_tile(mesh, params)(tuple(s.geom for s in shards))
    assert tmesh._pmin_pmax.calls == before
    tmesh.sharded_interp_tile_pair_flat(mesh, params, reconcile=True)(shards, layout.slot_of_day)
    tmesh.sharded_interp_tile(mesh, params, pack_daily=True)(tuple(s.geom for s in shards))
    assert tmesh._pmin_pmax.calls == before + 2
    # one shard of one process has nothing to reduce
    one = tmesh.make_mesh(devices=[CPU])
    tmesh.sharded_interp_tile_pair_flat(one, params, reconcile=True)(
        tmesh.shard_pair_inputs(one, tpair), layout.slot_of_day)
    assert tmesh._pmin_pmax.calls == before + 2


def test_specs_and_shards():
    specs = tmesh.tile_input_specs()
    assert [f for f in specs._fields if getattr(specs, f) == tmesh.CELL_AXIS] == list(
        tmesh._CELL_FIELDS)
    assert set(tmesh.pair_input_specs().b) == {None}
    mesh = _mesh(4)
    assert mesh.axis_names == ("cells",) and mesh.size == 4
    assert [(s.start, s.stop) for s in mesh.shard_slices(16)] == [(0, 4), (4, 8), (8, 12),
                                                                 (12, 16)]
    assert len(tmesh.make_mesh(2, devices=[CPU] * 8).devices) == 2


def test_cells_must_divide_by_the_mesh(case):
    pair, layout = case
    geom = pair_inputs_from_numpy(pair, CPU).geom
    with pytest.raises(ValueError, match="do not split over a mesh of 3"):
        tmesh.shard_tile_inputs(_mesh(3), geom)
    fn = tmesh.sharded_interp_tile(_mesh(2), InterpParams(k_neighbors=K))
    with pytest.raises(ValueError, match="shards"):
        fn(geom)
    # as in JAX, which cannot shard 256 cells over 3 devices either
    with pytest.raises(ValueError):
        jmesh.shard_tile_inputs(jmesh.make_mesh(3), pair.geom)


def _decode(buf, scales, v):
    """Var ``v``'s (daily, normal, se) of a flat pair buffer, NaN where
    sentinel, each with its lattice step."""
    rows = buf.astype(np.float64).reshape(2, NDAYS + 24, C)[v]
    sc = np.asarray(scales, np.float64)[6 * v : 6 * v + 6]
    out = []
    for part, (s, o) in zip((rows[:NDAYS], rows[NDAYS : NDAYS + 12], rows[NDAYS + 12 :]),
                            sc.reshape(3, 2)):
        out.append((np.where(part == -32768, np.nan, part * s + o), s))
    return out


@pytest.mark.parametrize("fixed", [False, True])
def test_pair_flat_matches_jax_mesh(case, fixed):
    """The port's sharded pair step on 8 CPU shards against the JAX
    package's on the 8-device CPU mesh; the dynamic scales are each
    package's own, so values are compared decoded, each on its lattice."""
    pair, layout = case
    params = InterpParams(k_neighbors=K)
    fs = fixed_scales_from_config(TopoConfig(), 2)
    jm = jmesh.make_mesh(8)
    jfn = jmesh.sharded_interp_tile_pair_flat(jm, params, fixed=fixed, reconcile=True)
    jargs = (jmesh.shard_pair_inputs(jm, pair), layout.slot_of_day) + ((fs,) if fixed else ())
    want = jfn(*jargs)
    mesh = _mesh(8)
    tfn = tmesh.sharded_interp_tile_pair_flat(mesh, params, fixed=fixed, reconcile=True)
    targs = (tmesh.shard_pair_inputs(mesh, pair_inputs_from_numpy(pair, CPU)),
             layout.slot_of_day) + ((fs,) if fixed else ())
    got = tfn(*targs)
    g_buf, w_buf = got.buf.numpy(), np.asarray(want.buf)
    assert g_buf.shape == w_buf.shape == (2 * (NDAYS + 24), C)
    np.testing.assert_array_equal(g_buf == -32768, w_buf == -32768)
    if fixed:
        np.testing.assert_array_equal(got.scales.numpy(), np.asarray(want.scales))
    else:
        np.testing.assert_allclose(got.scales.numpy(), np.asarray(want.scales), rtol=1e-3,
                                   atol=1e-5)
    for v in range(2):
        planes = zip(_decode(g_buf, got.scales.numpy(), v), _decode(w_buf, want.scales, v),
                     (5e-3, 2e-3, 2e-3), (1e-2, 1e-2, 2e-3))
        for (g, g_step), (w, w_step), bulk, cap in planes:
            err = np.abs(g - w)[~np.isnan(w)]
            step = max(g_step, w_step)
            assert np.quantile(err, 0.99) <= step + bulk
            assert err.max() <= step + cap


def test_sharded_tile_matches_jax_mesh(case):
    """``sharded_interp_tile`` with packed dailies on 8 shards against the
    JAX package's on its 8-device mesh: ok flags identical, normals, se and
    the decoded dailies within the module's tolerances."""
    pair, _ = case
    params = InterpParams(k_neighbors=K)
    jm = jmesh.make_mesh(8)
    want = jmesh.sharded_interp_tile(jm, params, pack_daily=True)(
        jmesh.shard_tile_inputs(jm, pair.geom))
    mesh = _mesh(8)
    got = tmesh.sharded_interp_tile(mesh, params, pack_daily=True)(
        tmesh.shard_tile_inputs(mesh, pair_inputs_from_numpy(pair, CPU).geom))
    np.testing.assert_array_equal(got.ok.numpy(), np.asarray(want.ok))
    np.testing.assert_allclose(got.se.numpy(), np.asarray(want.se), atol=2e-3)
    for g, w, bulk in ((got.normal.numpy(), np.asarray(want.normal), 2e-3),):
        err = np.abs(g.astype(np.float64) - w)
        assert np.quantile(err, 0.99) <= bulk and err.max() <= 1e-2
    steps = (float(got.daily_scale), float(want.daily_scale))
    dec = [np.where(d == -32768, np.nan, d.astype(np.float64) * s + float(o))
           for d, s, o in ((got.daily.numpy(), steps[0], got.daily_offset),
                           (np.asarray(want.daily), steps[1], want.daily_offset))]
    np.testing.assert_array_equal(np.isnan(dec[0]), np.isnan(dec[1]))
    err = np.abs(dec[0] - dec[1])[~np.isnan(dec[1])]
    assert np.quantile(err, 0.99) <= max(steps) + 5e-3 and err.max() <= max(steps) + 1e-2


def test_global_mesh_and_coordinator_in_one_process(monkeypatch):
    """Without a process group: the global mesh is the local one (the CPU
    under TOPOTPU_PLATFORM=cpu), the process is the coordinator, the barrier
    returns; without TOPOTPU_PLATFORM and without a card, meshes raise
    rather than take the CPU."""
    monkeypatch.setenv("TOPOTPU_PLATFORM", "cpu")
    mesh = multihost.global_mesh()
    assert mesh.devices == (CPU,) and mesh.group is None
    assert mesh.axis_names == ("cells",) and mesh.size == 1
    assert multihost.is_coordinator()
    multihost.barrier("stage")
    monkeypatch.delenv("TOPOTPU_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (multihost.global_mesh, multihost.local_mesh, tmesh.make_mesh):
        with pytest.raises(RuntimeError, match="no CUDA device is available"):
            make()


@pytest.mark.parametrize("gpus,env,rank_world,want", [
    (4, {}, None, [0, 1, 2, 3]),                                   # one process: all
    (4, {"LOCAL_WORLD_SIZE": "2", "LOCAL_RANK": "1"}, None, [2, 3]),  # torchrun's share
    (1, {"LOCAL_WORLD_SIZE": "2", "LOCAL_RANK": "1"}, None, [0]),     # ranks share one card
    (8, {}, (3, 4), [6, 7]),                                       # N CLI processes, one host
    (2, {}, (2, 3), [0]),                                          # fewer cards than ranks
])
def test_local_mesh_takes_this_processs_share(monkeypatch, gpus, env, rank_world, want):
    """The share of the process's place in the group (or of the launcher's
    local rank), and a share of one card made current: that of
    ``local_mesh`` and, before the group has formed, that of
    ``local_devices`` given the place."""
    monkeypatch.delenv("TOPOTPU_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: gpus)
    current = []
    monkeypatch.setattr(torch.cuda, "set_device", current.append)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    assert [d.index for d in multihost.local_devices(*(rank_world or (0, 1)))] == want
    if rank_world is not None:
        monkeypatch.setattr(multihost, "_group_size", lambda: rank_world[1])
        monkeypatch.setattr(multihost.dist, "get_rank", lambda: rank_world[0])
    assert [d.index for d in multihost.local_mesh().devices] == want
    assert len(multihost.local_mesh(1).devices) == 1
    made = [torch.device("cuda", want[0])] if len(want) == 1 else []
    assert current == made * 3
