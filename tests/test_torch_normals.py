"""The port's ``interp/normals.py`` against the JAX package's.

Identical float32 inputs (a synthetic world, neighbourhoods chosen in
float64 numpy, the neighbours' covariates gathered as
``tests/test_normals_fused.py::_gathered_inputs`` gathers them) go through
``topotpu.interp.normals.krig_normals`` / ``krig_normals_and_gains`` on both
of its routes (the jnp path, ``use_pallas="off"``, and the Pallas kernel
``krig_normals_fused`` in interpret mode, ``use_pallas="on"``) and through
the port's functions on CPU tensors, where ``krig_normals_gathered`` runs
its plain version. The covariate designs: q trend and qa anomaly covariates
from 1 / 1 to 7 / 1, the widest the TPU kernel takes (q + qa <= 8).

Tolerances (``tests/test_torch_krig_normals.py``'s): normal and trend rtol
1e-4, atol 1e-3 (2e-3 at k > 32; at k = 8 a float64 run of the port's plain
version decides, with a 0.1 C cap, and so it does for the trend on five LST
months, whose columns share the elevation term: read on an AMD EPYC host,
every float32 route sits up to 4.8e-3 (the port), 8.6e-3 (jnp) and 7.7e-3 C
(Pallas) from float64 there); variance rtol 1e-3, atol 1e-4;
variogram and gains rtol 1e-4, atol 1e-5; ok flags identical; the gains of
a solvable cell sum to 1 within 2e-3 (``tests/test_normals_fused.py``'s).
Values are compared on the cells that are ok.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from topotpu.interp import normals as jnormals
from topotpu.io.synthetic import make_world
from topotpu.oracle.numpy_ref import haversine_km
from topotpu_torch.interp import normals as tnormals
from topotpu_torch.kernels import krig_normals as kn

torch.set_num_threads(1)

C = 48
FEW = 3  # the cell left with two valid slots, fewer than min_neighbors


def _gathered(seed, k, cov_cols, acov_cols, month=6, holes="default"):
    """Gathered float32 inputs of C cells: the port's operands in
    ``kn.GATHERED``'s order, as numpy. ``cov_cols`` / ``acov_cols`` name the
    trend and anomaly covariates (``elev``, ``tdi``, ``x``, ``y``, ``lstN``).
    Station 5 is invalid; with ``holes="default"`` the last slot of every 7th
    cell is masked and cell 3 keeps two valid slots, with ``"last"`` every
    cell's last slot is masked."""
    rng = np.random.default_rng(seed)
    world = make_world(rng, nrows=30, ncols=30, n_stations=80, ndays=30)
    S = world.n_stations
    rows, cols = rng.integers(0, 30, C), rng.integers(0, 30, C)
    lon, lat = world.grid.cell_lonlat(rows, cols)
    d = haversine_km(lon[:, None], lat[:, None], world.stn_lon[None], world.stn_lat[None])
    d[:, 5] = np.inf
    idx = np.argsort(d, axis=1, kind="stable")[:, :k]
    dist = np.take_along_axis(d, idx, axis=1)
    mask = np.isfinite(dist)
    if holes == "default":
        mask[::7, -1] = False
        mask[FEW, 2:] = False
    elif holes == "last":
        mask[:, -1] = False
    dist = np.where(mask, dist, 0.0)
    kx = 111.32 * np.cos(np.deg2rad(world.stn_lat.mean()))
    stn = dict(elev=world.stn_elev, tdi=world.stn_tdi, x=world.stn_lon * kx,
               y=world.stn_lat * 111.32,
               **{f"lst{m}": world.stn_lst[:, m] for m in range(12)})
    cell = dict(elev=world.elev[rows, cols], tdi=world.tdi[rows, cols], x=lon * kx,
                y=lat * 111.32, **{f"lst{m}": world.lst[m, rows, cols] for m in range(12)})
    lonr, latr = np.deg2rad(world.stn_lon), np.deg2rad(world.stn_lat)
    xyz = np.stack([np.cos(latr) * np.cos(lonr), np.cos(latr) * np.sin(lonr), np.sin(latr)], -1)
    vario = np.asarray(world.true_vario) * rng.uniform(0.8, 1.25, (S, 3))
    out = (dist, mask, xyz[idx], np.stack([stn[c][idx] for c in cov_cols], -1),
           np.stack([cell[c] for c in cov_cols], -1), world.stn_norm[idx, month], vario[idx],
           np.stack([stn[c][idx] for c in acov_cols], -1),
           np.stack([cell[c] for c in acov_cols], -1))
    return tuple(a if a.dtype == bool else np.ascontiguousarray(a, np.float32) for a in out)


def _jax(operands, gains, use_pallas, **kw):
    """The JAX package's function on the same arrays, results as numpy."""
    names = kn.GATHERED if gains else kn.GATHERED[:7]
    args = {n: jnp.asarray(a) for n, a in zip(names, operands)}
    if gains:
        res, g = jnormals.krig_normals_and_gains(**args, use_pallas=use_pallas, **kw)
    else:
        res, g = jnormals.krig_normals(**args, use_pallas=use_pallas, **kw), None
    return {f: np.asarray(getattr(res, f)) for f in res._fields}, g if g is None else np.asarray(g)


def _port(operands, gains, dtype=torch.float32, **kw):
    """The port's function on CPU tensors, results as numpy."""
    t = [torch.from_numpy(a) if a.dtype == bool else torch.from_numpy(a).to(dtype)
         for a in operands]
    if gains:
        res, g = tnormals.krig_normals_and_gains(*t, **kw)
    else:
        res, g = tnormals.krig_normals(*t[:7], **kw), None
    return {f: getattr(res, f).numpy() for f in res._fields}, g if g is None else g.numpy()


def _assert_close(got, want, k, mask, got64, collinear=False):
    """``got`` (the port's (result, gains)) against ``want`` (a JAX route's)
    with the tolerances of the module docstring; ``got64``: the port's plain
    version in float64, the arbiter below k = 16 and for a ``collinear``
    trend design."""
    (res, g), (wres, wg) = got, want
    np.testing.assert_array_equal(res["ok"], wres["ok"])
    ok = wres["ok"]
    atol_n = 2e-3 if k > 32 else 1e-3
    for name in ("normal", "trend"):
        a, b = res[name][ok], wres[name][ok]
        if k < 16 or collinear:
            # four or more trend columns on 8 neighbours, or columns that
            # share a term: float32 normal equations amplify rounding in both
            # packages alike, so float64 decides
            # (tests/test_torch_krig_normals.py::_assert_rows)
            ref = got64[0][name][ok]
            d_port, d_jax = np.abs(a - ref), np.abs(b - ref)
            for stat in (np.mean, lambda e: np.quantile(e, 0.95)):
                assert stat(d_port) <= 2 * stat(d_jax) + atol_n, (name, stat(d_port), stat(d_jax))
            assert np.abs(a - b).max() <= 0.1, name
            continue
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=atol_n, err_msg=name)
    for name in ("variance", "se"):
        np.testing.assert_allclose(res[name][ok], wres[name][ok], rtol=1e-3, atol=1e-4,
                                   err_msg=name)
    np.testing.assert_allclose(res["vario"], wres["vario"], rtol=1e-4, atol=1e-5)
    if wg is not None:
        assert g.shape == wg.shape == mask.shape
        np.testing.assert_allclose(g[ok], wg[ok], rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(g[ok].sum(-1), 1.0, atol=2e-3)
        assert (g[~mask] == 0.0).all()  # masked slots carry no gain


TREND3 = ("elev", "tdi", "lst0")
LST5 = ("elev", "tdi", "lst0", "lst1", "lst2", "lst3", "lst4")  # five months share elevation
CASES = [
    *[pytest.param(k, TREND3, ("elev", "tdi"), "bisquare", "default", id=f"q3qa2-k{k}")
      for k in (8, 16, 24, 48, 64)],
    pytest.param(16, ("elev",), ("elev",), "bisquare", "default", id="q1qa1-k16"),
    pytest.param(24, ("elev", "tdi", "lst6", "x", "y"), ("elev", "x", "y"), "bisquare",
                 "default", id="q5qa3-k24"),
    pytest.param(32, LST5, ("elev",), "bisquare", "default", id="q7qa1-k32-lst5"),
    pytest.param(32, ("elev", "tdi", "lst6", "x", "y", "lst0", "lst3"), ("elev",), "bisquare",
                 "default", id="q7qa1-k32"),
    *[pytest.param(16, TREND3, ("elev", "tdi"), wk, "default", id=f"q3qa2-k16-{wk}")
      for wk in ("gaussian", "uniform")],
    pytest.param(16, TREND3, ("elev", "tdi"), "bisquare", "last", id="q3qa2-k16-last-masked"),
]


@pytest.mark.parametrize("k, cov_cols, acov_cols, weight_kernel, holes", CASES)
def test_normals_and_gains_match_jax(k, cov_cols, acov_cols, weight_kernel, holes):
    """``krig_normals_and_gains`` and ``krig_normals`` against both JAX
    routes; the bisquare case at k = 16 is the default case's, whose cell 3
    has fewer valid slots than ``min_neighbors``."""
    operands = _gathered(k, k, cov_cols, acov_cols, holes=holes)
    mask = operands[1]
    kw = dict(weight_kernel=weight_kernel)
    collinear = cov_cols == LST5
    got = _port(operands, True, **kw)
    got64 = _port(operands, True, dtype=torch.float64, **kw)
    for route in ("off", "on"):
        want = _jax(operands, True, route, **kw)
        _assert_close(got, want, k, mask, got64, collinear)
    if holes == "default":
        assert not got[0]["ok"][FEW] and got[0]["ok"].sum() == C - 1
    # without gains: the same heads (the kernel's dummy anomaly design does
    # not reach them), against both routes of the JAX function
    alone = _port(operands, False, **kw)
    for f in alone[0]:
        np.testing.assert_array_equal(alone[0][f], got[0][f], err_msg=f)
    for route in ("off", "on"):
        _assert_close(alone, _jax(operands, False, route, **kw), k, mask, got64, collinear)


def test_gathered_equals_indexed_on_the_indexed_design():
    """On the indexed entry's design (trend elev, tdi, lst_m; anomalies
    elev, x_km, y_km) one shared neighbourhood gives the gathered plain
    version the indexed one's head and gains."""
    from tests.test_torch_krig_normals import _indexed_case

    idx, dist, mask, table, cell = map(torch.from_numpy, _indexed_case(8, 64, 24, False))
    for m, v in ((0, 0), (6, 1), (11, 0)):
        head, gains = kn.krig_normals_indexed_ref(idx, dist, mask, table, cell, [(m, v)], True)
        c = kn.system_columns(table[idx[0]], cell, m, v)
        g_head, g_gains = kn.krig_normals_gathered_ref(
            dist[0], mask[0], c["xyz"], c["cov"], c["cell_cov"], c["norm"], c["vario"],
            c["acov"], c["cell_acov"])
        torch.testing.assert_close(g_head, head[0], rtol=0, atol=1e-6, equal_nan=True)
        torch.testing.assert_close(g_gains, gains[0], rtol=0, atol=1e-6, equal_nan=True)


def test_gathered_refuses_bad_arguments():
    operands = [torch.from_numpy(a) for a in _gathered(0, 8, TREND3, ("elev", "tdi"))]
    dist, mask, xyz, cov, ccov, norm, vario, acov, cacov = operands
    with pytest.raises(ValueError, match="q=7 trend and qa=2"):
        kn.krig_normals_gathered(dist, mask, xyz, cov.repeat(1, 1, 3)[..., :7],
                                 ccov.repeat(1, 3)[:, :7], norm, vario, acov, cacov)
    with pytest.raises(ValueError, match="q=0"):
        kn.krig_normals_gathered(dist, mask, xyz, cov[..., :0], ccov[:, :0], norm, vario,
                                 acov, cacov)
    with pytest.raises(ValueError, match="qa=0"):
        kn.krig_normals_gathered(*operands[:7], acov[..., :0], cacov[:, :0])
    with pytest.raises(ValueError, match="k=65"):
        wide = [t.repeat_interleave(9, dim=1)[:, :65] if t.dim() > 1 and t.shape[1] == 8
                else t for t in operands]
        wide[4], wide[8] = ccov, cacov
        kn.krig_normals_gathered(*wide)
    with pytest.raises(ValueError, match="cell_cov has shape"):
        kn.krig_normals_gathered(dist, mask, xyz, cov, ccov[:-1], norm, vario, acov, cacov)
    with pytest.raises(ValueError, match="nbr_vario has shape"):
        kn.krig_normals_gathered(*operands[:6], vario[..., :2], acov, cacov)
    with pytest.raises(ValueError, match="weight kernel"):
        kn.krig_normals_gathered(*operands, weight_kernel="tricube")
    assert kn.krig_normals_gathered.launches == 0  # CPU tensors: never the kernel
