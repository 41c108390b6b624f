"""The port's fused regression-kriging normals against the JAX package.

Identical float32 inputs (a synthetic world, neighbourhoods chosen in
float64 numpy) go through the JAX function and the port's counterpart on the
CPU: the Pallas kernel ``krig_normals_fused`` in interpret mode, and the JAX
``krig_normals`` + ``anomaly_gain_rows`` path. The port's kernel wrapper on
CPU tensors runs its plain version. Tolerances: normal and trend rtol 1e-4,
atol 1e-3 (2e-3 at k > 32); variance rtol 1e-3, atol 1e-4; variogram and
gains rtol 1e-4, atol 1e-5; ok flags identical. The JAX kernel's Taylor asin
differs from the exact asin by under 1e-6 relative, which is inert here.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from topotpu.interp.anoms import anomaly_gain_rows as jax_gain_rows
from topotpu.interp.normals import krig_normals as jax_krig_normals
from topotpu.io.synthetic import make_world
from topotpu.kernels.pallas_krig import krig_normals_fused as jax_krig_fused
from topotpu_torch.interp.normals import krig_normals, krig_normals_and_gains
from topotpu_torch.io.synthetic import krig_rows_from_world
from topotpu_torch.kernels import krig_normals as kn

torch.set_num_threads(1)

ROW_NAMES = ("xyz3k", "dist_t", "mask_t", "covs_t", "cell_t", "norm_t",
             "vario_t", "acovs_t")


def _rows(seed, C, k, qa=3, holes=True):
    """Kernel inputs. With ``holes``: station 5 invalid, the last slot of
    every 7th cell masked, and one cell left with fewer than min_neighbors."""
    rng = np.random.default_rng(seed)
    world = make_world(rng, nrows=30, ncols=30, n_stations=80, ndays=30)
    rows, cols = rng.integers(0, 30, C), rng.integers(0, 30, C)
    valid = np.ones(80, bool)
    valid[5] = not holes
    r = krig_rows_from_world(world, rows, cols, k, month=0, stn_valid=valid)
    if holes:
        r["mask_t"][-1, ::7] = 0.0
        r["mask_t"][2:, 3] = 0.0  # cell 3: two valid slots < min_neighbors = 3
        r["dist_t"] *= r["mask_t"]
    r["acovs_t"] = r["acovs_t"][: qa * k]
    return [r[n] for n in ROW_NAMES]


def _assert_rows(got, want, k):
    """Values are compared on the cells both flag ok: a cell with fewer
    valid neighbours than WLS parameters has an undetermined trend, and the
    tile step packs it as a sentinel."""
    np.testing.assert_array_equal(got[2], want[2])
    ok = want[2] > 0.5
    atol_n = 2e-3 if k > 32 else 1e-3
    for row in (0, 3):  # normal, trend
        np.testing.assert_allclose(got[row, ok], want[row, ok], rtol=1e-4, atol=atol_n)
    np.testing.assert_allclose(got[1, ok], want[1, ok], rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(got[4:7], want[4:7], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got[8:, ok], want[8:, ok], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize(
    "k, weight_kernel",
    [(16, "bisquare"), (16, "gaussian"), (16, "uniform"), (64, "bisquare")],
)
def test_ref_matches_pallas_kernel_interpret(k, weight_kernel):
    rows = _rows(1, C=128, k=k)
    want = np.asarray(jax_krig_fused(
        *map(jnp.asarray, rows), weight_kernel=weight_kernel, interpret=True,
    ))
    got = kn.krig_normals_fused(
        *map(torch.from_numpy, rows), weight_kernel=weight_kernel
    ).numpy()
    assert got.shape == (8 + k, 128)
    assert got[2, 3] == 0.0  # too few neighbours: not ok
    _assert_rows(got, want, k)


@pytest.mark.parametrize("k", [32, 48])
def test_krig_normals_and_gains_match_jax(k):
    """The port's krig_normals / krig_normals_and_gains against the JAX jnp
    path (use_pallas="off") at k = 32 and 48, with 2 anomaly covariates."""
    C = 96
    xyz3k, dist_t, mask_t, covs_t, cell_t, norm_t, vario_t, acovs_t = _rows(
        2, C=C, k=k, qa=2
    )
    cells = lambda a, n: a.reshape(n, k, C).transpose(2, 1, 0)  # noqa: E731
    args = dict(
        dist=dist_t.T, mask=mask_t.T > 0.5, nbr_xyz=cells(xyz3k, 3),
        nbr_cov=cells(covs_t, 3), cell_cov=cell_t[:3].T,
        nbr_norm=norm_t.T, nbr_vario=cells(vario_t, 3),
    )
    anom, cell_anom = cells(acovs_t, 2), cell_t[3:5].T

    ref = jax_krig_normals(
        **{n: jnp.asarray(a) for n, a in args.items()}, use_pallas="off"
    )
    ref_g = jax_gain_rows(
        jnp.asarray(args["dist"]), jnp.asarray(args["mask"]),
        jnp.asarray(anom), jnp.asarray(cell_anom),
    )
    targs = {n: torch.from_numpy(np.ascontiguousarray(a)) for n, a in args.items()}
    got = krig_normals(**targs)
    got2, got_g = krig_normals_and_gains(
        **targs, anom_cov=torch.from_numpy(np.ascontiguousarray(anom)),
        cell_anom_cov=torch.from_numpy(np.ascontiguousarray(cell_anom)),
    )
    atol_n = 2e-3 if k > 32 else 1e-3
    ok = np.asarray(ref.ok)  # values compared where solvable (see _assert_rows)
    assert not ok[3] and ok.sum() == C - 1
    for res in (got, got2):
        np.testing.assert_array_equal(res.ok.numpy(), ok)
        for name, rtol, atol in (("normal", 1e-4, atol_n), ("trend", 1e-4, atol_n),
                                 ("variance", 1e-3, 1e-4), ("se", 1e-3, 1e-4)):
            np.testing.assert_allclose(
                getattr(res, name).numpy()[ok], np.asarray(getattr(ref, name))[ok],
                rtol=rtol, atol=atol, err_msg=name,
            )
        np.testing.assert_allclose(res.vario.numpy(), np.asarray(ref.vario),
                                   rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got_g.numpy()[ok], np.asarray(ref_g)[ok],
                               rtol=1e-4, atol=1e-5)
    # gains reproduce constants where the design is solvable
    np.testing.assert_allclose(got_g.numpy()[ok].sum(-1), 1.0, atol=2e-3)


def test_masked_slots_are_inert():
    """Masking a slot equals removing the station: the masked rows carry
    zero gain, and normal/variance equal a run on the unmasked prefix."""
    k = 16
    full = [torch.from_numpy(a) for a in _rows(3, C=64, k=k, holes=False)]
    xyz3k, dist_t, mask_t, covs_t, cell_t, norm_t, vario_t, acovs_t = full
    masked = list(full)
    masked[2] = mask_t.clone()
    masked[2][-4:] = 0.0
    masked[1] = dist_t * masked[2]
    got = kn.krig_normals_fused(*masked)
    assert torch.all(got[8 + k - 4 :] == 0.0)

    keep = lambda a, n: a.reshape(n, k, -1)[:, : k - 4].reshape(n * (k - 4), -1)  # noqa: E731
    prefix = [keep(xyz3k, 3), masked[1][: k - 4], mask_t[: k - 4], keep(covs_t, 3),
              cell_t, norm_t[: k - 4], keep(vario_t, 3), keep(acovs_t, 3)]
    want = kn.krig_normals_fused(*prefix)
    torch.testing.assert_close(got[:8], want[:8], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got[8 : 8 + k - 4], want[8:], rtol=1e-5, atol=1e-6)
