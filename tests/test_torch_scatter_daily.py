"""The port's daily-anomaly contraction against the JAX package: the plain
version (and the wrapper on CPU tensors, which runs it) against the Pallas
``scatter_daily_matmul`` in interpret mode, with duplicate indices, at the
cases of ``tests/test_pallas_scatter.py``; rtol and atol 1e-5. The port takes
(C, k) operands with a bool mask; the Pallas kernel's (k, C) float planes
are laid out here.

And the packed entry (on the CPU its plain version) against an independent
float64 numpy evaluation of its formula: identical sentinel positions, at
most one int16 count apart (a float32 sum next to a rounding boundary may
land on the other side), no crossing left where both variables are ok.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from topotpu.interp.anoms import predict_daily_gathered as j_gathered
from topotpu.kernels.pallas_scatter import scatter_daily_matmul
from topotpu_torch.interp.anoms import predict_daily, predict_daily_gathered, scatter_gains
from topotpu_torch.kernels.scatter_daily import (
    scatter_daily,
    scatter_daily_packed,
    scatter_daily_packed_ref,
    scatter_daily_ref,
)

torch.set_num_threads(1)
T = torch.from_numpy


def _case(seed, C, S, k, D):
    rng = np.random.default_rng(seed)
    g = rng.normal(size=(C, k)).astype(np.float32)
    idx = rng.integers(0, S, (C, k)).astype(np.int32)
    idx[:, 1] = idx[:, 0]  # duplicates accumulate
    mask = rng.uniform(size=(C, k)) > 0.1
    Y = rng.normal(size=(S, D)).astype(np.float32)
    return g, idx, mask, Y


def _pallas(idx, g, mask, Y):
    """The Pallas kernel in interpret mode on its own (k, C) planes."""
    planes = (idx.T.copy(), g.T.copy(), mask.T.astype(np.float32), Y)
    return np.asarray(scatter_daily_matmul(*map(jnp.asarray, planes), interpret=True))


@pytest.mark.parametrize("C, S, k, D", [(1024, 96, 12, 31), (512, 128, 8, 2977)])
def test_matches_pallas_interpret(C, S, k, D):
    g, idx, mask, Y = _case(0, C, S, k, D)
    want = _pallas(idx, g, mask, Y)
    for fn in (scatter_daily_ref, scatter_daily):
        got = fn(T(idx), T(g), T(mask), T(Y))
        assert got.shape == (C, D)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_any_cell_count_and_the_anoms_forms_agree():
    """Any C (no multiple-of-512 rule); the port's predict_daily_gathered,
    scatter_gains + predict_daily and the JAX gather form all agree."""
    C, S, k, D = 300, 40, 16, 62
    g, idx, mask, Y = _case(1, C, S, k, D)
    got = scatter_daily(T(idx), T(g), T(mask), T(Y))
    want = np.asarray(j_gathered(jnp.asarray(g), jnp.asarray(idx), jnp.asarray(mask),
                                 jnp.asarray(Y)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    gathered = predict_daily_gathered(T(g), T(idx), T(mask), T(Y))
    dense = predict_daily(scatter_gains(T(g), T(idx), T(mask), S), T(Y))
    np.testing.assert_allclose(gathered.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(dense.numpy(), want, rtol=1e-5, atol=1e-5)


def test_stray_indices_contribute_nothing():
    """An index outside [0, S), in a masked slot or not, adds nothing: the
    plain version against the Pallas kernel (whose compare-and-accumulate
    scatter never matches it) and against the same input with those slots
    masked; int64 indices answer as int32."""
    C, S, k, D = 512, 48, 8, 40
    g, idx, mask, Y = _case(3, C, S, k, D)
    idx[::3, 0] = -1
    idx[1::5, 2] = S
    idx[2::7, k - 1] = S + 7
    stray = (idx < 0) | (idx >= S)
    assert (stray & mask).sum() > 50 and (stray & ~mask).sum() > 5
    want = _pallas(idx, g, mask, Y)
    for fn in (scatter_daily_ref, scatter_daily):
        got = fn(T(idx), T(g), T(mask), T(Y)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        masked = fn(T(np.where(stray, 0, idx)), T(g), T(mask & ~stray), T(Y)).numpy()
        np.testing.assert_array_equal(got, masked)
    got64 = scatter_daily_ref(T(idx.astype(np.int64)), T(g), T(mask), T(Y)).numpy()
    np.testing.assert_array_equal(got64, got)


def test_wrapper_refuses_mixed_devices():
    g, idx, mask, Y = _case(2, 8, 4, 3, 5)
    with pytest.raises(ValueError, match="several devices"):
        scatter_daily(T(idx), T(g), T(mask), T(Y).to("meta"))


# ---------------------------------------------------------------------------
# the packed entry
# ---------------------------------------------------------------------------

SCALE, OFFSET = 160.0 / 65500.0, 10.0


def _packed_case(seed, C, S, k, dpm, ndays, N, G, V):
    """Packed-entry inputs as numpy: pad slots (ndays < 12 * dpm, months of
    unequal length), duplicate and stray indices, masked slots, not-ok cells,
    and with V = 2 a second variable that crosses the first on part of the
    days."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, S, (N, C, k)).astype(np.int64)
    idx[..., 1] = idx[..., 0]
    idx[:, ::5, 0] = -1
    idx[:, 1::7, k - 1] = S
    idx[:, 2::9, 2] = S + 7
    mask = rng.uniform(size=(N, C, k)) > 0.1
    gains = (rng.normal(size=(G, N, C, k)) * 0.3).astype(np.float32)
    Y = (rng.normal(size=(V, S, 12 * dpm)) * 3.0).astype(np.float32)
    normal = (rng.normal(size=(V, 12, C)) * 5.0 + OFFSET).astype(np.float32)
    if V == 2:
        normal[1] = normal[0] + 0.3
    normal[0, :, 0] = 1.0e4  # clips to the lattice's upper bound
    ok = rng.uniform(size=(V, 12, C)) > 0.15
    ok[0, :, 0] = True
    months = np.sort(rng.integers(0, 12, ndays))  # a calendar: days of a month in a row
    while np.bincount(months, minlength=12).max() > dpm:
        months = np.sort(rng.integers(0, 12, ndays))
    pos = np.zeros(12, int)
    slot = np.empty(ndays, np.int32)
    for t, m in enumerate(months):
        slot[t] = m * dpm + pos[m]
        pos[m] += 1
    slot = slot[rng.permutation(ndays)]  # any one-to-one day -> slot map is taken
    scales = np.array([[SCALE, OFFSET], [SCALE * 0.5, OFFSET - 1.0]], np.float32)[:V]
    return dict(idx=idx, mask=mask, gains=gains, Y=Y, normal=normal, ok=ok,
                slot_of_day=slot, scales=scales)


def _packed_numpy(a, reconcile):
    """The packed entry's formula in float64 numpy loops over (variable,
    day): the sum over the k slots, + normal, reconcile, quantise."""
    N, C, k = a["idx"].shape
    G = a["gains"].shape[0]
    V, S, D = a["Y"].shape
    dpm = D // 12
    ndays = len(a["slot_of_day"])
    x = np.zeros((V, ndays, C))
    okd = np.zeros((V, ndays, C), bool)
    cells = np.arange(C)
    for v in range(V):
        for t, s in enumerate(a["slot_of_day"]):
            m = s // dpm
            n = 0 if N == 1 else m
            acc = a["normal"][v, m].astype(np.float64)
            for j in range(k):
                i = a["idx"][n, :, j]
                use = a["mask"][n, :, j] & (i >= 0) & (i < S)
                y = a["Y"][v, np.clip(i, 0, S - 1), s].astype(np.float64)
                acc = acc + np.where(use, a["gains"][v if G > 1 else 0, n, cells, j] * y, 0.0)
            x[v, t] = acc
            okd[v, t] = a["ok"][v, m]
    if reconcile:
        bad = okd[0] & okd[1] & (x[1] < x[0])
        mid = 0.5 * (x[0] + x[1])
        x[0], x[1] = np.where(bad, mid, x[0]), np.where(bad, mid, x[1])
    sc = a["scales"].astype(np.float64)
    q = np.clip(np.rint((x - sc[:, 1, None, None]) / sc[:, 0, None, None]), -32767, 32767)
    return np.where(okd, q, -32768).astype(np.int64), x, okd


@pytest.mark.parametrize("reconcile", [False, True], ids=["plain", "reconcile"])
@pytest.mark.parametrize("G", [1, "V"])
@pytest.mark.parametrize("N", [1, 12])
@pytest.mark.parametrize("V", [1, 2])
def test_packed_matches_float64_formula(V, N, G, reconcile):
    C, S, k, dpm, ndays = 37, 20, 6, 7, 61
    a = _packed_case(10 + V + N, C, S, k, dpm, ndays, N, V if G == "V" else 1, V)
    if reconcile and V == 1:  # nothing to reconcile: refused, and the buffer left alone
        out = torch.full((ndays + 24, C), 7, dtype=torch.int16)
        with pytest.raises(ValueError, match="reconcile"):
            scatter_daily_packed(*(T(a[n]) for n in ("idx", "mask", "gains", "Y", "normal", "ok",
                                                     "slot_of_day", "scales")), out, reconcile=True)
        assert (out == 7).all()
        return
    want, x, okd = _packed_numpy(a, reconcile)
    fill = 12345
    for fn in (scatter_daily_packed_ref, scatter_daily_packed):
        out = torch.full((V * (ndays + 24), C), fill, dtype=torch.int16)
        got = fn(*(T(a[n]) for n in ("idx", "mask", "gains", "Y", "normal", "ok",
                                     "slot_of_day", "scales")), out, reconcile=reconcile)
        assert got is out and scatter_daily_packed.launches == 0
        rows = out.numpy().astype(np.int64).reshape(V, ndays + 24, C)
        assert (rows[:, ndays:] == fill).all()  # the normal and se rows are not touched
        daily = rows[:, :ndays]
        np.testing.assert_array_equal(daily == -32768, want == -32768)
        assert (~okd).sum() > 0 and (daily == 32767).sum() > 0
        assert np.abs(daily - want).max() <= 1
        assert np.mean(daily != want) < 0.01
        if V == 2 and reconcile:
            crossed = okd[0] & okd[1] & (x[1] <= x[0])
            assert crossed.sum() > 20
            both = (np.abs(daily) < 32767).all(0)  # both ok, neither clipped
            q1 = daily[1] * a["scales"][1, 0] + a["scales"][1, 1]
            q0 = daily[0] * a["scales"][0, 0] + a["scales"][0, 1]
            # decoded on each variable's own lattice: never apart by more than a step
            assert not np.any(both & (q1 < q0 - a["scales"][0, 0]))


def test_packed_shared_lattice_leaves_no_crossing():
    """With one lattice for both variables (the production mode) the
    reconciled midpoint lands on one int16 point: no q_1 < q_0 where both
    are ok."""
    a = _packed_case(5, 50, 16, 5, 31, 200, 1, 1, 2)
    a["scales"][1] = a["scales"][0]
    ndays, C = 200, 50
    out = torch.empty((2 * (ndays + 24), C), dtype=torch.int16)
    scatter_daily_packed(*(T(a[n]) for n in ("idx", "mask", "gains", "Y", "normal", "ok",
                                             "slot_of_day", "scales")), out, reconcile=True)
    rows = out.numpy().astype(np.int64).reshape(2, ndays + 24, C)[:, :ndays]
    both = (rows[0] != -32768) & (rows[1] != -32768)
    _, x, okd = _packed_numpy(a, False)
    assert (okd[0] & okd[1] & (x[1] < x[0])).sum() > 100  # there were crossings
    assert not np.any(both & (rows[1] < rows[0]))


def test_packed_refuses_bad_arguments():
    a = _packed_case(6, 9, 8, 3, 4, 20, 1, 1, 2)
    names = ("idx", "mask", "gains", "Y", "normal", "ok", "slot_of_day", "scales")
    out = torch.empty((2 * 44, 9), dtype=torch.int16)

    def call(reconcile=False, out=out, **swap):
        args = {n: T(a[n]) for n in names}
        args.update(swap)
        return scatter_daily_packed(*(args[n] for n in names), out, reconcile=reconcile)

    with pytest.raises(ValueError, match="neighbourhoods"):
        call(idx=T(a["idx"]).repeat(2, 1, 1), mask=T(a["mask"]).repeat(2, 1, 1))
    with pytest.raises(ValueError, match="gains"):
        call(gains=T(a["gains"]).repeat(3, 1, 1, 1))
    with pytest.raises(ValueError, match="Y of shape"):
        call(Y=T(a["Y"])[:, :, :47])
    with pytest.raises(ValueError, match="out has shape"):
        call(out=out[:-1])
    with pytest.raises(ValueError, match="normal has shape"):
        call(normal=T(a["normal"])[:, :11])
    with pytest.raises(ValueError, match="several devices"):
        call(scales=T(a["scales"]).to("meta"))
