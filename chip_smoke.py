#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port, ``topotpu_torch``, once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; each prints one line, and any failure exits non-zero:

1. environment: torch version, the device, and ``nvidia-smi``'s name and
   power limit (a line of its own). No CUDA device: exit non-zero.
2. build: both kernels from ``topotpu_torch/kernels/csrc/*.cu`` with nvcc.
3. kernel vs plain version on the card at production shapes (65,536 cells,
   a 512-station pool, k = 32 and 64; the daily contraction at D = 744 and
   2,976), with the CPU parity tests' tolerances on 99.9 % of values, a cap
   on every value and a float64 run as arbiter (see ``_compare_krig``), and
   CUDA-event times.
4. the paired tile step (``interp_tile_pair_flat``) at the benchmark's size:
   65,536 cells, 512 stations, k = 32, 365 days, both variables, the
   run-global pack lattice and the reconcile. Both kernels' launch counters
   must rise during the run; the decoded int16 product is held against the
   float64 numpy oracle and the world's true normals.
5. the reconcile on the lattice at one 128 x 128 production tile with
   crossing variables: no cell where both are ok may have tmax < tmin.
6. a profiler breakdown of one step, then one JSON line per kernel and, as
   the last line, ``{"ok": true, "device": {...}}``.

It imports nothing of JAX (the shared ``topotpu`` modules it uses, the
configuration, dates, synthetic world and oracle, are numpy only).
"""

import json
import subprocess
import sys
import time

import numpy as np

N_SIDE = 256          # benchmark world: 256 x 256 = 65,536 cells
N_STATIONS = 512
K = 32
NDAYS = 365
ORACLE_CELLS = 256
ORACLE_BUDGET_S = 60.0
HALF_STEP_C = 1.2e-3  # half of the run-global lattice step, 160 C / 65500 / 2


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_environment():
    import torch

    from topotpu_torch.core.device import cuda_device

    dev = cuda_device()  # raises without a CUDA device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {name!r} count {torch.cuda.device_count()}")
    log(smi)
    return dev, name


def phase_build():
    from topotpu_torch.kernels import _build

    t0 = time.perf_counter()
    reports = []
    for name in ("krig_normals", "scatter_daily"):
        path = _build.build(name)
        log_text = path.with_name(path.name + ".log").read_text()
        reports += [ln.strip() for ln in log_text.splitlines()
                    if "registers" in ln or "spill" in ln]
    log(f"[build] nvcc {_build.find_nvcc()} built both kernels in "
        f"{time.perf_counter() - t0:.3f} s")
    for ln in reports:
        log(f"[build] ptxas: {ln}")


def cuda_ms(fn, reps, warmup=2):
    """Mean device milliseconds of ``fn`` over ``reps`` launches (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


ROW_NAMES = ("xyz3k", "dist_t", "mask_t", "covs_t", "cell_t", "norm_t",
             "vario_t", "acovs_t")
ROW_COUNTS = dict(xyz3k=3, dist_t=1, mask_t=1, covs_t=3, norm_t=1, vario_t=3, acovs_t=3)


def _krig_planes(rows64, k, dev):
    """The k-neighbour prefix of the 64-neighbour planes, with holes: the
    last slot of every 7th cell masked and cell 3 left with two valid slots
    (fewer than min_neighbors)."""
    import torch

    C = rows64["dist_t"].shape[1]
    out = {}
    for name in ROW_NAMES:
        a = rows64[name]
        if name in ROW_COUNTS:
            n = ROW_COUNTS[name]
            a = a.reshape(n, 64, C)[:, :k].reshape(n * k, C)
        out[name] = np.array(a)
    out["mask_t"][-1, ::7] = 0.0
    out["mask_t"][2:, 3] = 0.0
    out["dist_t"] *= out["mask_t"]
    return [torch.from_numpy(out[n]).to(dev) for n in ROW_NAMES]


def _compare_krig(got, want, want64, k):
    """Kernel vs its float32 plain version, with a float64 plain run as the
    arbiter. At 65,536 cells a few cells have a nearly collinear trend
    design (lst follows elevation) whose float32 rounding is amplified by
    the squared condition number of the normal equations; there any two
    float32 implementations part by a few 1e-3 C. So: ok flags identical;
    at least 99.9 % of values within the parity tolerance (normal and trend
    rtol 1e-4 atol 1e-3, 2e-3 above k = 32; variance rtol 1e-3 atol 1e-4;
    variogram and gains rtol 1e-4 atol 1e-5); every value within the cap
    (1e-2 C for normal and trend, 1e-3 for variance and gains, 1e-4 for the
    variogram); and the kernel no further from float64 than 2x the plain
    version's distance + the parity atol."""
    got, want, want64 = (t.cpu().numpy().astype(np.float64) for t in (got, want, want64))
    np.testing.assert_array_equal(got[2], want[2], err_msg="ok flags")
    ok = want[2] > 0.5
    atol_n = 2e-3 if k > 32 else 1e-3
    checks = [
        (np.s_[0, ok], 1e-4, atol_n, 1e-2, "normal"),
        (np.s_[3, ok], 1e-4, atol_n, 1e-2, "trend"),
        (np.s_[1, ok], 1e-3, 1e-4, 1e-3, "variance"),
        (np.s_[4:7], 1e-4, 1e-5, 1e-4, "variogram"),
        (np.s_[8:, ok], 1e-4, 1e-5, 1e-3, "gains"),
    ]
    err = 0.0
    for sl, rtol, atol, cap, what in checks:
        g, w, w64 = got[sl], want[sl], want64[sl]
        d = np.abs(g - w)
        inside = float(np.mean(d <= atol + rtol * np.abs(w)))
        if inside < 0.999 or d.max() > cap:
            raise AssertionError(f"{what}: {inside:.5f} within tolerance, max {d.max():.3e}")
        e_kern, e_plain = np.abs(g - w64), np.abs(w - w64)
        if np.any(e_kern > 2 * e_plain + atol + rtol * np.abs(w64)):
            raise AssertionError(f"{what}: kernel further from float64 than the plain "
                                 f"version ({e_kern.max():.3e} vs {e_plain.max():.3e})")
        err = max(err, float(d.max()))
    return err, int((~ok).sum()), float(np.abs(got[0, ok] - want64[0, ok]).max()), \
        float(np.abs(want[0, ok] - want64[0, ok]).max())


def phase_kernels(world, dev):
    import torch

    from topotpu_torch.io.synthetic import krig_rows_from_world
    from topotpu_torch.kernels.krig_normals import krig_normals_fused, krig_normals_fused_ref
    from topotpu_torch.kernels.scatter_daily import scatter_daily, scatter_daily_ref

    C = N_SIDE * N_SIDE
    rows, cols = np.unravel_index(np.arange(C), (N_SIDE, N_SIDE))
    t0 = time.perf_counter()
    rows64 = krig_rows_from_world(world, rows, cols, 64, month=6)
    log(f"[kernels] neighbour planes for {C} cells built on the host in "
        f"{time.perf_counter() - t0:.3f} s")
    report = {}
    for k, weight_kernel in ((32, "bisquare"), (32, "gaussian"), (32, "uniform"),
                             (64, "bisquare")):
        planes = _krig_planes(rows64, k, dev)
        kern = lambda: krig_normals_fused(*planes, weight_kernel=weight_kernel)  # noqa: E731
        plain = lambda: krig_normals_fused_ref(*planes, weight_kernel=weight_kernel)  # noqa: E731
        got = kern()
        torch.cuda.synchronize()
        want64 = krig_normals_fused_ref(*(p.double() for p in planes),
                                        weight_kernel=weight_kernel)
        err, n_not_ok, e64_kern, e64_plain = _compare_krig(got, plain(), want64, k)
        del want64
        ms, plain_ms = cuda_ms(kern, 20), cuda_ms(plain, 3, warmup=1)
        log(f"[kernels] krig_normals C={C} k={k} {weight_kernel}: max_abs_err {err:.3e} "
            f"(normal vs float64: kernel {e64_kern:.3e}, plain {e64_plain:.3e}; "
            f"not-ok cells {n_not_ok}) kernel {ms:.4f} ms plain {plain_ms:.4f} ms")
        if (k, weight_kernel) == (K, "bisquare"):
            report["krig_normals"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)

    rng = np.random.default_rng(1)
    idx = np.ascontiguousarray(rows64["idx"][:, :K].T.astype(np.int32))  # (k, C)
    idx[1, ::3] = idx[0, ::3]  # duplicate indices accumulate
    for D in (744, 2976):
        planes = [
            torch.from_numpy(idx).to(dev),
            torch.from_numpy(rng.normal(size=(K, C)).astype(np.float32)).to(dev),
            torch.from_numpy((rng.uniform(size=(K, C)) > 0.05).astype(np.float32)).to(dev),
            torch.from_numpy(rng.normal(size=(N_STATIONS, D)).astype(np.float32)).to(dev),
        ]
        kern = lambda: scatter_daily(*planes)  # noqa: E731
        plain = lambda: scatter_daily_ref(*planes)  # noqa: E731
        got = kern().cpu().numpy()
        want = plain().cpu().numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5, err_msg=f"scatter D={D}")
        err = float(np.abs(got - want).max())
        ms, plain_ms = cuda_ms(kern, 20), cuda_ms(plain, 3, warmup=1)
        log(f"[kernels] scatter_daily C={C} S={N_STATIONS} k={K} D={D}: max_abs_err "
            f"{err:.3e} kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
            f"(output write {C * D * 4 / ms / 1e6:.1f} GB/s)")
        if D == 744:
            report["scatter_daily"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
    return report


def _pair(ti, norm_add, anom_mul):
    from topotpu_torch.interp.point import PairTileInputs, VarFields

    return PairTileInputs(
        geom=ti,
        b=VarFields(norm=ti.stn_norm + norm_add, vario=ti.stn_vario,
                    anoms=ti.stn_anoms * anom_mul),
    )


def _decode(buf, scales, v):
    """Var v's (daily, normal, se) planes from the flat int16 buffer, float64
    with NaN at sentinels."""
    o = v * (NDAYS + 24)
    sc = scales[6 * v : 6 * v + 6]
    dec = lambda q, s, off: np.where(q == -32768, np.nan, q * float(s) + float(off))  # noqa: E731
    return (dec(buf[o : o + NDAYS], sc[0], sc[1]),
            dec(buf[o + NDAYS : o + NDAYS + 12], sc[2], sc[3]),
            dec(buf[o + NDAYS + 12 : o + NDAYS + 24], sc[4], sc[5]))


def _oracle_check(world, days, rows, cols, picks, daily, normal, se, day_ok=None):
    """Hold decoded var-A values at the cells ``picks`` against the float64
    oracle, in batches until ORACLE_CELLS cells or ORACLE_BUDGET_S seconds."""
    from topotpu.oracle.pipeline import interp_tile_oracle

    vario = np.tile(np.asarray(world.true_vario, np.float64), (world.n_stations, 12, 1))
    t0 = time.perf_counter()
    done = []
    errs = dict(normal=0.0, se=0.0, daily=0.0)
    for b0 in range(0, len(picks), 16):
        if time.perf_counter() - t0 > ORACLE_BUDGET_S:
            break
        sel = picks[b0 : b0 + 16]
        want = interp_tile_oracle(world, list(zip(rows[sel], cols[sel])), K, vario,
                                  days.month_idx)
        np.testing.assert_allclose(normal[:, sel], want["normal"], rtol=1e-4,
                                   atol=2e-2 + HALF_STEP_C, err_msg="normals vs oracle")
        np.testing.assert_allclose(se[:, sel], want["se"], rtol=2e-2,
                                   atol=2e-2 + HALF_STEP_C, err_msg="se vs oracle")
        got_d = daily[:, sel].T
        keep = np.ones_like(got_d, bool) if day_ok is None else day_ok[:, sel].T
        np.testing.assert_allclose(got_d[keep], want["daily"][keep], rtol=1e-3,
                                   atol=5e-2 + HALF_STEP_C, err_msg="dailies vs oracle")
        errs["normal"] = max(errs["normal"], float(np.abs(normal[:, sel] - want["normal"]).max()))
        errs["se"] = max(errs["se"], float(np.abs(se[:, sel] - want["se"]).max()))
        errs["daily"] = max(errs["daily"], float(np.abs(got_d[keep] - want["daily"][keep]).max()))
        done += list(sel)
    return len(done), errs, time.perf_counter() - t0


def phase_slice(world, days, dev):
    import torch

    from topotpu.core.config import InterpParams, TopoConfig
    from topotpu_torch.interp.convert import fixed_scales_from_config
    from topotpu_torch.interp.point import interp_tile_pair_flat
    from topotpu_torch.io.synthetic import tile_inputs_from_world
    from topotpu_torch.kernels.krig_normals import krig_normals_fused
    from topotpu_torch.kernels.scatter_daily import scatter_daily

    C = N_SIDE * N_SIDE
    rows, cols = np.unravel_index(np.arange(C), (N_SIDE, N_SIDE))
    ti, layout = tile_inputs_from_world(world, days.month_idx, rows, cols, dev)
    pair = _pair(ti, 9.0, 0.85)
    params = InterpParams(k_neighbors=K)
    fixed = fixed_scales_from_config(TopoConfig(), 2)
    step = lambda: interp_tile_pair_flat(  # noqa: E731
        pair, layout.slot_of_day, params, shared_validity=True,
        fixed_scales=fixed, reconcile=True,
    )

    krig_normals_fused.launches = 0
    scatter_daily.launches = 0
    out = step()
    torch.cuda.synchronize()
    launches = dict(krig_normals=krig_normals_fused.launches,
                    scatter_daily=scatter_daily.launches)
    if launches["krig_normals"] != 24 or launches["scatter_daily"] < 1:
        raise RuntimeError(f"main path did not run through the kernels: {launches}")

    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)

    buf = out.buf.cpu().numpy()
    assert buf.shape == (2 * (NDAYS + 24), C) and buf.dtype == np.int16
    np.testing.assert_array_equal(out.scales.cpu().numpy(), fixed)
    daily, normal, se = _decode(buf, fixed, 0)
    daily_b, normal_b, _ = _decode(buf, fixed, 1)
    for a in (daily, normal, se, daily_b, normal_b):
        assert np.isfinite(a).all(), "a land cell came out not ok"

    lon, lat = world.grid.cell_lonlat(rows, cols)
    truth = world.true_normal(lon, lat, world.elev[rows, cols], world.tdi[rows, cols],
                              world.lst[6, rows, cols], 7)
    mae = float(np.mean(np.abs(normal[6] - truth)))
    if mae > 0.3:
        raise RuntimeError(f"July normals MAE vs truth {mae:.4f} C > 0.3 C")

    picks = np.random.default_rng(5).choice(C, ORACLE_CELLS, replace=False)
    n, errs, secs = _oracle_check(world, days, rows, cols, picks, daily, normal, se)
    log(f"[slice] interp_tile_pair_flat C={C} S={N_STATIONS} k={K} days={NDAYS} vars=2: "
        f"launches {launches}; step wall {' '.join(f'{w * 1e3:.3f}' for w in walls)} ms "
        f"(after warm-up); {2 * C / min(walls):.1f} var-cells/s; July normals MAE vs "
        f"truth {mae:.4f} C; oracle on {n} cells ({secs:.1f} s): max err normal "
        f"{errs['normal']:.3e} se {errs['se']:.3e} daily {errs['daily']:.3e} C")
    return launches, step


def phase_reconcile(world, days, dev):
    import torch

    from topotpu.core.config import InterpParams, TopoConfig
    from topotpu_torch.interp.convert import fixed_scales_from_config
    from topotpu_torch.interp.point import interp_tile_pair, interp_tile_pair_flat, ungroup_days
    from topotpu_torch.io.synthetic import tile_inputs_from_world

    tile = TopoConfig().tile_rows
    rows, cols = np.unravel_index(np.arange(tile * tile), (tile, tile))
    ti, layout = tile_inputs_from_world(world, days.month_idx, rows, cols, dev)
    pair = _pair(ti, 0.2, 0.5)
    params = InterpParams(k_neighbors=K)
    fixed = fixed_scales_from_config(TopoConfig(), 2)

    res_a, res_b = interp_tile_pair(pair, params, shared_validity=True)
    both = (res_a.ok & res_b.ok)[:, :, None]
    cross = (both & (res_b.daily < res_a.daily)).cpu().numpy()  # (12, C, dpm)
    n_cross = int(cross.sum())
    out = interp_tile_pair_flat(pair, layout.slot_of_day, params, shared_validity=True,
                                fixed_scales=fixed, reconcile=True)
    buf = out.buf.cpu().numpy().astype(np.int32)
    torch.cuda.synchronize()
    raw_a, raw_b = buf[:NDAYS], buf[NDAYS + 24 : 2 * NDAYS + 24]
    ok_both = (raw_a != -32768) & (raw_b != -32768)
    viol = int((ok_both & (raw_b < raw_a)).sum())
    if n_cross == 0:
        raise RuntimeError("the reconcile case produced no crossings")
    if viol:
        raise RuntimeError(f"{viol} cells with tmax < tmin on the lattice after reconcile")

    daily, normal, se = _decode(out.buf.cpu().numpy(), fixed, 0)
    day_ok = ~ungroup_days(cross.transpose(1, 0, 2), layout).T  # (ndays, C)
    picks = np.random.default_rng(6).choice(tile * tile, 64, replace=False)
    n, errs, _ = _oracle_check(world, days, rows, cols, picks, daily, normal, se, day_ok)
    log(f"[reconcile] {tile}x{tile} tile, var B = A + 0.2 C, anomalies x 0.5: "
        f"{n_cross} crossings before reconcile, {viol} lattice violations after; "
        f"oracle on {n} cells (uncrossed days): max err normal {errs['normal']:.3e} "
        f"daily {errs['daily']:.3e} C")


def phase_profile(step):
    import torch
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device-side events only (the aten ops that launched them would count
    # the same time twice); self device time in us
    dev_us = lambda e: getattr(e, "self_device_time_total",  # noqa: E731
                               getattr(e, "self_cuda_time_total", 0))
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and dev_us(e) > 0]
    if not events:
        log("[profile] the profiler recorded no device time")
        return
    total = sum(dev_us(e) for e in events)
    ours = sum(dev_us(e) for e in events
               if "krig_normals_kernel" in e.key or "scatter_daily_kernel" in e.key)
    top = sorted(events, key=lambda e: -dev_us(e))[:8]
    parts = "; ".join(f"{e.key[:48]} {dev_us(e) / 1e3:.3f} ms x{e.count}" for e in top)
    log(f"[profile] one step under the profiler: wall {wall_us / 1e3:.3f} ms, device "
        f"kernels {total / 1e3:.3f} ms ({len(events)} kinds; busy share "
        f"{total / wall_us:.3f}), of which the two port kernels {ours / 1e3:.3f} ms; "
        f"top: {parts}")


def main():
    dev, name = phase_environment()
    from topotpu.core.dates import get_days_metadata
    from topotpu.io.synthetic import make_world

    phase_build()
    world = make_world(np.random.default_rng(0), nrows=N_SIDE, ncols=N_SIDE,
                       n_stations=N_STATIONS, ndays=NDAYS)
    days = get_days_metadata("2015-01-01", "2015-12-31")
    report = phase_kernels(world, dev)
    launches, step = phase_slice(world, days, dev)
    phase_reconcile(world, days, dev)
    phase_profile(step)

    import torch

    sources = dict(
        krig_normals=("topotpu_torch/kernels/csrc/krig_normals.cu",
                      "topotpu/kernels/pallas_krig.py:445"),
        scatter_daily=("topotpu_torch/kernels/csrc/scatter_daily.cu",
                       "topotpu/kernels/pallas_scatter.py:67"),
    )
    kernels = [
        dict(name=k, route="cuda", source=src, replaces=rep, launches=launches[k],
             **report[k])
        for k, (src, rep) in sources.items()
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
    sys.exit(0)
