"""Driver of the infill cells: TopoWx's PPCA infill of the station network
(BASELINE config #3) through ``infill_network``, one call a geographic block
of the network, the blocks in turn.

Set-up: the network from the seed (``benchlib/world.py``: stations, their
normals and daily anomalies), observations missing at random, the blocks
(the network in ``infill_blocks`` strips of equal count by longitude), and a
warm-up: one call on the first ``warmup_stations`` stations of a block, whose
EM batches have the window's shapes. Window: calls until the first call
boundary past ``--seconds``. Check: for ``sample_targets`` targets of each
call, drawn from the seed: the predictor sets, the observed entries, the
filled series and the monthly normals against the plain reference
(``reference/infill.py``) in float64 on the device. The predictor sets are
judged by their float64 scores (each chosen station within ``tie_margin``
of the n-th best: the best scores lie within ~1e-5 of each other, and
float32 and float64 rank them apart), and the reference's EM runs on the
set the program chose.
"""

from __future__ import annotations

import time

import numpy as np

from benchlib import network as netw
from benchlib.runner import Check
from reference import infill as ref_infill


def network(ctx):
    """(lon, lat, obs, months, blocks): the network cut into
    ``infill_blocks`` strips of equal count by longitude."""
    net = netw.network(ctx)
    order = np.argsort(net.st.lon, kind="stable")
    blocks = np.array_split(order, ctx.config["infill_blocks"])
    return net.st.lon, net.st.lat, net.obs, net.months, blocks


def ppca_params(cfg):
    from topotpu_torch.core.config import PPCAParams

    p = cfg["ppca"]
    return PPCAParams(n_components=p["n_components"], n_neighbors=p["n_neighbors"],
                      max_iters=p["max_iters"], tol=p["tol"], batch_size=p["batch_size"])


def setup(ctx):
    import torch

    from topotpu_torch.infill.pipeline import infill_network

    lon, lat, obs, months, blocks = network(ctx)
    params = ppca_params(ctx.config)
    b = blocks[0][: ctx.traffic["warmup_stations"]]
    infill_network(obs[b], months, params, stn_lon=lon[b], stn_lat=lat[b], device=ctx.device)
    if ctx.device.type == "cuda":
        torch.cuda.synchronize()
    return dict(fn=infill_network, params=params, lon=lon, lat=lat, obs=obs, months=months,
                blocks=blocks, calls=[])


def window(ctx, s):
    rng = np.random.default_rng(ctx.seed + 1)
    n_sample = int(ctx.cell["sample_targets"])
    deadline = time.perf_counter() + ctx.seconds
    while True:
        i = len(s["calls"])
        blk = s["blocks"][i % len(s["blocks"])]
        with ctx.rec.span("infill_call", key=i):
            res = s["fn"](s["obs"][blk], s["months"], s["params"], stn_lon=s["lon"][blk],
                          stn_lat=s["lat"][blk], device=ctx.device)
        ctx.rec.counters["targets"] += len(blk)
        ctx.rec.values["em_iters"].extend(res.n_iters.tolist())
        pick = np.sort(rng.choice(len(blk), min(n_sample, len(blk)), replace=False))
        if ctx.options.get("fault") == "answer":  # the tests' planted fault: one imputed
            gap = np.flatnonzero(~res.obs_mask[pick[0]])[0]  # value 0.5 C off
            res.filled[pick[0], gap] += 0.5
        s["calls"].append(dict(block=i % len(s["blocks"]), targets=pick,
                               filled=res.filled[pick].copy(), norms=res.norms[pick].copy(),
                               predictors=res.predictors[pick].copy(),
                               bad_values=int((~np.isfinite(res.filled)).sum())))
        ctx.tracer.boundary()
        if time.perf_counter() >= deadline:
            return


def release(ctx, s):
    import torch

    s.pop("fn")
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    return s


def check(ctx, s):
    p = ctx.config["ppca"]
    lim = ctx.cell["limits"]
    tie = float(ctx.cell["tie_margin"])
    control = bool(ctx.options.get("control"))
    err_f = err_n = 0.0
    changed = faults = failed = 0
    for call in s["calls"]:
        blk, t = s["blocks"][call["block"]], call["targets"]
        obs = s["obs"][blk].astype(np.float64)
        score = ref_infill.scores(obs, s["lon"][blk], s["lat"][blk], t, ctx.device)
        if control:
            chosen = ref_infill.best(score, p["n_neighbors"])
            got = ref_infill.reference(obs, t, chosen, s["months"], p, "tf32", ctx.device)
        else:
            chosen = call["predictors"].astype(np.int64)
            got = dict(filled=call["filled"].astype(np.float64),
                       normals=call["norms"].astype(np.float64))
        want = ref_infill.reference(obs, t, chosen, s["months"], p, "f64", ctx.device)
        faults += ref_infill.selection_faults(score, chosen, t, tie)
        failed += call["bad_values"]
        seen = np.isfinite(obs[t])
        changed += int((got["filled"][seen] != obs[t][seen]).sum())
        err_f = max(err_f, float(np.abs(got["filled"] - want["filled"]).max()))
        err_n = max(err_n, float(np.abs(got["normals"] - want["normals"]).max()))
    checks = [Check("filled_err_C", err_f, lim["filled_err_C"]),
              Check("normal_err_C", err_n, lim["normal_err_C"]),
              Check("observed_changed", changed, 0),
              Check("predictor_faults", faults, 0),
              Check("nonfinite_values", failed, 0)]
    return checks, int(ctx.rec.counters["targets"]), failed
