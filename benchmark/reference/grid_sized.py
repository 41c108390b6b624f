"""Plain reference of the grid at per-region neighbourhood sizes: TopoWx's
moving-window regression kriging at sampled cells, each variable at its own
(k, ka), as ``reference/grid.py`` computes it at one size.

For a cell of tile t and each variable v, at the sizes (k_v, ka_v) of t's
region (``sizes``):
* the pool: as in ``reference/grid.py``;
* the normals: the k_v nearest pool stations by great-circle distance, with
  their own bisquare bandwidth (the k_v-th distance), regression and
  kriging system, and the kriging variance of that neighbourhood, so that
  se is the variable's own;
* the gain rows: the ka_v nearest, with their own bandwidth (the ka_v-th
  distance);
* the daily value: the variable's monthly normal plus its gain rows times
  its neighbours' anomalies of the day; then, where both are ok and tmax <
  tmin, both take their mean.
``gap_km``: for each cell the least distance, over the boundaries its two
variables use (the k_v-th and the ka_v-th nearest against the next), from
one to the next; the caller leaves out a cell whose sets float32 distances
do not determine.

Departures from the published method, besides those of ``reference/grid.py``:
* a cell takes the sizes of its tile's dominant region, the port's rule,
  where TopoWx applies each point's own climate division's sizes;
* the sizes are the configuration's fixed table, not the result of a
  cross-validation on this world.
"""

from __future__ import annotations

import numpy as np
import torch

from reference import grid as ref_grid
from reference.precision import Prec


def reference(st: dict, region: dict, cfg: dict, rows, cols, chunks, prec: str, device,
              sizes) -> dict:
    """As ``reference/grid.py::reference``, with ``sizes`` (V, n, 2) the
    (k, ka) of each variable at each of the n cells (``rows``, ``cols``):
    normals, se, ok flags (V, 12, n), per chunk the reconciled dailies
    (V, nt, n), and ``gap_km`` (n,)."""
    P = Prec(prec)
    T = lambda x: P.t(x, device)  # noqa: E731
    tr, tc = cfg["tile_rows"], cfg["tile_cols"]
    R, C = region["elev"].shape
    cs, lon0, lat0 = region["cellsize"], region["lon0"], region["lat0"]
    rows, cols = np.asarray(rows), np.asarray(cols)
    sizes = np.asarray(sizes, np.int64)
    V, n = sizes.shape[:2]
    width = int(sizes.max())

    # pools and the nearest `width` stations of each cell, in order
    idx = np.zeros((n, width), np.int64)
    ref_lat = np.zeros(n)
    gap_km = np.full(n, np.inf)
    pools = {}
    for i, (r, c) in enumerate(zip(rows, cols)):
        t = (r // tr, c // tc)
        if t not in pools:
            r0, c0 = t[0] * tr, t[1] * tc
            pools[t] = ref_grid.tile_pool(st["lon"], st["lat"], r0, c0, min(tr, R - r0),
                                          min(tc, C - c0), lon0, lat0, cs, cfg["margin_km"],
                                          cfg["max_tile_stations"])
        pool = pools[t]
        clon, clat = lon0 + c * cs, lat0 - r * cs
        dp = ref_grid.haversine(T(np.full(len(pool), clon)), T(np.full(len(pool), clat)),
                                T(st["lon"][pool]), T(st["lat"][pool])).cpu().numpy()
        if len(pool) < width:
            raise ValueError(f"a pool of {len(pool)} stations, fewer than {width}")
        order = np.argsort(dp, kind="stable")
        idx[i] = pool[order[:width]]
        for b in np.unique(sizes[:, i]):
            if len(pool) > b:
                gap_km[i] = min(gap_km[i], dp[order[b]] - dp[order[b - 1]])
        ref_lat[i] = st["lat"][pool].mean()
    cells = dict(lon=lon0 + cols * cs, lat=lat0 - rows * cs, elev=region["elev"][rows, cols],
                 tdi=region["tdi"][rows, cols], lst=region["lst"][:, rows, cols].T)

    # each variable's normals, variance, ok and gain rows, one batch a size pair
    dt = P.dtype
    normal = torch.zeros((V, n, 12), dtype=dt, device=device)
    var = torch.zeros((V, n, 12), dtype=dt, device=device)
    ok = torch.zeros((V, n, 12), dtype=torch.bool, device=device)
    gains = [dict() for _ in range(V)]  # v -> {(k, ka): (cell rows, gain (m, ka))}
    for v in range(V):
        st_v = dict(st, norm=st["norm"][v : v + 1])
        for k, ka in {tuple(s) for s in sizes[v]}:
            sel = np.flatnonzero((sizes[v, :, 0] == k) & (sizes[v, :, 1] == ka))
            sub = {key: a[sel] for key, a in cells.items()}
            kr = ref_grid.krige(P, st_v, sub, idx[sel, :k], ref_lat[sel], cfg, device,
                                min(k, ka))
            gain = kr["gain"] if ka <= k else ref_grid.krige(
                P, st_v, sub, idx[sel, :ka], ref_lat[sel], cfg, device, ka)["gain"]
            at = torch.as_tensor(sel, device=device)
            normal[v, at], var[v, at], ok[v, at] = kr["normal"][0], kr["var"], kr["ok"][0]
            gains[v][(k, ka)] = (sel, gain)

    dailies = []
    for t0, month_idx in chunks:
        nt = len(month_idx)
        m = torch.as_tensor(np.asarray(month_idx), device=device, dtype=torch.long)
        d = normal[:, :, m].clone()                                       # (V, n, nt)
        for v in range(V):
            for (k, ka), (sel, gain) in gains[v].items():
                a = T(st["anoms"][v][idx[sel, :ka], t0 : t0 + nt])         # (m, ka, nt)
                at = torch.as_tensor(sel, device=device)
                d[v, at] += P.einsum("nk,nkt->nt", gain, a)
        okd = ok[:, :, m]
        if V == 2:
            cross = okd[0] & okd[1] & (d[1] < d[0])
            mid = 0.5 * (d[0] + d[1])
            d = torch.stack([torch.where(cross, mid, d[0]), torch.where(cross, mid, d[1])])
        dailies.append(torch.where(okd, d, torch.nan).transpose(1, 2).cpu().double().numpy())
    host = lambda x: x.transpose(1, 2).cpu().double().numpy()  # noqa: E731
    nan = torch.tensor(float("nan"), dtype=dt, device=device)
    return dict(normal=host(torch.where(ok, normal, nan)),
                se=host(torch.where(ok, torch.sqrt(var), nan)),
                ok=ok.transpose(1, 2).cpu().numpy(), daily=dailies, gap_km=gap_km)
