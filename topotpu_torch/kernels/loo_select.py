"""Leave-one-out k-nearest-station selection: the kernel's wrapper and its plain version.

``loo_select(xyz, valid, k)`` ranks, for every month m of ``valid`` and every
station q of the pool as the query, the other stations valid in month m by
the cosine score of their unit vectors, and keeps the best k: the cosine
branch of ``geo.neighbors.select_neighbors`` with the queries the pool itself
and ``exclude_idx = arange(S)``, the leave-one-out neighbourhoods of the x-val
stages and krig-params. The JAX package leaves it to XLA (a matmul, masked
scores and ``lax.top_k`` in ``topotpu.geo.neighbors.select_neighbors``).

On CUDA tensors it launches ``csrc/loo_select.cu`` once for every month of
the call, which never writes the S x S score matrix (before it, the
stations' Morton codes from the same source and one ``torch.sort`` of them
put the pool in a spatial order, which the kernel scans outward from each
query); on CPU tensors it runs
the plain version ``loo_select_ref``, the cosine branch a month at a time,
which is also the kernel's yardstick on the card.
"""

from __future__ import annotations

import ctypes

import torch

from topotpu_torch.kernels import _build

_ORDER_ARGTYPES = (ctypes.c_void_p,) * 2 + (ctypes.c_int, ctypes.c_void_p)
_ARGTYPES = (ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 4 + (ctypes.c_void_p,)
MAX_K = 128     # the kernel keeps at most this many a row
MAX_MONTHS = 32  # the months' validity bits share one 32-bit word a station


def loo_select_ref(xyz: torch.Tensor, valid: torch.Tensor, k: int):
    """Plain version: the score matrix ``xyz @ xyz.T`` with the query itself
    at -inf; per month the invalid stations at -inf too, padded with -inf
    columns to k, then ``torch.topk`` (sorted); indices past the pool clamped
    to S - 1. Returns score (M, S, k) and idx (M, S, k) int64."""
    S = xyz.shape[0]
    cos = (xyz @ xyz.T).fill_diagonal_(float("-inf"))
    pad = max(0, k - S)
    scores, idxs = [], []
    for m in range(valid.shape[1]):
        score = cos.masked_fill(~valid[None, :, m], float("-inf"))
        if pad:
            score = torch.nn.functional.pad(score, (0, pad), value=float("-inf"))
        top, idx = torch.topk(score, k, dim=-1, largest=True, sorted=True)
        scores.append(top)
        idxs.append(torch.clamp(idx, max=S - 1))
    return torch.stack(scores), torch.stack(idxs)


def loo_select(xyz: torch.Tensor, valid: torch.Tensor, k: int):
    """The k best-scored other valid stations of every station, every month:
    xyz (S, 3) unit vectors, valid (S, M) bool, 1 <= k <= 128 -> score
    (M, S, k) and idx (M, S, k) int64, sorted by score descending; a slot
    past the month's valid count has score -inf. CUDA inputs (float32, all
    contiguous, M <= 32) launch the hand-written kernel once; CPU inputs take
    the plain version."""
    what = "loo_select"
    if not 1 <= k <= MAX_K:
        raise ValueError(f"{what}: k = {k}, expected 1 <= k <= {MAX_K}")
    dev = _build.common_device(what, xyz, valid)
    if dev.type == "cpu":
        return loo_select_ref(xyz, valid, k)
    if valid.dim() != 2 or not 1 <= valid.shape[1] <= MAX_MONTHS:
        raise ValueError(f"{what}: valid has shape {tuple(valid.shape)}, expected (S, M) "
                         f"with 1 <= M <= {MAX_MONTHS}")
    S, M = valid.shape
    _build.require(what, "xyz", xyz, torch.float32, (S, 3))
    _build.require(what, "valid", valid, torch.bool, (S, M))
    code = torch.empty(S, dtype=torch.int64, device=dev)
    table = torch.empty((S, 4), dtype=torch.float32, device=dev)
    score = torch.empty((M, S, k), dtype=torch.float32, device=dev)
    idx = torch.empty((M, S, k), dtype=torch.int64, device=dev)
    order = _build.load("loo_select", "loo_select_order", _ORDER_ARGTYPES)
    fn = _build.load("loo_select", "loo_select_launch", _ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.check(order(xyz.data_ptr(), code.data_ptr(), S, stream), what)
        perm = torch.sort(code, stable=True).indices  # the pool in Morton order
        err = fn(*(t.data_ptr() for t in (xyz, valid, perm, table, score, idx)), S, M, int(k),
                 1 if M == 1 else 4, stream)
    _build.check(err, what)
    loo_select.launches += 1
    return score, idx


loo_select.launches = 0
