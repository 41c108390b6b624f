"""Daily-anomaly contraction: kernel wrapper and its plain version.

``scatter_daily(idx_t, gains_t, mask_t, Y)`` computes

    out[c, d] = sum_j gains_t[j, c] * mask_t[j, c] * Y[idx_t[j, c], d]

with the signature of ``topotpu.kernels.pallas_scatter.scatter_daily_matmul``.
On CUDA tensors it launches ``csrc/scatter_daily.cu``; on CPU tensors it runs
``scatter_daily_ref``, the gather-and-contract formulation of
``topotpu.interp.anoms.predict_daily_gathered``.
"""

from __future__ import annotations

import ctypes

import torch

from topotpu_torch.kernels import _build

_ARGTYPES = (ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 4 + (ctypes.c_void_p,)

# Cap on the (cells, k, D) gathered block of the plain version, in elements,
# so that it runs at production shapes within a bounded memory.
_REF_BLOCK_ELEMS = 1 << 27


def scatter_daily_ref(
    idx_t: torch.Tensor,    # (k, C) integer station indices
    gains_t: torch.Tensor,  # (k, C) gains
    mask_t: torch.Tensor,   # (k, C) 0/1
    Y: torch.Tensor,        # (S, D) station-day matrix
) -> torch.Tensor:
    """Plain version: gather each neighbourhood's Y rows and contract.
    Cells are processed in blocks so the gathered tensor stays bounded."""
    k, C = idx_t.shape
    D = Y.shape[1]
    g = (gains_t * mask_t).T.to(Y.dtype)   # (C, k)
    idx = idx_t.T.long()                   # (C, k)
    out = torch.empty((C, D), dtype=Y.dtype, device=Y.device)
    step = max(1, _REF_BLOCK_ELEMS // max(1, k * D))
    for c0 in range(0, C, step):
        rows = Y[idx[c0 : c0 + step]]      # (n, k, D)
        out[c0 : c0 + step] = torch.einsum("ck,ckd->cd", g[c0 : c0 + step], rows)
    return out


def scatter_daily(
    idx_t: torch.Tensor,
    gains_t: torch.Tensor,
    mask_t: torch.Tensor,
    Y: torch.Tensor,
) -> torch.Tensor:
    """(C, D) daily anomalies. CUDA inputs launch the hand-written kernel
    (int32 idx, float32 rest, all contiguous); CPU inputs take the plain
    version. Duplicate indices accumulate."""
    what = "scatter_daily"
    dev = _build.common_device(what, idx_t, gains_t, mask_t, Y)
    if dev.type == "cpu":
        return scatter_daily_ref(idx_t, gains_t, mask_t, Y)
    k, C = idx_t.shape
    S, D = Y.shape
    _build.require(what, "idx_t", idx_t, torch.int32, (k, C))
    _build.require(what, "gains_t", gains_t, torch.float32, (k, C))
    _build.require(what, "mask_t", mask_t, torch.float32, (k, C))
    _build.require(what, "Y", Y, torch.float32, (S, D))
    out = torch.empty((C, D), dtype=torch.float32, device=dev)
    fn = _build.load("scatter_daily", "scatter_daily_launch", _ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(
            idx_t.data_ptr(), gains_t.data_ptr(), mask_t.data_ptr(),
            Y.data_ptr(), out.data_ptr(), C, k, S, D,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(err, what)
    scatter_daily.launches += 1
    return out


scatter_daily.launches = 0
