"""Carry the JAX package's state into the port's tensors.

The tile inputs are ``topotpu.interp.point`` TileInputs / PairTileInputs
whose fields are numpy arrays (``np.asarray`` of each JAX field), or any
NamedTuple with the same field names. Float fields become ``dtype`` tensors
(float32 by default), the masks bool tensors, all on ``device``. Station
variogram parameters and the other tile inputs are this system's weights;
``InterpParams`` has the same fields in both packages. The station-side stages take their
numpy station arrays through ``to_tensor`` too.
"""

from __future__ import annotations

import numpy as np
import torch

from topotpu_torch.core.config import TopoConfig
from topotpu_torch.core.device import COMPUTE_DTYPE
from topotpu_torch.interp.point import PairTileInputs, TileInputs, VarFields


def to_tensor(a, device, dtype: torch.dtype = COMPUTE_DTYPE) -> torch.Tensor:
    """An array (numpy, cast on the host, or a tensor) as ``dtype`` on
    ``device``."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=dtype)
    # np.array copies: arrays handed over from JAX are read-only
    return torch.as_tensor(np.array(a)).to(dtype).to(device)


def tile_inputs_from_numpy(ti, device, dtype: torch.dtype = COMPUTE_DTYPE) -> TileInputs:
    """A TileInputs of numpy arrays -> the port's TileInputs on ``device``."""
    return TileInputs(
        **{
            name: to_tensor(getattr(ti, name), device,
                          torch.bool if name in ("cell_mask", "stn_valid") else dtype)
            for name in TileInputs._fields
        }
    )


def pair_inputs_from_numpy(pair, device, dtype: torch.dtype = COMPUTE_DTYPE) -> PairTileInputs:
    """A PairTileInputs of numpy arrays -> the port's PairTileInputs."""
    return PairTileInputs(
        geom=tile_inputs_from_numpy(pair.geom, device, dtype),
        b=VarFields(
            **{name: to_tensor(getattr(pair.b, name), device, dtype)
               for name in VarFields._fields}
        ),
    )


def fixed_scales_from_config(cfg: TopoConfig, n_vars: int = 1) -> np.ndarray:
    """Run-global int16 pack lattice, (6 * n_vars,) float32 of per-plane
    (scale, offset): dailies and normals on [pack_temp_lo, pack_temp_hi], se
    on [0, pack_se_hi]; ``TileEngine._fixed_scales``."""
    d_scale = (cfg.pack_temp_hi - cfg.pack_temp_lo) / 65500.0
    d_off = 0.5 * (cfg.pack_temp_hi + cfg.pack_temp_lo)
    s_scale = cfg.pack_se_hi / 65500.0
    s_off = 0.5 * cfg.pack_se_hi
    one = np.array([d_scale, d_off, d_scale, d_off, s_scale, s_off], np.float32)
    return np.tile(one, n_vars)
