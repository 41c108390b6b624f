"""Cell-sharded tile step over a device mesh (the port of ``topotpu.dist.mesh``).

The JAX module runs the tile step as one ``shard_map`` program over the local
chips: a tile's cells are split over the ``cells`` axis, the station pool is
replicated on every device, and the only collectives are the dynamic pack
scales' ``pmin`` / ``pmax``. Here a mesh (``CellMesh``) is a list of devices in
one process, one shard each, and a sharded fn runs the port's single-device
step once a shard on the shard's device, all from one thread. Launches to
several devices from one thread are asynchronous, so the shards' work overlaps
and the fn waits on nothing. A device may stand in the list more than once:
two shards on one card run the split path there, and on the CPU every shard is
the CPU.

The dynamic pack scales need the whole tile's min and max before any value is
quantised, so those fns run in two phases: every shard's float step and its
local ranges (``interp.point.flat_ranges``); the reduction (``_pmin_pmax``:
over the shards' scalars on the first device, then one ``all_reduce`` over
the mesh's process group where the mesh spans processes); then every shard
quantised on the global ranges. The fixed lattice (the engine's direct mode)
reduces nothing.

A fn returns what the single-device step returns, the cells in order, on the
mesh's first device. On a mesh that spans processes
(``dist.multihost.global_mesh``) the cells split process-major, then by local
device; each process returns its own columns and the global scales, as a JAX
process addresses only its own shards of a global array. No device data
crosses processes, only the scales' four bytes a plane.
"""

from __future__ import annotations

import dataclasses
import functools

import torch
import torch.distributed as dist

from topotpu_torch.core.config import InterpParams
from topotpu_torch.core.device import platform_devices
from topotpu_torch.interp.point import (
    FlatTileResult,
    PairTileInputs,
    TileInputs,
    TileResult,
    VarFields,
    _flatten_result,
    _plane_range,
    _quantize_plane,
    flat_ranges,
    interp_tile,
    interp_tile_flat,
    interp_tile_pair_flat,
    pair_flatten,
    reconciled_pair,
)

CELL_AXIS = "cells"

# TileInputs fields whose leading axis is the cell batch (split); all other
# fields are station-pool arrays (replicated).
_CELL_FIELDS = ("cell_lon", "cell_lat", "cell_elev", "cell_tdi", "cell_lst", "cell_mask")


@dataclasses.dataclass(frozen=True)
class CellMesh:
    """This process's devices along the one ``cells`` axis, one shard each,
    and the process group the mesh spans (None: this process alone). Every
    process of a group lists as many devices."""

    devices: tuple
    group: object = None

    axis_names = (CELL_AXIS,)

    @property
    def process_count(self) -> int:
        return 1 if self.group is None else dist.get_world_size(self.group)

    @property
    def process_index(self) -> int:
        return 0 if self.group is None else dist.get_rank(self.group)

    @property
    def size(self) -> int:
        """Shards over the whole job."""
        return len(self.devices) * self.process_count

    def shard_slices(self, n_cells: int) -> list:
        """The cell ranges of this process's shards: process-major, then by
        local device. ``n_cells`` must divide by the mesh's size."""
        if n_cells % self.size:
            raise ValueError(f"{n_cells} cells do not split over a mesh of {self.size} shards")
        per = n_cells // self.size
        first = self.process_index * len(self.devices)
        return [slice((first + j) * per, (first + j + 1) * per) for j in range(len(self.devices))]


def make_mesh(n_devices: int = 0, devices=None) -> CellMesh:
    """1-D mesh over ``devices`` (default: the platform's, ``core.device``:
    every visible CUDA device, or the CPU under ``TOPOTPU_PLATFORM=cpu``),
    the first ``n_devices`` of them where given."""
    devices = list(platform_devices() if devices is None else devices)
    if n_devices:
        devices = devices[:n_devices]
    if not devices:
        raise ValueError("a mesh needs at least one device")
    return CellMesh(tuple(_indexed(torch.device(d)) for d in devices))


def _indexed(dev: torch.device) -> torch.device:
    """A CUDA device with its index, as its tensors report it."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def tile_input_specs() -> TileInputs:
    """Per TileInputs field: ``CELL_AXIS`` (split over the shards) or None
    (replicated on every shard's device)."""
    return TileInputs(**{f: CELL_AXIS if f in _CELL_FIELDS else None for f in TileInputs._fields})


def pair_input_specs() -> PairTileInputs:
    """PairTileInputs' specs: var A's TileInputs as usual; var B's station
    fields replicated like every other station-pool array."""
    return PairTileInputs(geom=tile_input_specs(), b=VarFields(norm=None, vario=None, anoms=None))


def _result_specs() -> TileResult:
    """The cell axis of each TileResult field (None: a scalar every shard
    holds alike)."""
    return TileResult(normal=1, se=1, ok=1, daily=1, vario=1, daily_scale=None,
                      daily_offset=None)


_FLAT_SPECS = FlatTileResult(buf=1, scales=None)


def _place(tree, specs, cells: slice, dev: torch.device):
    """One shard of a NamedTuple of tensors: split fields cut to ``cells``,
    the rest whole, all on ``dev`` (views where they already lie there)."""
    if isinstance(tree, tuple):
        return type(tree)(*(_place(v, s, cells, dev) for v, s in zip(tree, specs)))
    return (tree[cells] if specs == CELL_AXIS else tree).to(dev)


def _shard(mesh: CellMesh, tree, specs, n_cells: int) -> tuple:
    return tuple(_place(tree, specs, sl, dev)
                 for sl, dev in zip(mesh.shard_slices(n_cells), mesh.devices))


def shard_tile_inputs(mesh: CellMesh, ti: TileInputs) -> tuple:
    """This process's shards of a tile's inputs, one TileInputs a device:
    its cells, and the station pool whole (``tile_input_specs``). The step
    and the engine both place shards through here."""
    return _shard(mesh, ti, tile_input_specs(), ti.cell_lon.shape[0])


def shard_pair_inputs(mesh: CellMesh, pair: PairTileInputs) -> tuple:
    """This process's shards of a PairTileInputs (``pair_input_specs``)."""
    return _shard(mesh, pair, pair_input_specs(), pair.geom.cell_lon.shape[0])


def _gather(mesh: CellMesh, outs: list, specs):
    """The shards' results as one, the cells in order, on the first device."""
    if len(outs) == 1:
        return outs[0]
    first = mesh.devices[0]
    return type(outs[0])(*(
        None if outs[0][i] is None
        else outs[0][i].to(first) if axis is None
        else torch.cat([o[i].to(first) for o in outs], dim=axis)
        for i, axis in enumerate(specs)
    ))


def _pmin_pmax(mesh: CellMesh, per_shard: list) -> list:
    """Global (min, max) of each plane from every shard's (``per_shard``: a
    list of (min, max) 0-d tensors a shard), on the first device: the
    ``pmin`` / ``pmax`` of the JAX step. Nothing to reduce on one shard of one
    process. ``_pmin_pmax.calls`` counts the reductions made."""
    if len(per_shard) == 1 and mesh.group is None:
        return per_shard[0]
    _pmin_pmax.calls += 1
    first = mesh.devices[0]
    mins = torch.stack([torch.stack([mn.to(first) for mn, _ in s]) for s in per_shard]).amin(0)
    maxs = torch.stack([torch.stack([mx.to(first) for _, mx in s]) for s in per_shard]).amax(0)
    if mesh.group is not None:
        # one MIN over (min, -max): negation is exact
        both = torch.stack([mins, -maxs]).cpu()
        dist.all_reduce(both, op=dist.ReduceOp.MIN, group=mesh.group)
        both = both.to(first)
        mins, maxs = both[0], -both[1]
    return [(mins[i], maxs[i]) for i in range(mins.shape[0])]


_pmin_pmax.calls = 0


def _to(x, dev):
    """A replicated argument on a shard's device: a tensor moved there (no
    copy where it lies there), a host array as it is (the step checks and
    uploads it)."""
    return x.to(dev) if isinstance(x, torch.Tensor) else x


def _on(ranges, dev) -> list:
    return [(mn.to(dev), mx.to(dev)) for mn, mx in ranges]


def _check(mesh: CellMesh, shards) -> None:
    if not isinstance(shards, tuple) or len(shards) != len(mesh.devices):
        raise ValueError(f"a sharded fn takes the {len(mesh.devices)} shards that "
                         "shard_tile_inputs / shard_pair_inputs make for its mesh")


def _fixed_fn(mesh: CellMesh, step):
    """``fn(shards, slot_of_day, fixed_scales)``: ``step`` on every shard on
    the caller's lattice, the products gathered; nothing is reduced."""

    def fn(shards, slot_of_day, fixed_scales):
        _check(mesh, shards)
        return _gather(mesh, [step(s, _to(slot_of_day, d), _to(fixed_scales, d))
                              for s, d in zip(shards, mesh.devices)], _FLAT_SPECS)

    return fn


def sharded_interp_tile(
    mesh: CellMesh, params: InterpParams, shared_validity: bool = False,
    pack_daily: bool = False,
):
    """The tile step over ``mesh``: ``fn(shards) -> TileResult`` with
    ``shards = shard_tile_inputs(mesh, ti)``. ``pack_daily``: the dailies
    int16 on one scale/offset over the whole tile (the reduced range)."""

    def fn(shards):
        _check(mesh, shards)
        res = [interp_tile(ti, params, shared_validity=shared_validity) for ti in shards]
        if pack_daily:
            rng = _pmin_pmax(mesh, [[_plane_range(r.daily, r.ok[:, :, None])] for r in res])
            packed = []
            for r, dev in zip(res, mesh.devices):
                q, scale, offset = _quantize_plane(r.daily, r.ok[:, :, None], _on(rng, dev)[0])
                packed.append(r._replace(daily=q, daily_scale=scale, daily_offset=offset))
            res = packed
        return _gather(mesh, res, _result_specs())

    return fn


def sharded_interp_tile_flat(
    mesh: CellMesh, params: InterpParams, shared_validity: bool = False,
    fixed: bool = False,
):
    """The production step with the single-buffer int16 output over
    ``mesh``: ``fn(shards, slot_of_day) -> FlatTileResult``, one tile-wide
    scale and offset a plane from the reduced ranges. ``fixed``: the caller's
    run-global lattice, ``fn(shards, slot_of_day, fixed_scales)``, and no
    reduction at all."""
    if fixed:
        return _fixed_fn(mesh, functools.partial(_flat_fixed_adapter, params=params,
                                                 shared_validity=shared_validity))

    def fn(shards, slot_of_day):
        _check(mesh, shards)
        res = [interp_tile(ti, params, shared_validity=shared_validity) for ti in shards]
        ranges = _pmin_pmax(mesh, [flat_ranges(r) for r in res])
        return _gather(mesh, [
            FlatTileResult(*_flatten_result(r, _to(slot_of_day, dev), _on(ranges, dev)))
            for r, dev in zip(res, mesh.devices)
        ], _FLAT_SPECS)

    return fn


def _flat_fixed_adapter(inputs, slot_of_day, fixed_scales, *, params, shared_validity):
    return interp_tile_flat(inputs, slot_of_day, params, shared_validity=shared_validity,
                            fixed_scales=fixed_scales)


def sharded_interp_tile_pair_flat(
    mesh: CellMesh, params: InterpParams, shared_validity: bool = False,
    fixed: bool = False, reconcile: bool = False,
):
    """The production step for both variables over ``mesh``:
    ``fn(pair_shards, slot_of_day) -> FlatTileResult`` with buf
    (2 * (ndays + 24), C) and scales (12,), ``pair_shards =
    shard_pair_inputs(mesh, pair)``. ``fixed``: ``fn(pair_shards,
    slot_of_day, fixed_scales)`` on the caller's (12,) lattice, no
    reduction. ``reconcile``: the daily tmin <= tmax midpoint fix (var A
    must be tmin)."""
    if fixed:
        return _fixed_fn(mesh, functools.partial(_pair_fixed_adapter, params=params,
                                                 shared_validity=shared_validity,
                                                 reconcile=reconcile))

    def fn(shards, slot_of_day):
        _check(mesh, shards)
        res = [reconciled_pair(p, params, shared_validity, reconcile) for p in shards]
        ranges = _pmin_pmax(mesh, [flat_ranges(a) + flat_ranges(b) for a, b in res])
        return _gather(mesh, [pair_flatten(r, _to(slot_of_day, dev), _on(ranges, dev))
                              for r, dev in zip(res, mesh.devices)], _FLAT_SPECS)

    return fn


def _pair_fixed_adapter(pair, slot_of_day, fixed_scales, *, params, shared_validity,
                        reconcile):
    return interp_tile_pair_flat(pair, slot_of_day, params, shared_validity=shared_validity,
                                 fixed_scales=fixed_scales, reconcile=reconcile)
