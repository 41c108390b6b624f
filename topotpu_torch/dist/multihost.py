"""Several processes in one production job: process identity, the static
partition of tiles, and the local and global meshes (the port of
``topotpu.dist.multihost``).

Tiles are partitioned statically by ``tile_id % process_count``, and each
process keeps its own manifest file and its own mosaic shard, so a process
writes only files that no other process writes; the mosaic stage unions the
manifests and publishes a virtual master over the shards. Within a process,
one engine steps each tile over the process's devices (``dist.mesh``).

``torch.distributed`` takes the place of ``jax.distributed``: a process group
on the ``gloo`` backend, joined at the coordinator's address. It carries only
CPU scalars and barriers (the scales of a mesh that spans processes, the end
of a stage); no device data crosses processes in production, so no GPU
collective library is needed, and the same group forms on machines without a
GPU. A one-process job makes no group at all.

Spans (``utils.profiling``): ``multihost.init`` (the rendezvous, keyed by
the process index), ``multihost.barrier`` (a wait at a sync point of a job
over several processes, keyed by the point's name) and
``multihost.merge_manifests`` (keyed by the directory's name).
"""

from __future__ import annotations

import dataclasses
import datetime
import json
import os
import pathlib
from typing import Iterable

import torch
import torch.distributed as dist

from topotpu_torch.core.device import platform_devices
from topotpu_torch.dist.mesh import CellMesh, make_mesh
from topotpu_torch.utils.profiling import span

# A listening socket that this process inherited, bound to the coordinator's
# port: process 0 serves the rendezvous on it instead of binding the port
# itself, so that a launcher which picked the port keeps it bound until the
# group has formed (no other program can take it in between).
COORDINATOR_FD_ENV = "TOPOTPU_COORDINATOR_FD"
RENDEZVOUS_TIMEOUT = datetime.timedelta(seconds=300)


@dataclasses.dataclass(frozen=True)
class MultihostContext:
    """Process identity for a (possibly single-process) production job."""

    process_index: int = 0
    process_count: int = 1

    @property
    def is_coordinator(self) -> bool:
        return self.process_index == 0

    def owns_tile(self, tile_id: int) -> bool:
        return tile_id % self.process_count == self.process_index

    def manifest_name(self) -> str:
        if self.process_count == 1:
            return "manifest.json"
        return f"manifest_p{self.process_index:03d}.json"


def init_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> MultihostContext:
    """Join the job's process group and return this process's context.

    ``coordinator_address`` is ``host:port``; process 0 serves the rendezvous
    there (on the socket named by ``TOPOTPU_COORDINATOR_FD`` where it
    inherited one), the others connect to it. A (num_processes or 1) == 1
    call with no coordinator is the single-process job and needs no
    coordination service."""
    if (num_processes or 1) == 1 and coordinator_address is None:
        return MultihostContext()
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError(
            "a multi-process job needs --coordinator host:port, --num-processes and "
            f"--process-id (got {coordinator_address!r}, {num_processes}, {process_id})"
        )
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} is not in [0, {num_processes})")
    host, _, port = coordinator_address.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"coordinator address {coordinator_address!r} is not host:port")
    fd = os.environ.get(COORDINATOR_FD_ENV) if process_id == 0 else None
    with span("multihost.init", process_id):
        store = dist.TCPStore(
            host, int(port), num_processes, process_id == 0, RENDEZVOUS_TIMEOUT,
            master_listen_fd=None if fd is None else int(fd),
        )
        dist.init_process_group("gloo", store=store, rank=process_id,
                                world_size=num_processes, timeout=RENDEZVOUS_TIMEOUT)
    return MultihostContext(process_index=dist.get_rank(), process_count=dist.get_world_size())


def _group_size() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def partition_tiles(tiles: Iterable, ctx: MultihostContext) -> list:
    """Strided static partition of TileSpecs: tile_id % count == index."""
    return [t for t in tiles if ctx.owns_tile(t.tile_id)]


def local_devices(process_index: int | None = None,
                  process_count: int | None = None) -> list:
    """This process's share of the devices it sees: that of process
    ``process_index`` of ``process_count``, by default this process's place
    in the process group.

    Every process of a job on one machine sees every GPU of it, so the
    processes split them: the processes that share this machine are counted
    by ``LOCAL_WORLD_SIZE`` / ``LOCAL_RANK`` where the launcher sets them (as
    ``torchrun`` does), and otherwise every process of the job counts as one
    of this machine's (the CLI started N times on one host). With G devices
    and L such processes, local rank r takes devices [r * G / L, (r + 1) * G
    / L); with fewer devices than processes, ranks share, and local rank r
    takes device r % G (on one card every process takes ``cuda:0``). Under
    ``TOPOTPU_PLATFORM=cpu`` the share is the CPU.

    A share of one card becomes the process's current device: CUDA work
    that names no device (a profiler's start, a pinned allocation) then
    lands there, and the process opens no context on another card. Call it
    before any such work."""
    devices = platform_devices()
    if devices[0].type == "cuda":
        world = _group_size() if process_count is None else process_count
        rank = (dist.get_rank() if world > 1 else 0) if process_index is None else process_index
        n_local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        r = int(os.environ.get("LOCAL_RANK", rank % n_local))
        per = len(devices) // n_local
        devices = devices[r * per : (r + 1) * per] if per else [devices[r % len(devices)]]
        if len(devices) == 1:
            torch.cuda.set_device(devices[0])
    return devices


def local_mesh(n_devices: int = 0) -> CellMesh:
    """This process's mesh: its share of the devices it sees
    (``local_devices``, which makes a share of one card current), the first
    ``n_devices`` of them where given. The engine's step reduces nothing
    across processes, so this mesh never spans them."""
    return make_mesh(n_devices, devices=local_devices())


def merge_manifests(out_dir: str | pathlib.Path) -> dict:
    """Union per-process manifests into the canonical manifest.json
    (coordinator-only, run at mosaic time). Disjoint by construction:
    overlapping tile keys would mean two processes claimed one tile, which
    raises."""
    out_dir = pathlib.Path(out_dir)
    with span("multihost.merge_manifests", out_dir.name):
        merged: dict = {"tiles": {}}
        parts = sorted(out_dir.glob("manifest_p*.json"))
        for p in parts:
            part = json.loads(p.read_text())
            overlap = set(part["tiles"]) & set(merged["tiles"])
            if overlap:
                raise RuntimeError(f"tile(s) claimed by two processes: {sorted(overlap)}")
            merged["tiles"].update(part["tiles"])
        if parts:
            tmp = out_dir / "manifest.json.tmp"
            tmp.write_text(json.dumps(merged, indent=0))
            tmp.replace(out_dir / "manifest.json")
        elif (out_dir / "manifest.json").exists():
            merged = json.loads((out_dir / "manifest.json").read_text())
        return merged


def barrier(name: str = "topotpu") -> None:
    """Cross-process sync point (end of a stage). No-op single-process.
    ``name`` labels the point, as in the JAX package, and keys its span; the
    gloo barrier needs none."""
    if _group_size() > 1:
        with span("multihost.barrier", name):
            dist.barrier()


# --- legacy helpers (kept for API stability) --------------------------------


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Deprecated: use init_multihost (returns the process context)."""
    init_multihost(coordinator_address, num_processes, process_id)


def global_mesh() -> CellMesh:
    """One ``cells`` mesh over the whole job: this process's devices
    (``local_mesh``) and the process group, every process with as many
    devices. Not used by the production engine (per process by design, see
    the module docstring); for experiments that want one step across
    processes, whose dynamic scales then go through one ``all_reduce``."""
    mesh = local_mesh()
    if _group_size() == 1:
        return mesh
    n = torch.tensor([len(mesh.devices), -len(mesh.devices)])
    dist.all_reduce(n, op=dist.ReduceOp.MIN)
    if int(n[0]) != -int(n[1]):
        raise ValueError("the processes of the job list different numbers of devices")
    return CellMesh(mesh.devices, dist.group.WORLD)


def is_coordinator() -> bool:
    return _group_size() == 1 or dist.get_rank() == 0
