"""Process identity of a production job, and the host side of its
partition (the port's own copy of ``topotpu.dist.multihost``).

Tiles are partitioned statically by ``tile_id % process_count``, and each
process keeps its own manifest file, so a process writes only files that no
other process writes; the mosaic stage unions the manifests. The port runs
one process on one GPU: ``init_multihost`` returns the single-process
context, and a larger job (``torch.distributed`` in place of
``jax.distributed``, with ``local_mesh``, ``barrier`` and the rest of the
JAX module) is not ported yet (ROADMAP.md, Queue 1 item 6).
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Iterable


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
    """This process's context. A (num_processes or 1) == 1 call with no
    coordinator is the single-process job and needs no coordination
    service; anything else raises until several processes are ported."""
    if (num_processes or 1) == 1 and coordinator_address is None:
        return MultihostContext()
    raise ValueError(
        f"a multi-process job (coordinator {coordinator_address!r}, "
        f"{num_processes} processes, id {process_id}) is not ported to "
        "topotpu_torch yet: it comes with torch.distributed (ROADMAP.md, "
        "Queue 1 item 6); run one process"
    )


def partition_tiles(tiles: Iterable, ctx: MultihostContext) -> list:
    """Strided static partition of TileSpecs: tile_id % count == index."""
    return [t for t in tiles if ctx.owns_tile(t.tile_id)]


def merge_manifests(out_dir: str | pathlib.Path) -> dict:
    """Union per-process manifests into the canonical manifest.json
    (coordinator-only, run at mosaic time). Disjoint by construction:
    overlapping tile keys would mean two processes claimed one tile, which
    raises."""
    out_dir = pathlib.Path(out_dir)
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
