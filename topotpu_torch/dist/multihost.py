"""Process identity of a production job (the port's own copy of
``topotpu.dist.multihost.MultihostContext``).

Tiles are partitioned statically by ``tile_id % process_count``, and each
process keeps its own manifest file, so a process writes only files that no
other process writes. The port runs one process on one GPU; the rest of the
JAX module (``init_multihost``, ``partition_tiles``, ``merge_manifests``,
``barrier``) comes with several GPUs.
"""

from __future__ import annotations

import dataclasses


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
