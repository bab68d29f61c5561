"""Resource-class memory info — the ``ResourcesInfo`` analog.

The reference probes Vulkan memory types for five resource classes by
building dummy resources and requiring a 1 GiB heap
(ref: src/resource/resource_info.rs:13-129).  Here the memory spaces are
device memory, host RAM (staging), and the preallocated-arena budgets; this
module reports what is available and which space each resource class uses,
and raises early when a requested arena exceeds budget — the analog of
``try_memory_type`` returning None.
"""

from __future__ import annotations

import dataclasses
import enum


class MemorySpace(enum.Enum):
    HBM = "hbm"           # device-local (DEVICE_LOCAL analog)
    HOST = "host"         # host-visible staging / UI buffers
    HOST_PINNED = "host_pinned"


@dataclasses.dataclass(frozen=True)
class ResourceClassInfo:
    name: str
    space: MemorySpace
    element_bytes: int


# The five resource classes of the reference (resource_info.rs:22-30):
# static vertices/indices (device-local), UI vertices/indices (host-visible),
# textures (device-local sampled).
RESOURCE_CLASSES = {
    "static_vertices": ResourceClassInfo("static_vertices", MemorySpace.HBM, 20),
    "static_indices": ResourceClassInfo("static_indices", MemorySpace.HBM, 4),
    "ui_vertices": ResourceClassInfo("ui_vertices", MemorySpace.HOST, 32),
    "ui_indices": ResourceClassInfo("ui_indices", MemorySpace.HOST, 4),
    "textures": ResourceClassInfo("textures", MemorySpace.HBM, 16),
}

MIN_HEAP_BYTES = 1 << 30  # reference requires a 1 GiB heap (resource_info.rs:47-58)


class ResourcesInfo:
    def __init__(self, device=None):
        self.device = device
        self.classes = dict(RESOURCE_CLASSES)

    def hbm_bytes_limit(self) -> int | None:
        """Device memory budget if the backend reports it (else None)."""
        try:
            stats = self.device.memory_stats()
            if stats and "bytes_limit" in stats:
                return int(stats["bytes_limit"])
        except Exception:
            pass
        return None

    def check_budget(self, name: str, count: int) -> None:
        info = self.classes[name]
        limit = self.hbm_bytes_limit()
        need = info.element_bytes * count
        if info.space == MemorySpace.HBM and limit is not None and need > limit:
            raise MemoryError(
                f"resource class {name}: {need} bytes exceeds device limit {limit}"
            )
