"""ParallelGroup — round-robin work partitioner
(ref: src/render_objects/mod.rs:5-30).

The reference uses it to spread draw calls over rayon threads for parallel
command recording.  Here the rasterizer itself is data-parallel, so the
partitioner's production use is spreading draws across *devices* in the
sort-last parallel mode (tyleri_tpu.parallel); the class keeps the exact
reference semantics (cursor cycles over a fixed group count).
"""

from __future__ import annotations


class ParallelGroup:
    def __init__(self, num_groups: int):
        if num_groups <= 0:
            raise ValueError("num_groups must be positive")
        self._groups = [[] for _ in range(num_groups)]
        self._cursor = 0

    @property
    def num_groups(self) -> int:
        return len(self._groups)

    def push(self, item) -> None:
        self._groups[self._cursor].append(item)
        self._cursor = (self._cursor + 1) % len(self._groups)

    def get_group_by_thread(self, i: int):
        if i < 0 or i >= len(self._groups):
            return None
        return self._groups[i]

    def __iter__(self):
        return iter(self._groups)
