"""Geometry arenas and growable buffers — the ``tyleri-gpu-utils`` analogs.

The reference suballocates every static mesh out of two global bindless
arena buffers (``BindlessBufferAllocator<Vertex>`` / ``<u32>``, ref:
src/resource/resource_allocator.rs:15-16,31-44) and streams per-frame UI
geometry through host-visible ``VariableLengthBuffer``s (ref:
src/render_scene.rs:20-21,64-107).  Here an arena is a
struct-of-arrays numpy staging area plus a cached device snapshot: writers
fill staging directly (the reference's writer-callback upload pattern, ref:
src/resource/mod.rs:31-58), and the snapshot is re-uploaded lazily on next
use — the MemoryUpdater/staging-copy analog, one async host->HBM transfer
per dirty arena instead of per resource.

Offset bookkeeping is a first-fit free-list (``BlockBasedAllocator`` analog);
a C++ implementation is used when the native host library is built, with this
pure-python fallback always available.
"""

from __future__ import annotations

import threading

import numpy as np


class AllocationError(RuntimeError):
    pass


class BlockBasedAllocator:
    """First-fit free-list allocator over an abstract [0, capacity) range."""

    def __init__(self, capacity: int):
        self.capacity = int(capacity)
        self._free = [(0, self.capacity)]  # sorted list of (offset, size)
        self._lock = threading.Lock()

    def allocate(self, size: int) -> int:
        if size <= 0:
            raise AllocationError(f"invalid allocation size {size}")
        with self._lock:
            for i, (off, sz) in enumerate(self._free):
                if sz >= size:
                    if sz == size:
                        self._free.pop(i)
                    else:
                        self._free[i] = (off + size, sz - size)
                    return off
        raise AllocationError(f"arena exhausted: {size} of {self.capacity}")

    def par_allocate(self, sizes, total_hint: int | None = None):
        """Batch allocation (BlockBasedAllocator::par_allocate analog, ref:
        src/resource/mod.rs:152-153): one reservation for the batch."""
        sizes = list(sizes)
        total = total_hint if total_hint is not None else sum(sizes)
        base = self.allocate(max(total, sum(sizes)))
        outs, off = [], base
        for s in sizes:
            outs.append(off)
            off += s
        spare = base + max(total, sum(sizes)) - off
        if spare > 0:
            self.free(off, spare)
        return outs

    def _merge_locked(self) -> None:
        self._free = [b for b in self._free if b[1] > 0]
        self._free.sort()
        merged = []
        for off, sz in self._free:
            if merged and merged[-1][0] + merged[-1][1] == off:
                merged[-1] = (merged[-1][0], merged[-1][1] + sz)
            else:
                merged.append((off, sz))
        self._free = merged

    def free(self, offset: int, size: int) -> None:
        with self._lock:
            self._free.append((offset, size))
            self._merge_locked()

    def grow(self, new_capacity: int) -> None:
        with self._lock:
            if new_capacity <= self.capacity:
                return
            self._free.append((self.capacity, new_capacity - self.capacity))
            self.capacity = new_capacity
            self._merge_locked()


def make_block_allocator(capacity: int):
    """Native C++ allocator when built, python free-list otherwise
    (identical observable behavior, asserted by tests/test_native.py)."""
    try:
        from tyleri_tpu import native

        if native.available():
            return native.NativeBlockAllocator(capacity)
    except Exception:
        pass
    return BlockBasedAllocator(capacity)


class BindlessBuffer:
    """A suballocation handle carrying (offset, len) into an arena
    (the ``BindlessBuffer<T>`` analog consumed at draw time, ref:
    src/render_objects/mesh_renderer.rs:72-78)."""

    def __init__(self, arena: "BindlessBufferAllocator", offset: int, length: int):
        self.arena = arena
        self.offset = int(offset)
        self.len = int(length)
        self._freed = False

    def write(self, writer) -> None:
        self.arena.write(self.offset, self.len, writer)

    def free(self) -> None:
        if not self._freed:
            # _alloc_len covers allocations padded beyond the logical length
            # (e.g. triangle-aligned index buffers)
            self.arena._allocator.free(
                self.offset, getattr(self, "_alloc_len", self.len)
            )
            self._freed = True


class BindlessBufferAllocator:
    """Struct-of-arrays arena with offset suballocation and lazy device upload.

    fields: dict name -> (trailing_shape, dtype). The device snapshot is a
    dict of jnp arrays, refreshed only when staging changed ("one staging
    copy per arena per flush" — the MemoryUpdater batching analog).
    """

    def __init__(self, fields: dict, initial_capacity: int, grow_factor: int = 2,
                 budget_check=None):
        self.fields = dict(fields)
        self.capacity = int(initial_capacity)
        self.grow_factor = grow_factor
        # ``budget_check(total_elements)`` raises MemoryError when a growth
        # would exceed the device budget (ResourcesInfo.check_budget — the
        # try_memory_type analog, ref: src/resource/resource_info.rs:47-58).
        # Checked BEFORE growing so an oversized allocation fails early
        # instead of OOMing mid-frame.
        self._budget_check = budget_check
        self._staging = {
            name: np.zeros((self.capacity, *shape), dtype)
            for name, (shape, dtype) in self.fields.items()
        }
        self._allocator = make_block_allocator(self.capacity)
        self._dirty = True
        self._device = None
        self._lock = threading.Lock()
        # monotonically increasing content version (cache keys downstream)
        self.version = 0

    def _ensure(self, needed_end: int) -> None:
        if needed_end <= self.capacity:
            return
        new_cap = self.capacity
        while new_cap < needed_end:
            new_cap *= self.grow_factor
        if self._budget_check is not None:
            self._budget_check(new_cap)
        for name, arr in self._staging.items():
            grown = np.zeros((new_cap, *arr.shape[1:]), arr.dtype)
            grown[: self.capacity] = arr
            self._staging[name] = grown
        self._allocator.grow(new_cap)
        self.capacity = new_cap
        self._dirty = True

    def allocate(self, items):
        """Batch-allocate [(length, writer), ...] -> [BindlessBuffer, ...].

        The writer-callback pattern of the reference upload API
        (ref: src/resource/mod.rs:31-58): each writer fills its staging
        slice directly; one arena upload covers the whole batch.
        """
        items = list(items)
        total = sum(n for n, _ in items)
        with self._lock:
            try:
                offsets = self._allocator.par_allocate([n for n, _ in items], total)
            except AllocationError:
                self._ensure(self._used_upper_bound() + total)
                offsets = self._allocator.par_allocate([n for n, _ in items], total)
            handles = []
            for (n, writer), off in zip(items, offsets):
                views = tuple(self._staging[name][off : off + n] for name in self.fields)
                writer(*views) if len(views) > 1 else writer(views[0])
                handles.append(BindlessBuffer(self, off, n))
            self._dirty = True
            self.version += 1
            return handles

    def _used_upper_bound(self) -> int:
        return self.capacity

    def write(self, offset: int, length: int, writer) -> None:
        with self._lock:
            views = tuple(self._staging[name][offset : offset + length] for name in self.fields)
            writer(*views) if len(views) > 1 else writer(views[0])
            self._dirty = True
            self.version += 1

    def device_arrays(self) -> dict:
        """Upload-if-dirty and return the HBM snapshot (dict name -> array)."""
        import jax.numpy as jnp

        with self._lock:
            if self._dirty or self._device is None:
                self._device = {
                    name: jnp.asarray(arr) for name, arr in self._staging.items()
                }
                self._dirty = False
            return self._device

    def staging(self, name: str) -> np.ndarray:
        return self._staging[name]


class VariableLengthBuffer:
    """Host-visible growable append buffer (``VariableLengthBuffer`` analog,
    ref: src/render_scene.rs:64-107, src/render_objects/ui.rs:68-74):
    ``expand_to`` reserves, ``write`` appends returning the element offset,
    ``clear`` resets length (capacity is kept)."""

    def __init__(self, trailing_shape, dtype, initial_capacity: int):
        self.trailing_shape = tuple(trailing_shape)
        self.dtype = dtype
        self.capacity = int(initial_capacity)
        self._data = np.zeros((self.capacity, *self.trailing_shape), dtype)
        self.len = 0

    def expand_to(self, n: int) -> None:
        if n <= self.capacity:
            return
        cap = self.capacity
        while cap < n:
            cap *= 2
        grown = np.zeros((cap, *self.trailing_shape), self.dtype)
        grown[: self.len] = self._data[: self.len]
        self._data = grown
        self.capacity = cap

    def write(self, values) -> int:
        values = np.asarray(values, self.dtype).reshape(-1, *self.trailing_shape)
        n = len(values)
        self.expand_to(self.len + n)
        off = self.len
        self._data[off : off + n] = values
        self.len += n
        return off

    def clear(self) -> None:
        self.len = 0

    def data(self) -> np.ndarray:
        return self._data[: self.len]

    def padded(self, capacity: int) -> np.ndarray:
        """Zero-padded snapshot with a static capacity (for jit inputs)."""
        out = np.zeros((capacity, *self.trailing_shape), self.dtype)
        n = min(self.len, capacity)
        out[:n] = self._data[:n]
        return out
