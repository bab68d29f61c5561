"""Atomic-write hardening for jax's persistent compilation cache.

jax's ``LRUCache.put`` writes cache entries with a plain
``cache_path.write_bytes(val)`` — NOT atomic.  A concurrent reader (another
process sharing the cache directory, e.g. a benchmark run next to a CPU
test run) can observe a torn file, and a process killed mid-write leaves
one behind permanently; deserializing a torn entry crashes in native code
rather than raising.  This module patches ``put`` to write to a temp file in
the same directory and ``os.replace`` it into place (atomic on POSIX), which
makes entries appear fully-written or not at all.

Installed by ``PipelineCache`` (the framework's cache layer) and the test
conftest.  Safe to call repeatedly; fails open if jax internals move.
"""

from __future__ import annotations

import os
import tempfile

_installed = False


def install() -> bool:
    global _installed
    if _installed:
        return True
    try:
        from jax._src import lru_cache as _lru

        orig_put = _lru.LRUCache.put

        def atomic_put(self, key: str, val: bytes) -> None:
            if not key:
                raise ValueError("key cannot be empty")
            cache_path = self.path / f"{key}{_lru._CACHE_SUFFIX}"
            if self.eviction_enabled:
                # eviction bookkeeping needs the lock + atime machinery:
                # delegate to the original under its own locking, accepting
                # its non-atomicity there (eviction is off by default)
                return orig_put(self, key, val)
            if cache_path.exists():
                return
            fd, tmp = tempfile.mkstemp(
                dir=str(self.path), prefix=f".{key}.", suffix=".tmp"
            )
            try:
                with os.fdopen(fd, "wb") as f:
                    f.write(val)
                os.replace(tmp, str(cache_path))
            except BaseException:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                raise

        _lru.LRUCache.put = atomic_put
        _installed = True
        return True
    except Exception:
        return False
