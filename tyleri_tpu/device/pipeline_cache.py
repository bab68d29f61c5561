"""Pipeline cache — persistent compiled-executable cache.

The reference seeds a VkPipelineCache from user-provided bytes and lets the
app persist it across runs (ref: src/render_device/builders.rs:85-88,321-331).
The XLA analog is the persistent compilation cache: every distinct
(PipelineState, RasterPlan) pair compiles to an executable once; with a cache
directory set, later processes skip compilation — the exact role pipeline
cache bytes play for Vulkan.  ``get_data()`` serializes the cache contents to
bytes and ``seed=`` restores them, so an app can do the reference's
"get_pipeline_cache_data -> store -> pipeline_cache_data(bytes) next run"
round trip without sharing a filesystem path.
"""

from __future__ import annotations

import io
import os
import zipfile


# the checkout's own cache directory, used when neither the caller nor
# JAX_COMPILATION_CACHE_DIR names one (a fixed path: the path is part of
# the cache key, so a directory that moves never hits)
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache")


def default_directory() -> str:
    """JAX_COMPILATION_CACHE_DIR when set (then the only cache directory),
    else the checkout's ``.jax_cache``."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_DIR


class PipelineCache:
    def __init__(self, directory: str | None = None,
                 min_compile_seconds: float = 1.0,
                 seed: bytes | None = None):
        # an explicit directory is the caller's choice; otherwise the
        # environment's (a seed unpacks into it) or the checkout's default
        directory = directory or default_directory()
        self.directory = directory
        self.enabled = False
        try:
            from tyleri_tpu.utils.cache_hardening import install

            install()  # atomic cache-entry writes (see module docstring)
        except Exception:
            pass
        try:
            import jax

            os.makedirs(directory, exist_ok=True)
            if seed:
                self._unpack(seed, directory)
            jax.config.update("jax_compilation_cache_dir", directory)
            jax.config.update(
                "jax_persistent_cache_min_compile_time_secs",
                float(min_compile_seconds),
            )
            self.enabled = True
        except Exception:
            # cache is an optimization; never fail device creation on it
            # (the reference has a "TODO check if cache is valid" at
            # builders.rs:321-331 — same fail-open policy)
            self.enabled = False

    @staticmethod
    def _unpack(data: bytes, directory: str) -> None:
        """Restore a get_data() archive. Corrupt seeds are ignored entry by
        entry (fail-open, like a corrupt VkPipelineCache blob); entries that
        would escape the directory are skipped."""
        with zipfile.ZipFile(io.BytesIO(data)) as zf:
            root = os.path.realpath(directory)
            for info in zf.infolist():
                dest = os.path.realpath(os.path.join(directory, info.filename))
                if not dest.startswith(root + os.sep):
                    continue
                if info.is_dir():
                    os.makedirs(dest, exist_ok=True)
                    continue
                os.makedirs(os.path.dirname(dest), exist_ok=True)
                if not os.path.exists(dest):
                    with zf.open(info) as src, open(dest, "wb") as out:
                        out.write(src.read())

    def get_data(self) -> bytes:
        """Serialize the cache contents (every compiled executable) to bytes
        — the vkGetPipelineCacheData analog.  Feed the result to
        ``RenderDeviceBuilder.pipeline_cache_data`` in a later process to
        skip those compiles without sharing a cache directory."""
        if not (self.directory and os.path.isdir(self.directory)):
            return b""
        buf = io.BytesIO()
        with zipfile.ZipFile(buf, "w", zipfile.ZIP_STORED) as zf:
            for base, _dirs, files in os.walk(self.directory):
                for name in files:
                    path = os.path.join(base, name)
                    arc = os.path.relpath(path, self.directory)
                    try:
                        zf.write(path, arc)
                    except OSError:
                        continue  # entry vanished mid-walk (concurrent write)
        return buf.getvalue()
