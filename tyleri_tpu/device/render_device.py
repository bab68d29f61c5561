"""RenderDevice — the central device context (ref: src/render_device.rs:15-23).

Holds the JAX device handle, the memory allocator (geometry + texture
arenas), the pipeline cache, the depth format, the debug messenger, and a
lock-free pool of dispatch queues (the ``SegQueue<ParallelRecordingQueue>``
analog, ref: render_device.rs:19).  The batch upload API
(create_vertices/create_indices/create_textures) mirrors
ref: src/resource/mod.rs:31-136 including the writer-callback pattern.
"""

from __future__ import annotations

import queue
import threading

import numpy as np

from tyleri_tpu.device import debug
from tyleri_tpu.device.debug import DebugMessenger
from tyleri_tpu.device.pipeline_cache import PipelineCache
from tyleri_tpu.pipeline.state import DepthFormat
from tyleri_tpu.resource.allocator import MemoryAllocator


class DispatchQueue:
    """One ordered submission stream (ParallelRecordingQueue analog).

    A real worker thread, not a decorated function call: ``submit`` enqueues
    the closure and returns a SubmitResult future immediately, so the caller
    (the frame loop) overlaps next-frame host work — scene assembly, UI
    packing — with this frame's recording + upload + XLA dispatch.  That is
    the reference's CPU/GPU pipelining split (P2/P3: record on one thread,
    submit on a queue, ref: render_window.rs:157-178): the trace, upload
    and dispatch inside record() must not block the scene thread.

    Submissions on ONE queue execute in order (the Vulkan queue guarantee);
    distinct queues run concurrently."""

    def __init__(self, device):
        self.device = device
        self._work: "queue.SimpleQueue" = queue.SimpleQueue()
        # Workers run jit FIRST COMPILES (record() traces + XLA compiles on
        # this thread).  pthread stacks are FIXED at RLIMIT_STACK (8 MB) —
        # unlike the main thread's growable stack — and LLVM's recursive
        # passes on the full frame program can overflow that, which
        # manifested as full-suite segfaults inside
        # backend_compile_and_load / executable.serialize on worker
        # threads.  Give workers an explicit 64 MB stack.
        old = threading.stack_size()
        try:
            threading.stack_size(64 << 20)
            self._thread = threading.Thread(target=self._run, daemon=True)
            self._thread.start()
        finally:
            threading.stack_size(old)

    def _run(self):
        while True:
            item = self._work.get()
            if item is None:
                return
            fn, args, kwargs, result = item
            try:
                result.set_result(fn(*args, **kwargs))
            except BaseException as e:  # surfaced at .result()
                result.set_exception(e)

    def submit(self, fn, *args, **kwargs):
        """Enqueue; returns a concurrent.futures.Future (SubmitResult)."""
        import concurrent.futures

        result = concurrent.futures.Future()
        self._work.put((fn, args, kwargs, result))
        return result

    def shutdown(self):
        self._work.put(None)


class DispatchQueuePool:
    """Lock-free-style pool of present queues (SegQueue analog)."""

    def __init__(self, device, count: int = 4):
        self._q: "queue.SimpleQueue[DispatchQueue]" = queue.SimpleQueue()
        for _ in range(count):
            self._q.put(DispatchQueue(device))

    def pop(self) -> DispatchQueue:
        return self._q.get()

    def push(self, q: DispatchQueue) -> None:
        self._q.put(q)


class RenderDevice:
    def __init__(
        self,
        device,
        *,
        depth_format: DepthFormat = DepthFormat.D16_UNORM,
        sampler_anisotropy: float | None = None,
        pipeline_cache: PipelineCache | None = None,
        debug_messenger: DebugMessenger | None = None,
        queue_pool_size: int = 4,
    ):
        self.device = device
        self.depth_format = depth_format
        # Single shared sampler: linear, mirrored-repeat, optional anisotropy
        # (ref: builders.rs:300-320).  Anisotropy > 1 engages the
        # footprint-filtered deferred shade (ops/sampling.py
        # sample_anisotropic): N bilinear taps along the pixel footprint's
        # major axis, derivatives from GPU-style 2x2 quad differencing of
        # the interpolated attribute maps.  Exact mode keeps the plain
        # bilinear fragment loop — surfaced through the validation layer.
        self.sampler_anisotropy = sampler_anisotropy
        self.pipeline_cache = pipeline_cache or PipelineCache()
        self.debug_messenger = debug_messenger or DebugMessenger()
        if sampler_anisotropy:
            self.debug_messenger.emit(
                debug.Severity.INFO,
                "sampler-anisotropy",
                f"sampler_anisotropy={sampler_anisotropy}: deferred shade "
                f"samples {max(2, min(int(round(float(sampler_anisotropy))), 16))} "
                "footprint taps per pixel (visibility paths; exact mode "
                "stays bilinear)",
                debug.MessageType.PERFORMANCE,
            )
        self.memory_allocator = MemoryAllocator(device)
        self.present_queues = DispatchQueuePool(device, queue_pool_size)

    # ---- batch upload API (ref: src/resource/mod.rs) ----

    def create_vertices(self, items):
        """items: [(count, writer), ...]; writer(buf) gets an AoS f32
        [count, 5] view (pos xyz + uv) to fill — the reference's
        FnOnce(&mut [Vertex]) writer (ref: resource/mod.rs:31-44).
        Returns [StaticVertices, ...] (arena handles with offset/len)."""
        arena = self.memory_allocator.static_vertices_buffer

        def adapt(writer, n):
            def soa_writer(pos_view, uv_view, nrm_view):
                aos = np.zeros((n, 5), np.float32)
                writer(aos)
                pos_view[:] = aos[:, :3]
                uv_view[:] = aos[:, 3:5]
                nrm_view[:] = 0.0

            return soa_writer

        return self._report_oom(
            "static_vertices",
            lambda: arena.allocate([(n, adapt(w, n)) for n, w in items]),
        )

    def create_lit_vertices(self, items):
        """items: [(count, writer), ...]; writer(buf) gets an AoS f32
        [count, 8] view (pos xyz + normal xyz + uv) to fill — the lit
        extension of the reference layout (api.vertex.LitVertex); required
        by Blinn-Phong shading (BASELINE config 3)."""
        arena = self.memory_allocator.static_vertices_buffer

        def adapt(writer, n):
            def soa_writer(pos_view, uv_view, nrm_view):
                aos = np.zeros((n, 8), np.float32)
                writer(aos)
                pos_view[:] = aos[:, :3]
                nrm_view[:] = aos[:, 3:6]
                uv_view[:] = aos[:, 6:8]

            return soa_writer

        return self._report_oom(
            "static_vertices",
            lambda: arena.allocate([(n, adapt(w, n)) for n, w in items]),
        )

    def create_indices(self, items):
        """items: [(count, writer), ...]; writer(buf) gets a u32 [count]
        view (ref: resource/mod.rs:45-58).

        Allocations are padded to multiples of 3 so every suballocation
        offset stays triangle-aligned — the vertex stage fetches each
        triangle's indices as one row of the [I/3, 3]-viewed arena."""
        arena = self.memory_allocator.static_indices_buffer

        def adapt(writer, n):
            def idx_writer(view):
                writer(view[:n])

            return idx_writer

        padded = [(-(-n // 3) * 3, adapt(w, n)) for n, w in items]
        handles = self._report_oom(
            "static_indices", lambda: arena.allocate(padded)
        )
        for h, (n, _) in zip(handles, items):
            h._alloc_len = h.len
            h.len = n
        return handles

    def create_textures(self, items):
        """items: [((width, height), writer), ...]; writer(buf) gets an
        [h, w, 4] f32 rgba view (the R8G8B8A8_UNORM image analog,
        ref: resource/mod.rs:59-136). Returns [StaticTexture, ...] — the
        per-texture descriptor-set analog is the texture slot id."""
        return self._report_oom(
            "textures",
            lambda: self.memory_allocator.texture_arena.allocate(items),
        )

    def _report_oom(self, resource_class, thunk):
        """Run an allocation; on budget failure report through the debug
        messenger (validation-layer analog) before re-raising — the failure
        surfaces at create time, not as an OOM mid-frame."""
        try:
            return thunk()
        except MemoryError as e:
            from tyleri_tpu.device import debug

            self.debug_messenger.emit(
                debug.Severity.ERROR,
                "memory-budget",
                f"{resource_class}: {e}",
                debug.MessageType.VALIDATION,
            )
            raise
