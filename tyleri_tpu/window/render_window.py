"""RenderWindow — owner of one render target's frame loop
(ref: src/render_window.rs).

``render()`` is the per-frame hot loop (ref: render_window.rs:126-218):

  reference                             here
  ---------                             ----------
  steal available RenderScene           take the available scene object
  acquire_next_image (semaphore)        ring-slot index from the swapchain
  rendering_function.record(...)        jitted frame program, async dispatch
  queue submit (pop queue from pool)    DispatchQueue from the device pool
  queue_present                         async device->host copy starts
  recycle previous per-image resources  —
  fence wait on frame N-k               block_until_ready on that slot's
                                        previous frame + finish host copy
  reset CBs / clear render resources    scene.clear(), stats -> validation

Frames-in-flight depth = swapchain image count, exactly the reference's
pipelining scheme (CPU records frame N while the device renders N-1..N-k).

Headless presentation: the presented image lands in ``latest_image`` and/or
a ``present_target`` callback (e.g. a PNG writer) — the lavapipe-headless
analog the BASELINE configs use.
"""

from __future__ import annotations

import functools
import dataclasses
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from tyleri_tpu.rendering.forward import ForwardRenderingFunction
from tyleri_tpu.scene.render_scene import RenderScene
from tyleri_tpu.utils.profiling import FrameProfiler
from tyleri_tpu.window.swapchain import ImageViewSwapchain


@dataclasses.dataclass(frozen=True, eq=True)
class WindowHandle:
    """Hashable window+display handle (ref: src/lib.rs:25-34). ``None``
    fields = headless."""

    window: Optional[int] = None
    display: Optional[int] = None


@functools.partial(jax.jit, static_argnames=("opaque",))
def _quantize_unorm8(color, opaque: bool):
    """Fallback presentation quantize for rendering functions that do not
    fuse it into their frame program (plan.present_u8); semantics in
    forward.quantize_unorm8.  The fused path is preferred: one executable
    launch per frame instead of two."""
    from tyleri_tpu.rendering.forward import quantize_unorm8

    return quantize_unorm8(color, opaque=opaque)


class _UsingResources:
    """Per-swapchain-image in-flight state (ref: render_window.rs:29-43).

    Holds the SubmitResult future of the DispatchQueue submission; the u8
    present image is quantized on-device as soon as recording completes
    (done-callback), so by fence time only the host fetch remains."""

    def __init__(self, frame_future, scene, opaque=True):
        self._future = frame_future  # Future[Frame] from DispatchQueue.submit
        self.scene = scene           # the RenderScene that recorded it
        self._opaque = opaque
        self._u8 = None
        self._u8_lock = __import__("threading").Lock()
        frame_future.add_done_callback(lambda f: self._ensure_u8())

    @property
    def frame(self):
        """The recorded Frame (blocks until the submission ran)."""
        return self._future.result()

    def _ensure_u8(self):
        with self._u8_lock:
            if self._u8 is None and self._future.exception() is None:
                frame = self._future.result()
                u8 = getattr(frame, "color_u8", None)
                self._u8 = u8 if u8 is not None else _quantize_unorm8(
                    frame.color, opaque=self._opaque
                )

    def wait(self, fetch: bool = True):
        """Fence-wait analog (ref: render_window.rs:193): block on the
        submission and return the presented u8 image — the DEVICE array
        unless ``fetch`` (a host copy costs a full device->host transfer;
        the swapchain presents on-device, readback is the exception)."""
        self._future.result()
        self._ensure_u8()
        if fetch:
            return np.asarray(jax.device_get(self._u8))
        return self._u8


class RenderWindow:
    def __init__(
        self,
        render_device,
        window_handle: Optional[WindowHandle] = None,
        *,
        resolution=(800, 600),
        scale_factor: float = 1.0,
        rendering_function=ForwardRenderingFunction,
        present_target: Optional[Callable[[np.ndarray], None]] = None,
        exact: bool = False,
        blend_parity: str = "auto",
        present_mode: str = "fifo",
        refresh_hz: float = 60.0,
        device_mesh=None,
        composite_alpha: str = "opaque",
        present_quantize: str = "auto",
    ):
        from tyleri_tpu.device.builders import RenderDeviceBuilder

        self.render_device = render_device
        self.window_handle = window_handle or WindowHandle()
        # surface-support re-check at window creation
        # (ref: render_window.rs:62-75)
        if not RenderDeviceBuilder._supports_presentation(
            render_device.device, self.window_handle
        ):
            raise ValueError(
                f"device {render_device.device} cannot present to "
                f"{self.window_handle!r}"
            )
        self._scale_factor = float(scale_factor)
        self.swapchain = ImageViewSwapchain(resolution, present_mode=present_mode)
        if composite_alpha not in ("opaque", "inherit"):
            raise ValueError(f"unsupported composite_alpha {composite_alpha!r}")
        self.rendering_function = rendering_function(
            render_device, self.swapchain, exact=exact,
            blend_parity=blend_parity,
        )
        # presentation alpha semantics: "opaque" = the reference's
        # CompositeAlpha::OPAQUE (swapchain.rs:59; display ignores alpha);
        # "inherit" keeps the framebuffer's alpha in the presented image
        # (useful for readback/testing the blend state's alpha channel)
        self.composite_alpha = composite_alpha
        # presentation quantize scheduling:
        #   "deferred" — quantize as its own launch from the done-callback:
        #     it pipelines behind the NEXT frame's execution
        #   "fused" — quantize inside the frame program (ONE launch per
        #     frame): on launch-bound small frames a second launch costs
        #     more than the quantize
        #   "auto" (default) — defer at >= 2^20 framebuffer pixels (1080p
        #     is 2.07M, 800x600 is 0.48M), fuse below.  The crossover was
        #     chosen on the previous accelerator and is to be re-derived on
        #     the GPU (ROADMAP S5)
        if present_quantize not in ("auto", "deferred", "fused"):
            raise ValueError(
                f"unsupported present_quantize {present_quantize!r}")
        self._present_quantize = present_quantize
        self._apply_present_quantize()
        # FIFO (vsync) presentation is mandatory in the reference
        # (swapchain.rs:46-51): pace render() to the refresh clock via the
        # native pacer; "immediate" (headless/bench extension) skips pacing.
        self._pacer = None
        if self.swapchain.present_mode == "fifo":
            from tyleri_tpu import native

            self._pacer = native.FramePacer(refresh_hz)
        # multi-chip: a (draws, tiles) jax.sharding.Mesh routes record()
        # through the shard_mapped frame program (tyleri_tpu.parallel)
        self.device_mesh = device_mesh
        self.present_target = present_target
        # the last presented u8 image: kept as the DEVICE array; the
        # ``latest_image`` property fetches (and caches) the host copy on
        # demand — presentation itself never reads back
        self._latest_u8 = None
        # stats readback costs a host<->device round trip, so the recycle
        # path hands it to one background worker (the Vulkan async-query
        # analog): the render loop never blocks on it, reports stay
        # ordered, and flush() drains before returning
        import concurrent.futures

        self._stats_pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="tyleri-stats"
        )
        self._stats_pending: list = []
        # query-pool batching: recycled frames' stats scalars queue up
        # (device-side refs, free) and ONE worker pass drains the whole
        # queue per host round trip — on a high-latency link N frames
        # coalesce into one fetch instead of serializing N fetches
        self._stats_queue: list = []
        self._stats_lock = __import__("threading").Lock()
        self._stats_inflight = False
        # Rate limit the drain cadence: each drain is one host<->device
        # round trip whose get also WAITS for the youngest queued frame to
        # execute.  Overflow reports are feedback, not per-frame outputs:
        # seconds of latency only delay a capacity growth, so the queue
        # holds ONLY the stat scalars per frame (the frame's big buffers
        # are not retained) and drains fire at most once per second.  The
        # cadence was chosen on the previous accelerator and is to be
        # re-derived on the GPU (ROADMAP S5).
        self._stats_min_interval = 1.0
        self._stats_backlog_max = 256
        self._stats_last_drain = 0.0
        self.frame_index = 0
        # pre-populated scenes: one available + one per in-flight image
        # (the reference pre-signals fences with fresh CBs,
        # render_window.rs:104)
        self._available_scene = RenderScene()
        self._using: dict[int, _UsingResources] = {}
        self.profiler = FrameProfiler()

    # measured crossover for the "auto" quantize policy (see __init__):
    # 800x600 (0.48M px) is launch-bound and wants the fused quantize;
    # 1080p (2.07M px) wants the deferred launch that pipelines behind
    # the next frame
    _QUANTIZE_DEFER_MIN_PX = 1 << 20

    def _effective_present_quantize(self) -> str:
        if self._present_quantize != "auto":
            return self._present_quantize
        w, h = self.swapchain.resolution
        return ("deferred" if w * h >= self._QUANTIZE_DEFER_MIN_PX
                else "fused")

    def _apply_present_quantize(self) -> None:
        """Point the rendering function's plan at the effective quantize
        mode (fused = quantize inside the frame program).  Re-applied on
        resize: the auto policy is resolution-dependent."""
        rf_plan = getattr(self.rendering_function, "plan", None)
        if rf_plan is None or not hasattr(rf_plan, "present_u8"):
            return
        want = (self.composite_alpha
                if self._effective_present_quantize() == "fused" else None)
        if rf_plan.present_u8 != want:
            self.rendering_function.plan = dataclasses.replace(
                rf_plan, present_u8=want
            )

    # -- accessors (ref: render_window.rs:46-54,219-224) --

    @property
    def resolution(self):
        return self.swapchain.resolution

    @property
    def scale_factor(self) -> float:
        return self._scale_factor

    def get_render_scene(self) -> RenderScene:
        return self._available_scene

    @property
    def latest_image(self) -> Optional[np.ndarray]:
        """Host copy of the last presented image (lazy readback: fetched
        from the device on first access, then cached)."""
        if self._latest_u8 is None:
            return None
        if not isinstance(self._latest_u8, np.ndarray):
            self._latest_u8 = np.asarray(jax.device_get(self._latest_u8))
        return self._latest_u8

    def get_swapchain_images(self) -> int:
        return self.swapchain.image_count

    def resize(self, resolution) -> None:
        """Recreate the swapchain at a new resolution.

        The reference has NO out-of-date/resize handling (acquire panics,
        swapchain.rs is recreation-free); real applications need it, so we
        drain in-flight frames (reporting their stats), rebuild the image
        ring with the same present mode, and re-target the rendering
        function (recompiles on the next record, like any plan change)."""
        self.flush()
        self.swapchain = ImageViewSwapchain(
            resolution, present_mode=self.swapchain.present_mode
        )
        self._latest_u8 = None
        rs = getattr(self.rendering_function, "resize", None)
        if rs is not None:
            rs(resolution)
        self._apply_present_quantize()

    # -- the frame hot loop (ref: render_window.rs:126-218) --

    def render(self, render_device=None) -> int:
        device = render_device or self.render_device
        scene = self._available_scene
        self._available_scene = None  # stolen (the MaybeUninit swap analog)
        tri_count = sum(
            sum(m.triangle_count for m in cam.mesh_renderers)
            for cam in scene.render_resources.cameras
        )

        image_index = self.swapchain.acquire_next_image()

        queue = device.present_queues.pop()
        try:
            if self.device_mesh is not None:
                frame = queue.submit(
                    self.rendering_function.record_sharded,
                    device,
                    scene.render_resources,
                    self._scale_factor,
                    self.swapchain.resolution,
                    self.device_mesh,
                )
            else:
                frame = queue.submit(
                    self.rendering_function.record,
                    device,
                    scene.render_resources,
                    self._scale_factor,
                    self.swapchain.resolution,
                )
        finally:
            device.present_queues.push(queue)

        previous = self._using.pop(image_index, None)
        self._using[image_index] = _UsingResources(
            frame, scene, opaque=self.composite_alpha == "opaque"
        )

        if previous is not None:
            # fence wait on the frame previously using this image slot; the
            # host copy is fetched only for a real consumer (present_target)
            img = previous.wait(fetch=self.present_target is not None)
            self._latest_u8 = img
            if self.present_target is not None:
                self.present_target(img)
            # async stats readback (see __init__): the report lands a frame
            # or two later, like a Vulkan query pool
            self._enqueue_frame_stats(device, previous.frame)
            previous.scene.clear()
            self._available_scene = previous.scene
        else:
            self._available_scene = RenderScene()

        if self._pacer is not None:
            # FIFO present: block until the next refresh tick (the
            # queue_present vsync wait, ref: swapchain.rs:46-51)
            self._pacer.wait()

        self.frame_index += 1
        self.profiler.frame(tri_count)
        return image_index

    def _enqueue_frame_stats(self, device, frame) -> None:
        """Queue a recycled frame's stats scalars for background readback.
        At most one drain task is in flight: frames recycled while the
        worker blocks on a fetch pile up device-side and the next pass
        fetches them ALL in one round trip."""
        import time as _time

        row = (frame.bin_overflow, frame.tile_overflow, frame.clip_overflow,
               frame.clip_crossings, frame.bin_demand, frame.entry_demand,
               frame.spill_demand)
        with self._stats_lock:
            self._stats_queue.append(row)
            if self._stats_inflight:
                return
            now = _time.monotonic()
            backlog = len(self._stats_queue)
            if (now - self._stats_last_drain < self._stats_min_interval
                    and backlog < self._stats_backlog_max):
                return  # rate-limited: flush() or a later recycle drains it
            self._stats_inflight = True
            self._stats_last_drain = now
        self._stats_pending = [f for f in self._stats_pending if not f.done()]
        self._stats_pending.append(
            self._stats_pool.submit(self._drain_stats, device)
        )

    @staticmethod
    def _row_ready(row) -> bool:
        return all(
            s is None or not hasattr(s, "is_ready") or s.is_ready()
            for s in row
        )

    def _drain_stats(self, device) -> None:
        rows = []
        try:
            while True:
                with self._stats_lock:
                    # fetch only rows whose frames have EXECUTED: a
                    # device_get on an in-flight frame's scalars parks on
                    # the stream for ~a frame time.  Unready rows stay
                    # queued — overflow feedback tolerates seconds of
                    # latency, and flush() drains everything
                    # unconditionally.
                    rows = [r for r in self._stats_queue
                            if self._row_ready(r)]
                    if rows:
                        pending = [r for r in self._stats_queue
                                   if not self._row_ready(r)]
                        self._stats_queue.clear()
                        self._stats_queue.extend(pending)
                    else:
                        self._stats_inflight = False
                        return
                self._report_stat_rows(device, rows)
                rows = []
        except BaseException:
            # a failed fetch (device error, poisoned frame scalars) must
            # not leave the inflight latch set: later recycles could then
            # never schedule another drain and the queue would grow
            # unboundedly.  The extracted rows go back on the queue so a
            # later drain/flush can retry them (never silently dropped).
            # The exception still propagates into the worker future;
            # flush() surfaces it.
            with self._stats_lock:
                self._stats_queue[:0] = rows
                self._stats_inflight = False
            raise

    def _report_frame_stats(self, device, frame) -> None:
        self._report_frames_stats(device, [frame])

    def _report_frames_stats(self, device, frames) -> None:
        self._report_stat_rows(device, [
            (f.bin_overflow, f.tile_overflow, f.clip_overflow,
             f.clip_crossings, f.bin_demand, f.entry_demand,
             f.spill_demand)
            for f in frames
        ])

    def _report_stat_rows(self, device, rows) -> None:
        """Report completed frames' capacity overflows (never dropped)
        and feed the occupancy-growth loop.  ONE batched device_get for
        the whole batch: each separate fetch pays a full host<->device
        round trip, so a drain of N frames costs one latency, not N."""
        fetched = iter(jax.device_get(
            tuple(s for row in rows for s in row if s is not None)
        ))
        agg = [0, 0, 0, 0, 0, 0, None]
        for row in rows:
            # first 6 fields are scalars; the 7th (per-spill-level demand)
            # is a small i32 vector aggregated elementwise
            bin_of, tile_of, clip_of, clip_x, bin_dem, entry_dem = (
                int(next(fetched)) if s is not None else 0 for s in row[:6]
            )
            spill_dem = None
            if len(row) > 6 and row[6] is not None:
                spill_dem = np.asarray(next(fetched))
            device.debug_messenger.check_overflow("bin-entries", bin_of)
            device.debug_messenger.check_overflow("tile-entries", tile_of)
            device.debug_messenger.check_overflow("clip-splits", clip_of)
            for i, v in enumerate((bin_of, tile_of, clip_of, clip_x,
                                   bin_dem, entry_dem)):
                agg[i] = max(agg[i], v)
            if spill_dem is not None:
                agg[6] = (spill_dem if agg[6] is None
                          else np.maximum(agg[6], spill_dem))
        # occupancy feedback: a reported overflow grows the raster
        # capacities for subsequent frames (recompile, like swapchain
        # recreation); the dense-slot demand drives the adaptive valid_cap
        # shrink.
        # ONE feedback call per drained batch, on the batch MAXIMA: the
        # frames of a batch were (almost always) rendered under the same
        # pre-growth plan, so per-frame calls would compound the doubling
        # once per STALE report (an entry_cap meant to converge at 1.57M
        # once grew to 12.1M this way).
        note = getattr(self.rendering_function, "note_overflow", None)
        if note is not None:
            # the batch covers len(rows) frames: the clean-streak fits
            # count frames, not drain batches (forward.py note_overflow).
            # A user RenderingFunction predating n_frames (the protocol is
            # duck-typed) still gets the positional report.
            try:
                note(*agg, n_frames=len(rows))
            except TypeError:
                note(*agg)

    def flush(self) -> Optional[np.ndarray]:
        """Drain all in-flight frames (the Drop behavior,
        ref: render_window.rs:226-233); returns the last presented image.
        Drained frames still report their capacity overflows."""
        # drain the async stats reports submitted by render() recycles.
        # A failed drain must not abort the flush before the leftover
        # reports and in-flight frames are drained (overflow reports are
        # never silently dropped); its error is re-raised at the end.
        drain_error = None
        for f in self._stats_pending:
            e = f.exception()
            if e is not None and drain_error is None:
                drain_error = e
        self._stats_pending.clear()
        # rate-limited leftovers: stats queued without an in-flight drain
        # task must still be reported (never silently dropped)
        with self._stats_lock:
            leftovers = self._stats_queue[:]
            self._stats_queue.clear()
        if leftovers:
            try:
                self._report_stat_rows(self.render_device, leftovers)
            except BaseException as e:
                if drain_error is None:
                    drain_error = e
        last_idx = self.swapchain.last_acquired_image
        img = None
        drained = []
        for idx, using in list(self._using.items()):
            img_i = using.wait(fetch=idx == last_idx)
            if idx == last_idx:
                img = img_i
            drained.append(using.frame)
            using.scene.clear()
        if drained:
            try:
                self._report_frames_stats(self.render_device, drained)
            except BaseException as e:
                if drain_error is None:
                    drain_error = e
        self._using.clear()
        if img is not None:
            self._latest_u8 = img
            if self.present_target is not None:
                self.present_target(img)
        if drain_error is not None:
            raise drain_error
        return self.latest_image

    # -- automatic in-flight drain (ref Drop impl: render_window.rs:226-233) --

    def __enter__(self) -> "RenderWindow":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.flush()

    def __del__(self):
        try:
            if getattr(self, "_using", None):
                self.flush()
        except Exception:
            pass  # interpreter teardown: never raise from __del__
        try:
            pool = getattr(self, "_stats_pool", None)
            if pool is not None:
                # flush() above already joined the pending drains; release
                # the worker thread so long-running apps that create many
                # windows don't accumulate idle stats threads
                pool.shutdown(wait=False)
        except Exception:
            pass
