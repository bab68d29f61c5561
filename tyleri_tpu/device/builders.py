"""RenderDeviceBuilder — fluent device creation
(ref: src/render_device/builders.rs:35-353).

Mirrors the reference's configuration surface and device-selection logic,
mapped to JAX backends:

* instance creation + optional validation layer -> backend init + the
  DebugMessenger validation layer (builders.rs:93-130)
* physical-device pick by explicit id or score — discrete GPU +1000, max 2D
  image dim, geometry-shader required (builders.rs:167-221) -> GPU +1000
  over CPU, tie-broken by memory capacity
* dual queues (present + dedicated transfer, builders.rs:222-286) -> the
  dispatch-queue pool + the upload queue (raises if the pool cannot hold 2
  queues — the reference panics without 2 queues, builders.rs:282)
* default sampler / pipeline-cache seeding / depth format defaults
  (builders.rs:29-33,300-331)
"""

from __future__ import annotations

import enum

from tyleri_tpu.device.debug import DebugMessenger, Severity
from tyleri_tpu.device.pipeline_cache import PipelineCache
from tyleri_tpu.device.render_device import RenderDevice
from tyleri_tpu.pipeline.state import DepthFormat

DEFAULT_APP_NAME = "Tyleri App"        # ref: builders.rs:29
DEFAULT_ENGINE_NAME = "Tyleri Engine"  # ref: builders.rs:30
DEFAULT_DEPTH_FORMAT = DepthFormat.D16_UNORM  # ref: builders.rs:31
PRESENT_QUEUE_PRIORITY = 1.0           # ref: builders.rs:32
TRANSFER_QUEUE_PRIORITY = 0.9          # ref: builders.rs:33


class ValidationLevel(enum.IntEnum):
    NONE = 0
    ERROR = 1
    WARNING = 2
    INFO = 3
    VERBOSE = 4


_SEVERITY_FOR_LEVEL = {
    ValidationLevel.NONE: None,
    ValidationLevel.ERROR: Severity.ERROR,
    ValidationLevel.WARNING: Severity.WARNING,
    ValidationLevel.INFO: Severity.INFO,
    ValidationLevel.VERBOSE: Severity.VERBOSE,
}


class DeviceSelectionError(RuntimeError):
    pass


def device_score(device) -> int:
    """Reference scoring (builders.rs:167-184): discrete GPU +1000 + max 2D
    image dimension, geometry shader mandatory. Here: a GPU gets +1000 over
    the host CPU; memory capacity breaks ties (the image-dim analog)."""
    score = 0
    if device.platform == "gpu":
        score += 1000
    try:
        stats = device.memory_stats()
        if stats and stats.get("bytes_limit"):
            score += min(int(stats["bytes_limit"]) >> 30, 999)
    except Exception:
        pass
    return score


class RenderDeviceBuilder:
    def __init__(self):
        self._app_name = DEFAULT_APP_NAME
        self._engine_name = DEFAULT_ENGINE_NAME
        self._validation = ValidationLevel.NONE
        self._device_id = None
        self._depth_format = DEFAULT_DEPTH_FORMAT
        self._anisotropy = None
        self._pipeline_cache_dir = None
        self._pipeline_cache_seed = None
        self._windows = []
        self._queue_pool_size = 4
        self._debug_callback = None

    # -- fluent config (ref: builders.rs:60-92) --

    def app_name(self, name: str):
        self._app_name = name
        return self

    def engine_name(self, name: str):
        self._engine_name = name
        return self

    def validation_level(self, level: ValidationLevel):
        self._validation = level
        return self

    def debug_callback(self, cb):
        self._debug_callback = cb
        return self

    def device_id(self, device_id: int):
        self._device_id = device_id
        return self

    def depth_format(self, fmt: DepthFormat):
        self._depth_format = fmt
        return self

    def max_sampler_anisotropy(self, value: float):
        self._anisotropy = value
        return self

    def pipeline_cache_data(self, data):
        """Seed the pipeline cache (ref: builders.rs:85-88,321-331).
        Accepts either serialized cache ``bytes`` from a previous device's
        ``pipeline_cache.get_data()`` (the VkPipelineCache Vec<u8>
        semantics — contents are unpacked into a fresh cache directory) or
        a persistent compilation-cache directory path."""
        if isinstance(data, (bytes, bytearray)):
            self._pipeline_cache_seed = bytes(data)
        else:
            self._pipeline_cache_dir = data
        return self

    def present_to(self, window_handle):
        """Register a window the device must be able to present to
        (ref: builders.rs:73-80 window targets).  build() validates every
        registered handle against the picked device (the per-queue-family
        surface-support check, ref: builders.rs:185-221)."""
        self._windows.append(window_handle)
        return self

    @staticmethod
    def _supports_presentation(device, handle) -> bool:
        """Surface-support analog (the reference asks Vulkan per queue
        family x window, builders.rs:185-221).  The device presents by
        device->host copy, so support decomposes into (a) handle validity
        (OS handles must be well-formed ints) and (b) an actual capability
        query: a handle that names an OS window/display needs a windowing
        system on the host to hand the copied pixels to — in a headless
        process (no DISPLAY / WAYLAND_DISPLAY) that surface cannot be
        presented to and the check FAILS, exactly like
        vkGetPhysicalDeviceSurfaceSupportKHR returning false.  Headless
        handles (both fields None) always present (host copy only)."""
        import os

        window = getattr(handle, "window", None)
        display = getattr(handle, "display", None)
        for field in (window, display):
            if field is not None and (not isinstance(field, int) or field < 0):
                return False
        if window is None and display is None:
            return True
        return bool(
            os.environ.get("DISPLAY") or os.environ.get("WAYLAND_DISPLAY")
        )

    def queue_pool_size(self, n: int):
        self._queue_pool_size = n
        return self

    # -- build (ref: builders.rs:332-353) --

    def build(self) -> RenderDevice:
        import jax

        devices = jax.devices()
        if not devices:
            raise DeviceSelectionError("no XLA devices available")

        if self._device_id is not None:
            picked = [d for d in devices if d.id == self._device_id]
            if not picked:
                raise DeviceSelectionError(
                    f"device id {self._device_id} not found among {devices}"
                )
            device = picked[0]
        else:
            device = max(devices, key=device_score)

        # presentation-support check for every registered window
        # (ref: builders.rs:185-221 filters devices per queue family x
        # window and render_window.rs:62-75 re-checks at window creation)
        for handle in self._windows:
            if not self._supports_presentation(device, handle):
                raise DeviceSelectionError(
                    f"device {device} cannot present to window {handle!r}"
                )

        # The reference panics without 2 queues (present + transfer,
        # builders.rs:282); we need at least 1 present queue + the upload
        # queue, so mirror the check on the pool size.
        if self._queue_pool_size < 1:
            raise DeviceSelectionError("queue pool must hold at least 1 queue")

        min_sev = _SEVERITY_FOR_LEVEL[self._validation]
        messenger = DebugMessenger(
            min_severity=min_sev if min_sev is not None else Severity.ERROR,
            callback=self._debug_callback,
        )
        if min_sev is None:
            # validation off: swallow everything below a crash
            messenger.emit = lambda *a, **k: None  # type: ignore[assignment]

        cache = PipelineCache(self._pipeline_cache_dir,
                              seed=self._pipeline_cache_seed)

        return RenderDevice(
            device,
            depth_format=self._depth_format,
            sampler_anisotropy=self._anisotropy,
            pipeline_cache=cache,
            debug_messenger=messenger,
            queue_pool_size=self._queue_pool_size,
        )
