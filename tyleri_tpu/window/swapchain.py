"""ImageViewSwapchain — the presentation image ring
(ref: src/render_window/swapchain.rs:16-67).

The reference picks surface format [0], image count = min+1 clamped to max,
and mandates FIFO (vsync) presentation.  Here a "swapchain image" is
a slot in a rotating ring of frame results; acquire hands out slot indices
round-robin and the per-slot fence (block at recycle in RenderWindow) gives
the same image-count-deep CPU/device pipelining the reference gets from
frames in flight (ref: render_window.rs:79-115).
"""

from __future__ import annotations

PRESENT_MODE_FIFO = "fifo"  # mandatory in the reference (swapchain.rs:46-51)
PRESENT_MODE_IMMEDIATE = "immediate"  # headless/bench extension (no pacing)


class ImageViewSwapchain:
    def __init__(self, resolution, min_image_count: int = 2, max_image_count: int = 8,
                 present_mode: str = PRESENT_MODE_FIFO):
        w, h = resolution
        if w <= 0 or h <= 0:
            raise ValueError(f"invalid swapchain resolution {resolution}")
        if present_mode not in (PRESENT_MODE_FIFO, PRESENT_MODE_IMMEDIATE):
            # the reference panics when FIFO is unsupported (swapchain.rs:51)
            raise ValueError(f"unsupported present mode {present_mode!r}")
        self.resolution = (int(w), int(h))
        # min + 1, clamped (ref: swapchain.rs:24-31)
        self.image_count = max(1, min(min_image_count + 1, max_image_count))
        self.present_mode = present_mode
        self._next = 0

    @property
    def last_acquired_image(self) -> int:
        """Index handed out by the most recent acquire (presentation order)."""
        return (self._next - 1 + self.image_count) % self.image_count

    def acquire_next_image(self) -> int:
        """Round-robin slot handout (the acquire-next-image analog; the
        frame ring in RenderWindow enforces the fence wait)."""
        idx = self._next
        self._next = (self._next + 1) % self.image_count
        return idx
